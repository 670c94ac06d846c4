// Backward of the train self-attention sublayer (fused_proj_attention.cu with
// dropout): given x [rows, T, H] and the output cotangent g [rows, T, H],
//
//   dqkv [rows, T, 3H]  (compute dtype)    dWo [H, H], dbo [H]  (f32)
//
// Replaces the TPU kernel stlt_tpu/ops/fused_encoder.py::_fused_proj_bwd_kernel
// (_fused_proj_bwd_body), launched by _fused_proj_train_bwd. Step for step as
// that body, per head h:
//
//   recompute q, k, v (rounded to the compute dtype) and the probabilities p;
//   do   = g(cd) @ Wo[hD:(h+1)D, :]^T                       (f32 sums)
//   dp   = (do v^T) * keep * 1/(1-rate),  pv = p * keep * 1/(1-rate)
//   dz   = p * (dp - sum_s p * dp)
//   dq   = dz k * scale,  dk = dz^T q * scale,  dv = pv^T do
//   attn = pv v                      (rounded; the input of dWo below)
//
// and dWo = attn(cd)^T g(cd), dbo = sum g, both f32. The keep bits are hashed
// in place as in the forward kernel, at each row's ORIGINAL index. The three
// remaining products (dx, dWqkv, dbqkv) are plain GEMMs the wrapper leaves to
// torch.matmul, as the JAX package leaves them to XLA.
//
// Under the model axis (inner = Hq, a head base) the same
// launches run on a model rank's N / M heads, q/k/v width Hq = H / M: qkv
// [tokens, 3Hq] over the whole K = H, do = g Wo_m^T [tokens, Hq] from its
// out_proj.weight shard [H, Hq], dWo_m = attn_m^T g [Hq, H], the keep bits
// at the global heads m N / M + n. g is the cotangent of the ranks' summed
// output, the same on every rank, so dbo = sum g is the replicated bias's
// whole gradient on each; dx = dqkv_m Wqkv_m^T (the wrapper's GEMM) is the
// rank's part, summed over the model group by the caller.
//
// Dead rows (rows_live 0) write exact zeros into dqkv and add nothing to dWo
// or dbo: the exact gradient of the forward, whose dead rows are constant
// zeros. Every output has one owner and every sum a fixed order, with no
// atomics, so two launches give the same bits.
//
// bf16 (launch_tc): split at the contract's rounding points onto Hopper's
// tensor cores (sublayer.cuh, tail_gemm.cuh). The TPU kernel keeps a row
// block's qkv in VMEM and carries dWo/dbo across its sequential grid; on this
// card a 64-row wgmma tile and blocks in no order call for the split that
// rows 1 and 3 already take. qkv is rounded after its f32 bias add and attn
// before dWo, so both pass through device memory in bf16 and lose nothing;
// do = g Wo^T is NOT a rounding point of the contract (the f32 sums feed dp
// and dv), so it passes in f32, which is exact. Six launches with rows_live,
// four without, over the live rows packed in order:
//
//   proj_bwd_scan_kernel         the live rows in order, then the dead, and
//                                their count (tail_gemm.cuh's scan);
//   proj_bwd_gather_kernel       the live rows' tokens of x and of g into two
//                                dense bf16 scratches, zeros up to the next
//                                64-row step (the dWo GEMM's depth);
//   proj_bwd_gemm_kernel         two problems in one grid: qkv = round(x_p
//                                Wqkv^T + bqkv) (gemm_tile, Wqkv read in place
//                                from in_proj_weight [3H, H], K-major) and
//                                do = g_p Wo^T in f32 (gemm_f32_tile, Wo read
//                                in place from out_proj.weight [H_out, H_in],
//                                MN-major);
//   proj_bwd_attn_kernel<D, drop> the short-attention backward, SIMT f32: a
//                                block takes one packed row and a group of
//                                heads; a thread owns a (head, query), then a
//                                (head, key): logits, softmax, dp, dz and pv
//                                into shared tiles, dq and attn = round(pv v)
//                                from its query's row, dk and dv from its
//                                key's column; dqkv written at the row's
//                                original tokens, attn over the packed x. A
//                                block past the live count writes its dead
//                                row's dqkv as zeros (no memset);
//   proj_bwd_weight_gemm_kernel  dWo = attn_p^T g_p with the packed rows as
//                                depth (both operands MN-major), [128, 128]
//                                output tiles over a few row splits chosen
//                                from the token count alone; the first tile
//                                row's blocks also sum g's columns for dbo;
//   proj_bwd_finalize_kernel     the splits' partials of dWo and dbo summed in
//                                split order (the f32 path's pass).
//
// Bound on this card: the GEMMs are 2 * tokens * H * (3H + H + H) flops (qkv,
// do, dWo) against ~14 H bytes a token of scratch traffic, far above the
// H100's ~295 flop/byte ridge, so the tensor cores bound them. The attention
// backward reads qkv and do and writes attn at the live tokens and dqkv at
// all, ~18 H bytes a live token, against ~16 T H flops a token on the SIMT
// pipes (exact f32 as the contract): at T = 8 and 17 its bytes' time is the
// larger, but the kernel reaches only 0.16-0.55 of that rate on the card
// (PERF.md, row 4), so neither bound holds it yet.
//
// f32: SIMT on the f32 pipes, so f32 stays true f32.
//
// 1. fused_proj_bwd_kernel: one block per tile of whole rows (floor(32 / T)
//    rows for T <= 32, one row of up to 64 tokens otherwise), looping over
//    the heads (head dim D = 32, 64 or 128 a template argument, H any
//    multiple of 64 up to 1024 a runtime value). Per head it projects q/k/v
//    from the x tile and do from the g tile (32-token chunks), runs the T x T
//    softmax backward, and writes that head's dq/dk/dv slices of dqkv and its
//    slice of the rounded, dropped attention output to a scratch buffer the
//    wrapper allocates. A block with no live row skips all compute.
// 2. proj_bwd_dwo_kernel: dWo = attn^T g and dbo = sum g as a split
//    reduction: one block per 64 x 64 output tile and token chunk writes its
//    partial sum, and proj_bwd_finalize adds the partials in split order.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"
#include "sublayer.cuh"

namespace {

using namespace stlt;
using bf16 = __nv_bfloat16;

// --- f32: SIMT ----------------------------------------------------------------

constexpr int kKT = 16;  // k-slice staged per SIMT step
constexpr int kTO = 64;  // dWo output tile edge
constexpr int kKM = 32;  // tokens per step of the dWo reduction

struct BwdArgs {
  const void* x;
  const void* wqkv;
  const void* bqkv;
  const void* wot;  // Wo^T [H, Hq]: row j holds Wo[:, j]
  const float* bias;
  long long bias_row_stride;
  long long bias_q_stride;
  const void* g;
  const uint8_t* rows_live;
  void* dqkv;
  void* attn;  // scratch [rows * T, Hq]
  int rows;
  int seq;
  int num_heads;
  int rows_per_block;
  float scale;
  RowDropout drop;
  int hidden;  // H: x's and g's width; the q/k/v width is Hq = num_heads * D (H, or H / M)
};

struct Tile {
  int row0, nrows, ntok;
  long long tok0;
};

__device__ __forceinline__ Tile block_tile(const BwdArgs& p) {
  Tile t;
  t.row0 = blockIdx.x * p.rows_per_block;
  t.nrows = min(p.rows_per_block, p.rows - t.row0);
  t.ntok = t.nrows * p.seq;
  t.tok0 = (long long)t.row0 * p.seq;
  return t;
}

__device__ __forceinline__ bool row_live(const BwdArgs& p, int row) {
  return p.rows_live == nullptr || p.rows_live[row];
}

// The T x T backward of head h over the tile's ntok tokens (whole rows), from
// q_s/k_s/v_s [kTK][D] and do_s [kTK][D] in shared memory, with p_s/dp_s
// [kTK][kTK] as scratch. Writes dq/dk/dv of the head into dqkv and the
// dropped attention output into the scratch, zeros for dead rows.
template <int D>
__device__ void head_backward(const BwdArgs& p, const Tile& tl, int h, const float* q_s,
                              const float* k_s, const float* v_s, const float* do_s, float* p_s,
                              float* dp_s) {
  const int tid = threadIdx.x, seq = p.seq, H = p.num_heads * D;
  float* __restrict__ dqkv = static_cast<float*>(p.dqkv);
  float* __restrict__ attn = static_cast<float*>(p.attn);
  const int n = tl.ntok * seq;
  // p = softmax(q k^T * scale + bias); dp = (do v^T) * keep * 1/(1-rate).
  for (int idx = tid; idx < n; idx += kThreads) {
    const int i = idx / seq, s = idx % seq, lr = i / seq, t = i % seq;
    const float* qi = q_s + i * D;
    const float* ks = k_s + (lr * seq + s) * D;
    const float* di = do_s + i * D;
    const float* vs = v_s + (lr * seq + s) * D;
    float dot = 0.f, dpv = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      dot = fmaf(qi[d], ks[d], dot);
      dpv = fmaf(di[d], vs[d], dpv);
    }
    const float b = p.bias[(long long)(tl.row0 + lr) * p.bias_row_stride +
                           (long long)t * p.bias_q_stride + s];
    p_s[i * kTK + s] = dot * p.scale + b;
    if (p.drop.on) dpv *= p.drop.keep_at(p.drop.row_lane(tl.row0 + lr, h), t, s, seq);
    dp_s[i * kTK + s] = dpv;
  }
  __syncthreads();
  // Per query: normalise p, dz = p * (dp - sum p * dp) into dp_s, then p_s
  // becomes pv = p * keep * 1/(1-rate).
  if (tid < tl.ntok) {
    const int lr = tid / seq, t = tid % seq;
    float* pr = p_s + tid * kTK;
    float* dr = dp_s + tid * kTK;
    float m = pr[0];
    for (int s = 1; s < seq; ++s) m = fmaxf(m, pr[s]);
    float sum = 0.f;
    for (int s = 0; s < seq; ++s) {
      const float e = expf(pr[s] - m);
      pr[s] = e;
      sum += e;
    }
    float r = 0.f;
    for (int s = 0; s < seq; ++s) {
      pr[s] = pr[s] / sum;
      r += pr[s] * dr[s];
    }
    const uint32_t dl = p.drop.on ? p.drop.row_lane(tl.row0 + lr, h) : 0u;
    for (int s = 0; s < seq; ++s) {
      dr[s] = pr[s] * (dr[s] - r);
      if (p.drop.on) pr[s] *= p.drop.keep_at(dl, t, s, seq);
    }
  }
  __syncthreads();
  // Token j (query or key of its row), feature d.
  for (int idx = tid; idx < tl.ntok * D; idx += kThreads) {
    const int j = idx / D, d = idx % D, lr = j / seq, base = lr * seq;
    const bool live = row_live(p, tl.row0 + lr);
    float o = 0.f, dq = 0.f, dk = 0.f, dv = 0.f;
    if (live) {
      const float* pj = p_s + j * kTK;   // pv of query j
      const float* zj = dp_s + j * kTK;  // dz of query j
      for (int s = 0; s < seq; ++s) {
        o = fmaf(pj[s], v_s[(base + s) * D + d], o);
        dq = fmaf(zj[s], k_s[(base + s) * D + d], dq);
      }
      const int sj = j - base;  // j as a key: sum over the queries of its row
      for (int t = 0; t < seq; ++t) {
        dk = fmaf(dp_s[(base + t) * kTK + sj], q_s[(base + t) * D + d], dk);
        dv = fmaf(p_s[(base + t) * kTK + sj], do_s[(base + t) * D + d], dv);
      }
      dq *= p.scale;
      dk *= p.scale;
    }
    const long long tok = tl.tok0 + j;
    float* row = dqkv + tok * 3 * H + h * D + d;
    row[0] = dq;
    row[H] = dk;
    row[2 * H] = dv;
    attn[tok * H + h * D + d] = o;
  }
  __syncthreads();
}

// A tile with no live row: zeros for its dqkv and attention-scratch rows.
__device__ __forceinline__ void zero_tile(const BwdArgs& p, const Tile& tl, int H) {
  const long long n3 = (long long)tl.ntok * 3 * H, n1 = (long long)tl.ntok * H;
  float* dq = static_cast<float*>(p.dqkv) + tl.tok0 * 3 * H;
  float* at = static_cast<float*>(p.attn) + tl.tok0 * H;
  for (long long i = threadIdx.x; i < n3; i += kThreads) dq[i] = 0.f;
  for (long long i = threadIdx.x; i < n1; i += kThreads) at[i] = 0.f;
}

// acc[r][j] += A[ty * kRM + r][k] * B[k][tx + 64 * j] over k < K: A is kTM rows
// of a row-major f32 matrix in device memory (row stride K; rows from nrows
// on read as 0); B's ncols columns are the segments of b (column c at
// b.seg[c / b.segw] + c % b.segw, rows b.ld apart), columns from ncols on
// read as 0. Slices of both are staged in shared memory.
struct FSegs {
  const float* seg[3];
  int segw, ld, ncols;
};

template <int NJ>
__device__ __forceinline__ void simt_gemm(float (&acc)[kRM][NJ], const float* A, int nrows, int K,
                                          const FSegs& b, float* a_sl, float* b_sl) {
  const int tid = threadIdx.x, tx = tid & 63, ty = tid >> 6;
  for (int k0 = 0; k0 < K; k0 += kKT) {
    for (int i = tid; i < kTM * kKT; i += kThreads) {
      const int r = i / kKT, kk = i % kKT;
      a_sl[i] = r < nrows ? A[(long long)r * K + k0 + kk] : 0.f;
    }
    for (int i = tid; i < kKT * 64 * NJ; i += kThreads) {
      const int kk = i / (64 * NJ), c = i % (64 * NJ);
      b_sl[i] = c < b.ncols ? b.seg[c / b.segw][(long long)(k0 + kk) * b.ld + c % b.segw] : 0.f;
    }
    __syncthreads();
    tile_fma<kRM, NJ>(acc, a_sl, kKT, ty * kRM, b_sl, 64 * NJ, tx, kKT);
    __syncthreads();
  }
}

template <int D>
__host__ __device__ constexpr int qkv_cols64() {
  return (3 * D + 63) / 64;  // 64-column segments of one head's q/k/v
}

template <int D>
size_t bwd_smem_bytes() {
  return sizeof(float) *
         (size_t)(kTM * kKT + kKT * 64 * qkv_cols64<D>() + 4 * kTK * D + 2 * kTK * kTK);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) fused_proj_bwd_kernel(BwdArgs p) {
  constexpr int kQJ = qkv_cols64<D>(), kDJ = (D + 63) / 64;
  const int H = p.hidden, Hq = p.num_heads * D;
  const float* __restrict__ x = static_cast<const float*>(p.x);
  const float* __restrict__ wqkv = static_cast<const float*>(p.wqkv);
  const float* __restrict__ bqkv = static_cast<const float*>(p.bqkv);
  const float* __restrict__ wot = static_cast<const float*>(p.wot);
  const float* __restrict__ g = static_cast<const float*>(p.g);

  extern __shared__ float smem[];
  float* a_sl = smem;                     // [kTM][kKT]
  float* b_sl = a_sl + kTM * kKT;         // [kKT][64 * kQJ]
  float* q_s = b_sl + kKT * 64 * kQJ;     // [kTK][D]
  float* k_s = q_s + kTK * D;
  float* v_s = k_s + kTK * D;
  float* do_s = v_s + kTK * D;
  float* p_s = do_s + kTK * D;            // [kTK][kTK]
  float* dp_s = p_s + kTK * kTK;          // [kTK][kTK]

  const int tid = threadIdx.x, tx = tid & 63, ty = tid >> 6;
  const Tile tl = block_tile(p);
  if (!block_has_live(p.rows_live, tl.row0, tl.nrows)) {
    zero_tile(p, tl, Hq);
    return;
  }
  const int nchunks = (tl.ntok + kTM - 1) / kTM;

  for (int h = 0; h < p.num_heads; ++h) {
    const FSegs wqkv_head{{wqkv + h * D, wqkv + Hq + h * D, wqkv + 2 * Hq + h * D}, D, 3 * Hq, 3 * D};
    const FSegs wot_head{{wot + h * D, nullptr, nullptr}, D, Hq, D};
    for (int c = 0; c < nchunks; ++c) {
      const int nrows = min(kTM, tl.ntok - kTM * c);
      const long long t0 = tl.tok0 + kTM * c;
      float pq[kRM][kQJ];
#pragma unroll
      for (int r = 0; r < kRM; ++r)
#pragma unroll
        for (int j = 0; j < kQJ; ++j) pq[r][j] = 0.f;
      simt_gemm<kQJ>(pq, x + t0 * H, nrows, H, wqkv_head, a_sl, b_sl);
#pragma unroll
      for (int j = 0; j < kQJ; ++j) {
        const int cc = tx + 64 * j, part = cc / D, d = cc % D;
        if (cc >= 3 * D) continue;
        float* dst = (part == 0 ? q_s : (part == 1 ? k_s : v_s)) + c * kTM * D;
        const float b = bqkv[part * Hq + h * D + d];
#pragma unroll
        for (int r = 0; r < kRM; ++r) dst[(ty * kRM + r) * D + d] = pq[r][j] + b;
      }
      float pd[kRM][kDJ];
#pragma unroll
      for (int r = 0; r < kRM; ++r)
#pragma unroll
        for (int j = 0; j < kDJ; ++j) pd[r][j] = 0.f;
      simt_gemm<kDJ>(pd, g + t0 * H, nrows, H, wot_head, a_sl, b_sl);
#pragma unroll
      for (int j = 0; j < kDJ; ++j) {
        const int d = tx + 64 * j;
        if (d >= D) continue;
#pragma unroll
        for (int r = 0; r < kRM; ++r) do_s[(c * kTM + ty * kRM + r) * D + d] = pd[r][j];
      }
    }
    __syncthreads();
    head_backward<D>(p, tl, h, q_s, k_s, v_s, do_s, p_s, dp_s);
  }
}

// --- dWo = attn^T g, dbo = sum g: split reduction -----------------------------

struct WoArgs {
  const void* attn;
  const void* g;
  const uint8_t* rows_live;
  float* partial;    // [splits, Hq, H]
  float* partial_b;  // [splits, H]
  float* dwo;        // [Hq, H]
  float* dbo;
  long long tokens;
  long long chunk;  // tokens per split, a multiple of kKM
  int seq;
  int hidden;  // H: g's width and dWo's columns
  int splits;
  int inner;   // Hq: attn's width and dWo's rows
};

__device__ __forceinline__ bool token_live(const WoArgs& a, long long m) {
  return a.rows_live == nullptr || a.rows_live[m / a.seq];
}

// Column sums of g over the live tokens of the staged step, for the blocks
// of the first row of tiles: thread k < kTO owns output column k0 + k.
__device__ __forceinline__ void add_bias_sums(const WoArgs& a, const float* g_t, int ld, long long m0,
                                              int nm, float& sum) {
  if (threadIdx.x >= kTO) return;
  for (int m = 0; m < nm; ++m) {
    if (token_live(a, m0 + m)) sum += g_t[m * ld + threadIdx.x];
  }
}

__device__ __forceinline__ void stage_tokens(const WoArgs& a, float* a_t, float* g_t, int ld, int j0,
                                             int k0, long long m0, int nm) {
  const float* attn = static_cast<const float*>(a.attn);
  const float* g = static_cast<const float*>(a.g);
  for (int i = threadIdx.x; i < kKM * kTO; i += kThreads) {
    const int m = i / kTO, c = i % kTO;
    const bool in = m < nm;
    a_t[m * ld + c] = in ? attn[(m0 + m) * a.inner + j0 + c] : 0.f;
    g_t[m * ld + c] = in ? g[(m0 + m) * a.hidden + k0 + c] : 0.f;
  }
}

// f32: each thread owns a 4 x 4 patch of the 64 x 64 tile.
__global__ void __launch_bounds__(kThreads) proj_bwd_dwo_kernel(WoArgs a) {
  __shared__ float a_t[kKM * kTO], g_t[kKM * kTO];
  const int tiles = a.hidden / kTO;  // output tiles of a row of dWo
  const int j0 = (blockIdx.x / tiles) * kTO, k0 = (blockIdx.x % tiles) * kTO;
  const long long m_begin = blockIdx.y * a.chunk;
  const long long m_end = min(a.tokens, m_begin + a.chunk);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};
  float bsum = 0.f;
  for (long long m0 = m_begin; m0 < m_end; m0 += kKM) {
    const int nm = (int)min((long long)kKM, m_end - m0);
    stage_tokens(a, a_t, g_t, kTO, j0, k0, m0, nm);
    __syncthreads();
    for (int m = 0; m < nm; ++m) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float av = a_t[m * kTO + ty * 4 + r];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av, g_t[m * kTO + tx * 4 + c], acc[r][c]);
      }
    }
    if (j0 == 0) add_bias_sums(a, g_t, kTO, m0, nm, bsum);
    __syncthreads();
  }
  float* out = a.partial + (long long)blockIdx.y * a.inner * a.hidden;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) out[(long long)(j0 + ty * 4 + r) * a.hidden + k0 + tx * 4 + c] = acc[r][c];
  if (j0 == 0 && tid < kTO) a.partial_b[(long long)blockIdx.y * a.hidden + k0 + tid] = bsum;
}


// dWo and dbo: the partials summed in split order (f32 and bf16 alike).
__global__ void proj_bwd_finalize_kernel(WoArgs a) {
  const long long hh = (long long)a.inner * a.hidden;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < hh) {
    float s = 0.f;
    for (int k = 0; k < a.splits; ++k) s += a.partial[k * hh + idx];
    a.dwo[idx] = s;
  } else if (idx < hh + a.hidden) {
    const long long c = idx - hh;
    float s = 0.f;
    for (int k = 0; k < a.splits; ++k) s += a.partial_b[k * a.hidden + c];
    a.dbo[c] = s;
  }
}

// --- bf16: wgmma on TMA-fed tiles, split at the rounding points ----------------

using namespace stlt::sublayer;

__global__ void __launch_bounds__(kScanThreads) proj_bwd_scan_kernel(const uint8_t* live, int rows,
                                                                     int* packed, int* count) {
  tail::live_rows_scan<true>(live, rows, packed, count);
}

// Packed token i (< *count * seq) of x and g [rows * seq, H] into xp and gp:
// token rows[i / seq] * seq + i % seq, one a warp in 16-byte vectors; the
// packed tokens from there up to the next 64-row step (and M) zeros, so the
// dWo GEMM's last k step reads no stale row.
__global__ void __launch_bounds__(32 * kRowWarps)
    proj_bwd_gather_kernel(const bf16* x, const bf16* g, bf16* xp, bf16* gp, const int* rows,
                           const int* count, int seq, int H, long long M) {
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  const long long n = (long long)*count * seq;
  uint4* xd = reinterpret_cast<uint4*>(xp + i * H);
  uint4* gd = reinterpret_cast<uint4*>(gp + i * H);
  if (i < n) {
    const long long tok = (long long)rows[i / seq] * seq + i % seq;
    const uint4* xs = reinterpret_cast<const uint4*>(x + tok * H);
    const uint4* gs = reinterpret_cast<const uint4*>(g + tok * H);
    for (int c = lane; c < H / 8; c += 32) {
      xd[c] = xs[c];
      gd[c] = gs[c];
    }
  } else if (i < min(tail::round_up(n, kBK), M)) {
    for (int c = lane; c < H / 8; c += 32) xd[c] = gd[c] = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The two input-side GEMMs in one grid: blocks x < ceil(3H / kBN) take qkv's
// tiles, the others do's.
__global__ void __launch_bounds__(kGemmThreads, 2)
    proj_bwd_gemm_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_wqkv,
                         const __grid_constant__ CUtensorMap map_g, const __grid_constant__ CUtensorMap map_wo,
                         GemmArgs qkv, GemmF32Args dout) {
  const int n1 = (qkv.N + kBN - 1) / kBN;
  if ((int)blockIdx.x < n1) {
    gemm_tile(map_x, map_wqkv, qkv, blockIdx.x * kBN, blockIdx.y * kBM);
  } else {
    gemm_f32_tile(map_g, map_wo, dout, (blockIdx.x - n1) * kBN, blockIdx.y * kBM);
  }
}

// --- the short-attention backward ---------------------------------------------

constexpr int kBwdThreads = 128;
constexpr size_t kBwdSmemTwo = 113 * 1024;  // two blocks an SM
constexpr int kBwdCols = 32;                // output columns a thread sums at once

// Packed row b: tokens b * T + t of qkv [M, 3H] (q, k, v at columns 0, H,
// 2H, head h at h * D of each), of do [M, H] (f32) and of attn [M, H]; rows[b]
// (rows null: b) is its original row, by which the bias, the keep bits and
// dqkv's rows are indexed. With rows, the blocks from *count on own the dead
// rows rows[b] and write their T x 3H dqkv rows as zeros.
struct AttnBwdArgs {
  const bf16* qkv;
  const float* dout;
  bf16* attn;
  bf16* dqkv;
  const float* bias;
  long long bias_row_stride;
  long long bias_q_stride;
  const int* rows;
  const int* count;
  int B, T, H, N;
  int hb;  // heads a block
  float scale;
  RowDropout drop;
};

// q, k, v (bf16, rows padded by 16 bytes), do (f32, rows padded by 16 bytes)
// of hb heads, then pv and dz [hb * T][attn_ldp(T)] f32.
template <int D>
__host__ __device__ inline size_t attn_bwd_smem_bytes(int hb, int T) {
  return (size_t)3 * hb * T * (D + 8) * sizeof(bf16) + (size_t)hb * T * (D + 4) * sizeof(float) +
         (size_t)2 * hb * T * attn_ldp(T) * sizeof(float);
}

// Heads a block: (head, query) pairs to fill its threads once, within the
// shared memory of two blocks an SM where one head allows it.
template <int D>
inline int attn_bwd_heads(int T, int N) {
  int hb = kBwdThreads / T;
  hb = hb < 1 ? 1 : (hb > N ? N : hb);
  while (hb > 1 && attn_bwd_smem_bytes<D>(hb, T) > kBwdSmemTwo) --hb;
  return hb;
}

__device__ __forceinline__ void store_bf16(bf16* dst, const float (&v)[kBwdCols], float scale) {
#pragma unroll
  for (int c = 0; c < kBwdCols; c += 8) {
    uint4 u;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) h2[j] = __floats2bfloat162_rn(v[c + 2 * j] * scale, v[c + 2 * j + 1] * scale);
    *reinterpret_cast<uint4*>(dst + c) = u;
  }
}

template <int D, bool kDrop>
__global__ void __launch_bounds__(kBwdThreads) proj_bwd_attn_kernel(AttnBwdArgs p) {
  constexpr int LDK = D + 8, LDD = D + 4, kVecs = D / 8;
  const int tid = threadIdx.x, b = blockIdx.x, T = p.T, H = p.H;
  const int live_rows = p.count != nullptr ? *p.count : p.B;
  if (b >= live_rows) {
    if (blockIdx.y == 0) {
      uint4* d = reinterpret_cast<uint4*>(p.dqkv + (long long)p.rows[b] * T * 3 * H);
      for (int i = tid; i < T * 3 * H / 8; i += kBwdThreads) d[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  const int orig = p.rows != nullptr ? p.rows[b] : b;
  const int h0 = blockIdx.y * p.hb, nh = min(p.hb, p.N - h0);
  const long long tok0 = (long long)b * T;
  const int LDP = attn_ldp(T);

  extern __shared__ __align__(16) unsigned char bwd_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(bwd_smem);  // [nh][T][LDK]
  bf16* k_s = q_s + p.hb * T * LDK;
  bf16* v_s = k_s + p.hb * T * LDK;
  float* do_s = reinterpret_cast<float*>(v_s + p.hb * T * LDK);  // [nh][T][LDD]
  float* pv_s = do_s + p.hb * T * LDD;  // [nh * T][LDP]: p, then pv
  float* dz_s = pv_s + p.hb * T * LDP;  // [nh * T][LDP]: dp, then dz

  // q, k, v and do of the group's heads (a token's heads are contiguous
  // columns), every 16-byte copy in flight at once.
  const int per_tok = nh * kVecs;
  for (int i = tid; i < 3 * T * per_tok; i += kBwdThreads) {
    const int part = i / (T * per_tok), rest = i % (T * per_tok);
    const int t = rest / per_tok, hl = (rest % per_tok) / kVecs, c = rest % kVecs;
    const bf16* src = p.qkv + (tok0 + t) * 3 * H + part * H + (long long)(h0 + hl) * D + c * 8;
    cp_async16((part == 0 ? q_s : (part == 1 ? k_s : v_s)) + (hl * T + t) * LDK + c * 8, src);
  }
  const int per_tok_f = nh * D / 4;
  for (int i = tid; i < T * per_tok_f; i += kBwdThreads) {
    const int t = i / per_tok_f, hl = (i % per_tok_f) / (D / 4), c = i % (D / 4);
    cp_async16(do_s + (hl * T + t) * LDD + c * 4, p.dout + (tok0 + t) * H + (long long)(h0 + hl) * D + c * 4);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // A thread a (head hl, query t): its row of the probabilities and of dz.
  for (int i = tid; i < nh * T; i += kBwdThreads) {
    const int hl = i / T, t = i % T, h = h0 + hl;
    const bf16* qrow = q_s + i * LDK;
    const float* drow = do_s + i * LDD;
    const bf16* kh = k_s + hl * T * LDK;
    const bf16* vh = v_s + hl * T * LDK;
    float* pr = pv_s + i * LDP;
    float* zr = dz_s + i * LDP;
    // Logits q . k and dp = do . v, summed over d in order, kBwdCols at a time.
#pragma unroll 1
    for (int d0 = 0; d0 < D; d0 += kBwdCols) {
      float qv[kBwdCols], dv[kBwdCols];
#pragma unroll
      for (int c = 0; c < kBwdCols; c += 8) unpack8(*reinterpret_cast<const uint4*>(qrow + d0 + c), qv + c);
#pragma unroll
      for (int c = 0; c < kBwdCols; c += 4) {
        const float4 f = *reinterpret_cast<const float4*>(drow + d0 + c);
        dv[c] = f.x, dv[c + 1] = f.y, dv[c + 2] = f.z, dv[c + 3] = f.w;
      }
#pragma unroll 1
      for (int s = 0; s < T; ++s) {
        float l = d0 == 0 ? 0.f : pr[s], dp = d0 == 0 ? 0.f : zr[s];
        const bf16* ks = kh + s * LDK + d0;
        const bf16* vs = vh + s * LDK + d0;
#pragma unroll
        for (int c = 0; c < kBwdCols; c += 8) {
          float kf[8], vf[8];
          unpack8(*reinterpret_cast<const uint4*>(ks + c), kf);
          unpack8(*reinterpret_cast<const uint4*>(vs + c), vf);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            l = fmaf(qv[c + e], kf[e], l);
            dp = fmaf(dv[c + e], vf[e], dp);
          }
        }
        pr[s] = l;
        zr[s] = dp;
      }
    }
    // p = softmax(logits * scale + bias), max-subtracted and normalised
    // first; dp and pv times keep * 1/(1-rate); dz = p (dp - sum_s p dp).
    const float* brow = p.bias + (long long)orig * p.bias_row_stride + (long long)t * p.bias_q_stride;
    float m = -INFINITY;
    for (int s = 0; s < T; ++s) {
      const float l = pr[s] * p.scale + brow[s];
      pr[s] = l;
      m = fmaxf(m, l);
    }
    float sum = 0.f;
    for (int s = 0; s < T; ++s) {
      const float e = expf(pr[s] - m);
      pr[s] = e;
      sum += e;
    }
    float r = 0.f;
    const uint32_t dl = kDrop ? p.drop.row_lane(orig, h) : 0u;
    for (int s = 0; s < T; ++s) {
      const float ps = pr[s] / sum;
      float dp = zr[s];
      if (kDrop) dp *= p.drop.keep_at(dl, t, s, T);
      pr[s] = ps;
      zr[s] = dp;
      r = fmaf(ps, dp, r);
    }
    for (int s = 0; s < T; ++s) {
      const float ps = pr[s];
      zr[s] = ps * (zr[s] - r);
      if (kDrop) pr[s] = ps * p.drop.keep_at(dl, t, s, T);
    }
    // attn = round(pv v) at the packed token, dq = dz k * scale at the
    // original one, kBwdCols columns at a time, sums over s in order.
    bf16* arow = p.attn + (tok0 + t) * H + (long long)h * D;
    bf16* qout = p.dqkv + ((long long)orig * T + t) * 3 * H + (long long)h * D;
#pragma unroll 1
    for (int d0 = 0; d0 < D; d0 += kBwdCols) {
      float ao[kBwdCols], aq[kBwdCols];
#pragma unroll
      for (int e = 0; e < kBwdCols; ++e) ao[e] = aq[e] = 0.f;
#pragma unroll 1
      for (int s = 0; s < T; ++s) {
        const float ps = pr[s], zs = zr[s];
        const bf16* vs = vh + s * LDK + d0;
        const bf16* ks = kh + s * LDK + d0;
#pragma unroll
        for (int c = 0; c < kBwdCols; c += 8) {
          float vf[8], kf[8];
          unpack8(*reinterpret_cast<const uint4*>(vs + c), vf);
          unpack8(*reinterpret_cast<const uint4*>(ks + c), kf);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            ao[c + e] = fmaf(ps, vf[e], ao[c + e]);
            aq[c + e] = fmaf(zs, kf[e], aq[c + e]);
          }
        }
      }
      store_bf16(arow + d0, ao, 1.f);
      store_bf16(qout + d0, aq, p.scale);
    }
  }
  __syncthreads();

  // A thread a (head hl, key s): dk = dz^T q * scale and dv = pv^T do, sums
  // over the queries t in order, at the original token.
  for (int i = tid; i < nh * T; i += kBwdThreads) {
    const int hl = i / T, s = i % T, h = h0 + hl;
    const float* pcol = pv_s + hl * T * LDP + s;
    const float* zcol = dz_s + hl * T * LDP + s;
    bf16* kout = p.dqkv + ((long long)orig * T + s) * 3 * H + H + (long long)h * D;
#pragma unroll 1
    for (int d0 = 0; d0 < D; d0 += kBwdCols) {
      float ak[kBwdCols], av[kBwdCols];
#pragma unroll
      for (int e = 0; e < kBwdCols; ++e) ak[e] = av[e] = 0.f;
#pragma unroll 1
      for (int t = 0; t < T; ++t) {
        const float zt = zcol[t * LDP], pt = pcol[t * LDP];
        const bf16* qs = q_s + (hl * T + t) * LDK + d0;
        const float* ds = do_s + (hl * T + t) * LDD + d0;
#pragma unroll
        for (int c = 0; c < kBwdCols; c += 8) {
          float qf[8];
          unpack8(*reinterpret_cast<const uint4*>(qs + c), qf);
          const float4 d_lo = *reinterpret_cast<const float4*>(ds + c);
          const float4 d_hi = *reinterpret_cast<const float4*>(ds + c + 4);
          const float df[8] = {d_lo.x, d_lo.y, d_lo.z, d_lo.w, d_hi.x, d_hi.y, d_hi.z, d_hi.w};
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            ak[c + e] = fmaf(zt, qf[e], ak[c + e]);
            av[c + e] = fmaf(pt, df[e], av[c + e]);
          }
        }
      }
      store_bf16(kout + d0, ak, p.scale);
      store_bf16(kout + H + d0, av, 1.f);
    }
  }
}

// --- dWo = attn_p^T g_p and dbo = sum g_p over the packed rows ------------------

constexpr int kWeightBT = 128;  // rows and columns of an output tile
constexpr size_t kWeightSmem = tail::ring_smem(kWeightBT * kBK, kWeightBT * kBK);

struct WeightArgs {
  int M, H, seq;
  long long chunk;  // packed rows a split, a multiple of kBK
  const int* count;
  float* partial;    // [splits, Hq, H]: each split's dWo
  float* partial_b;  // [splits, H]: each split's dbo
  int Hq;            // attn's width: dWo's rows (H, or a model rank's H / M)
};

// Block (x, y): output tile x of dWo [Hq, H] over packed rows [y chunk, (y +
// 1) chunk) up to the live rows rounded up to kBK (the gather zeroed the rows
// between), into split y's partials; a split past them writes zeros. Both
// operands are token rows, read MN-major: A^T from [64 k, 64 m] boxes of attn
// (imm-trans-a), B from [64 k, 64 n] boxes of g; no box past H is loaded.
// The blocks of the first tile row also add up g's columns of each stage
// from the swizzled B tile: their split's dbo. Each warpgroup sums its own
// 32 rows of the stage and meets at a named barrier before consume() frees
// the stage, so no TMA load of a later step lands under a read.
__global__ void __launch_bounds__(kGemmThreads, 2)
    proj_bwd_weight_gemm_kernel(const __grid_constant__ CUtensorMap map_attn,
                                const __grid_constant__ CUtensorMap map_g, WeightArgs p) {
  using namespace hopper;
  using namespace tail;
  constexpr int BT = kWeightBT;
  const int H = p.H, Hq = p.Hq, tiles = (H + BT - 1) / BT;
  const int m0 = (blockIdx.x / tiles) * BT, n0 = (blockIdx.x % tiles) * BT;
  float* out = p.partial + (long long)blockIdx.y * Hq * H;
  const long long live = p.count != nullptr ? (long long)*p.count * p.seq : p.M;
  const long long k0 = blockIdx.y * p.chunk;
  const long long k1 = min(k0 + p.chunk, round_up(live, kBK));
  const int nk = k1 > k0 ? (int)((k1 - k0) / kBK) : 0;
  const bool bias_row = m0 == 0;

  extern __shared__ unsigned char smem_raw[];
  __shared__ float bias_half[kConsumers];
  const Ring ring = make_ring(smem_raw, BT * kBK, BT * kBK);
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      const int abox = min(BT, Hq - m0) / 64, bbox = min(BT, H - n0) / 64;
      produce(ring, nk, (abox + bbox) * 64 * kBK * sizeof(bf16), [&](int s, int k) {
        const int kr = (int)(k0 + k * kBK);
        for (int j = 0; j < abox; ++j) {
          tma_load_2d(ring.a_stage(s) + j * 64 * kBK, &map_attn, &ring.full[s], m0 + 64 * j, kr);
        }
        for (int j = 0; j < bbox; ++j) {
          tma_load_2d(ring.b_stage(s) + j * 64 * kBK, &map_g, &ring.full[s], n0 + 64 * j, kr);
        }
      });
    }
    return;
  }

  const int w = threadIdx.x / 128, t = threadIdx.x % 128;
  // dbo: consumer thread (column bc of the tile, rows 32 bh .. 32 bh + 31 of
  // each stage); element (r, c) of a [64 k, 64 n] box lies in 16-byte chunk
  // (c / 8) ^ (r % 8) of its 128-byte row (the 128-byte swizzle).
  const int bc = threadIdx.x % BT, bh = threadIdx.x / BT;
  float bsum = 0.f;
  float acc[BT / 2];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) acc[i] = 0.f;
  consume(ring, nk, [&](int s, int) {
    const bf16* a = ring.a_stage(s) + w * 64 * kBK;  // this warpgroup's 64 rows: one [64 k, 64 m] box
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      Wgmma<BT, 1, 1>::mma(acc, desc_mn(a, kk), desc_mn(ring.b_stage(s), kk), 1);
    }
    if (bias_row) {
      const bf16* box = ring.b_stage(s) + (bc / 64) * 64 * kBK;
      const int c = bc % 64;
#pragma unroll 8
      for (int r = 32 * bh; r < 32 * bh + 32; ++r) {
        bsum += __bfloat162float(box[r * 64 + (((c >> 3) ^ (r & 7)) << 3) + (c & 7)]);
      }
      if (w == 0) {  // constant ids: ptxas then reserves 4 barriers, not all 16
        named_barrier_sync(2, 128);
      } else {
        named_barrier_sync(3, 128);
      }
    }
  }, acc);
  const int rl = m0 + w * 64 + (t / 32) * 16 + (t % 32) / 4, cl = n0 + 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rl + 8 * h, c = cl + 8 * j;
      if (r < Hq && c < H) {
        *reinterpret_cast<float2*>(out + (long long)r * H + c) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
  if (bias_row) {
    bias_half[threadIdx.x] = bsum;
    named_barrier_sync(1, kConsumers);
    if (threadIdx.x < BT && n0 + threadIdx.x < H) {
      p.partial_b[(long long)blockIdx.y * H + n0 + threadIdx.x] =
          bias_half[threadIdx.x] + bias_half[threadIdx.x + BT];
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes, bool& done) {
  if (done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  done = err == cudaSuccess;
  return (int)err;
}

template <int D>
int launch_attn_bwd(AttnBwdArgs a, cudaStream_t stream) {
  static bool smem_set[2] = {false, false};  // without, with dropout
  a.hb = attn_bwd_heads<D>(a.T, a.N);
  const size_t smem = attn_bwd_smem_bytes<D>(a.hb, a.T);
  if (smem > kMaxSmem) return -1;
  auto kernel = a.drop.on ? proj_bwd_attn_kernel<D, true> : proj_bwd_attn_kernel<D, false>;
  const int err = set_smem(kernel, kMaxSmem, smem_set[a.drop.on ? 1 : 0]);
  if (err) return err;
  kernel<<<dim3(a.B, (a.N + a.hb - 1) / a.hb), kBwdThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

struct TcArgs {
  const bf16* x;
  const bf16* wqkv;  // in_proj_weight [3Hq, H]
  const bf16* bqkv;
  const bf16* wo;    // out_proj.weight [H_out, H_in = Hq]
  const float* bias;
  long long bias_row_stride, bias_q_stride;
  const bf16* g;
  const uint8_t* rows_live;
  bf16* dqkv;
  float* partial;    // [splits, Hq, H]
  float* partial_b;  // [splits, H]
  float* dwo;
  float* dbo;
  int rows, seq, H, N;
  float scale;
  RowDropout drop;
  int splits;
  long long chunk;
  int Hq;  // the q/k/v width N D: H, or a model rank's H / M
};

// The bf16 backward (the launches of the note at the top). `scratch`
// (16-byte aligned) holds, for M = rows * seq tokens: the packed x [M, H],
// then attn [M, Hq], and the packed g [M, H] in bf16, qkv [M, 3Hq] in bf16,
// do [M, Hq] in f32, then the packed rows [rows] and their count (int32).
int launch_tc(const TcArgs& p, void* scratch, cudaStream_t stream) {
  const long long M = (long long)p.rows * p.seq;
  const int H = p.H, Hq = p.Hq;
  if (M == 0) {
    cudaMemsetAsync(p.dwo, 0, sizeof(float) * Hq * H, stream);
    cudaMemsetAsync(p.dbo, 0, sizeof(float) * H, stream);
    return (int)cudaGetLastError();
  }
  if (scratch == nullptr || p.partial == nullptr || p.partial_b == nullptr || M > 0x7fffffffLL ||
      (M + kBM - 1) / kBM > 65535 || p.chunk % kBK != 0 || p.chunk * p.splits < M) {
    return -1;
  }
  unsigned char* base = static_cast<unsigned char*>(scratch);
  bf16* xa = reinterpret_cast<bf16*>(base);
  bf16* gp = xa + M * H;
  bf16* qkv = gp + M * H;
  float* dout = reinterpret_cast<float*>(qkv + M * 3 * Hq);
  int* rows = reinterpret_cast<int*>(base + M * (4LL * H + 10LL * Hq));
  int* count = rows + p.rows;
  const bool packed = p.rows_live != nullptr;
  const bf16* xs = packed ? xa : p.x;
  const bf16* gs = packed ? gp : p.g;
  if (!packed) rows = count = nullptr;  // every row live: packed row b is row b
  CUtensorMap map_x, map_wqkv, map_g, map_wo, map_attn, map_gw;
  int err = hopper::make_map(&map_x, xs, M, H, kBM);
  if (!err) err = hopper::make_map(&map_wqkv, p.wqkv, 3 * Hq, H, kBN);  // [3Hq, H]: K-major B
  if (!err) err = hopper::make_map(&map_g, gs, M, H, kBM);
  if (!err) err = hopper::make_map(&map_wo, p.wo, H, Hq, kBK);  // [H_out = k, Hq = n]: MN-major B
  if (!err) err = hopper::make_map(&map_attn, xa, M, Hq, kBK);
  if (!err) err = hopper::make_map(&map_gw, gs, M, H, kBK);
  if (err) return err;
  static bool gemm_set = false, weight_set = false;
  if ((err = set_smem(proj_bwd_gemm_kernel, kGemmSmem, gemm_set))) return err;
  if ((err = set_smem(proj_bwd_weight_gemm_kernel, kWeightSmem, weight_set))) return err;
  if (packed) {
    proj_bwd_scan_kernel<<<1, kScanThreads, 0, stream>>>(p.rows_live, p.rows, rows, count);
    proj_bwd_gather_kernel<<<(unsigned)((M + kRowWarps - 1) / kRowWarps), 32 * kRowWarps, 0, stream>>>(
        p.x, p.g, xa, gp, rows, count, p.seq, H, M);
    if ((err = (int)cudaGetLastError())) return err;
  }
  const GemmArgs g1{(int)M, 3 * Hq, H, p.bqkv, qkv, nullptr, count, p.seq, 0};
  const GemmF32Args g2{(int)M, Hq, H, dout, count, p.seq};
  const dim3 ggrid((3 * Hq + kBN - 1) / kBN + (Hq + kBN - 1) / kBN, (unsigned)((M + kBM - 1) / kBM));
  proj_bwd_gemm_kernel<<<ggrid, kGemmThreads, kGemmSmem, stream>>>(map_x, map_wqkv, map_g, map_wo, g1, g2);
  if ((err = (int)cudaGetLastError())) return err;
  const AttnBwdArgs a{qkv, dout, xa, p.dqkv, p.bias, p.bias_row_stride, p.bias_q_stride, rows, count,
                      p.rows, p.seq, Hq, p.N, 1, p.scale, p.drop};
  switch (Hq / p.N) {
    case 32: err = launch_attn_bwd<32>(a, stream); break;
    case 64: err = launch_attn_bwd<64>(a, stream); break;
    case 128: err = launch_attn_bwd<128>(a, stream); break;
    default: err = -1;
  }
  if (err) return err;
  const int tiles_m = (Hq + kWeightBT - 1) / kWeightBT, tiles_n = (H + kWeightBT - 1) / kWeightBT;
  const WeightArgs w{(int)M, H, p.seq, p.chunk, count, p.partial, p.partial_b, Hq};
  proj_bwd_weight_gemm_kernel<<<dim3(tiles_m * tiles_n, p.splits), kGemmThreads, kWeightSmem, stream>>>(
      map_attn, map_gw, w);
  if ((err = (int)cudaGetLastError())) return err;
  const WoArgs f{nullptr, nullptr, nullptr, p.partial, p.partial_b, p.dwo, p.dbo, 0, 0, 0, H, p.splits, Hq};
  proj_bwd_finalize_kernel<<<(unsigned)(((long long)Hq * H + H + 255) / 256), 256, 0, stream>>>(f);
  return (int)cudaGetLastError();
}

// --- f32 launch -----------------------------------------------------------------

template <int D>
int launch_f32(const BwdArgs& a, cudaStream_t stream) {
  auto kernel = fused_proj_bwd_kernel<D>;
  const size_t smem = bwd_smem_bytes<D>();
  if (smem > kMaxSmem) return -1;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (a.rows + a.rows_per_block - 1) / a.rows_per_block;
  if (grid > 0) kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int dispatch_f32(int head_dim, const BwdArgs& a, cudaStream_t s) {
  switch (head_dim) {
    case 32: return launch_f32<32>(a, s);
    case 64: return launch_f32<64>(a, s);
    case 128: return launch_f32<128>(a, s);
    default: return -1;
  }
}

// `inner` (Hq) the q/k/v width of the launch's num_heads heads (H in one
// process), the model width `hidden` for x, g and dWo's columns.
int launch_bwd(const void* x, const void* wqkv, const void* bqkv, const void* wo, const void* bias,
               long long bias_row_stride, long long bias_q_stride, const void* g, const void* rows_live,
               void* dqkv, void* scratch, float* partial, float* partial_b, float* dwo, float* dbo,
               int rows, int seq, int hidden, int inner, int num_heads, float scale, const RowDropout& drop,
               int splits, long long chunk, int dtype, cudaStream_t s) {
  if (hidden % 64 != 0 || hidden < 64 || hidden > 64 * kMaxNC || inner % 64 != 0 || inner < 64 ||
      inner > hidden || num_heads < 1 || inner % num_heads != 0 || seq < 1 || seq > kTK || rows < 0 ||
      splits < 1) {
    return -1;
  }
  const int head_dim = inner / num_heads;
  if (head_dim != 32 && head_dim != 64 && head_dim != 128) return -1;
  if (dtype == 1) {
    const TcArgs p{static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv), static_cast<const bf16*>(bqkv),
                   static_cast<const bf16*>(wo), static_cast<const float*>(bias), bias_row_stride,
                   bias_q_stride, static_cast<const bf16*>(g), static_cast<const uint8_t*>(rows_live),
                   static_cast<bf16*>(dqkv), partial, partial_b, dwo, dbo, rows, seq, hidden, num_heads,
                   scale, drop, splits, chunk, inner};
    return launch_tc(p, scratch, s);
  }
  if (dtype != 0) return -2;
  if (chunk % kKM != 0) return -1;
  BwdArgs a{x, wqkv, bqkv, wo, static_cast<const float*>(bias), bias_row_stride, bias_q_stride,
            g, static_cast<const uint8_t*>(rows_live), dqkv, scratch, rows, seq, num_heads,
            seq > kTM ? 1 : kTM / seq, scale, drop, hidden};
  int err = dispatch_f32(head_dim, a, s);
  if (err != 0) return err;
  const long long tokens = (long long)rows * seq;
  WoArgs w{scratch, g, static_cast<const uint8_t*>(rows_live), partial, partial_b, dwo, dbo,
           tokens, chunk, seq, hidden, splits, inner};
  const dim3 grid((inner / kTO) * (hidden / kTO), splits);  // a split past the last token writes zeros
  proj_bwd_dwo_kernel<<<grid, kThreads, 0, s>>>(w);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long long n = (long long)inner * hidden + hidden;
  proj_bwd_finalize_kernel<<<(int)((n + 255) / 256), 256, 0, s>>>(w);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0, a cudaError_t from a launch, -1 for a shape the kernels do not
// take (H or the q/k/v width `inner` not a multiple of 64 up to 1024,
// inner / num_heads not in {32, 64, 128}, T > 64, heads [head0, head0 +
// num_heads) not within `heads`, a split chunk that is not a multiple of 32
// tokens in f32 or 64 in bf16, no scratch in bf16), -2 for an unknown dtype
// code (0 = float32, 1 = bfloat16) or -3 if a TMA map cannot be encoded.
// One process passes inner = H, head0 = 0 and heads = num_heads; a model
// rank its num_heads heads of width Hq = inner, hashed as the global heads
// head0, ..., head0 + num_heads - 1 of `heads`, with g [rows, seq, H] the
// cotangent of the ranks' summed output (the same on every rank). wo is the
// model's out_proj.weight [H_out, inner] (Wo transposed, a rank's shard) in
// both dtypes; dqkv [rows, seq, 3 inner], dWo [inner, H] (input-major),
// dbo [H] (the whole bias's gradient), partial [splits, inner, H] and
// partial_b [splits, H] (f32) each split's dWo and dbo, summed by
// proj_bwd_finalize_kernel. f32: wqkv [H, 3 inner] input-major; scratch the
// attention output [rows * seq, inner]; the backward kernel, the split
// dWo/dbo reduction and the finalize pass. bf16: wqkv as the model stores it
// [3 inner, H]; x, g, the weights and the rows_live bytes 16-byte aligned;
// scratch as launch_tc lays it out ((4 H + 10 inner) bytes a token, the
// packed rows and count); the launches of launch_tc. All on `stream`.
extern "C" int stlt_fused_proj_attention_bwd(
    const void* x, const void* wqkv, const void* bqkv, const void* wo, const void* bias,
    long long bias_row_stride, long long bias_q_stride, const void* g, const void* rows_live,
    void* dqkv, void* scratch, float* partial, float* partial_b, float* dwo, float* dbo, int rows,
    int seq, int hidden, int inner, int num_heads, float scale, int dropout, unsigned int seed,
    unsigned int thresh, float dropout_scale, unsigned int row_base, unsigned int row_period,
    unsigned int row_stride, unsigned int row_magic, unsigned int head0, unsigned int heads, int splits,
    long long chunk, int dtype, void* stream) {
  if (num_heads < 1 || head0 + num_heads > heads) return -1;
  const RowDropout drop{dropout, seed, thresh, dropout_scale,
                        RowMap{row_base, row_period, row_stride, row_magic}, head0, heads};
  return launch_bwd(x, wqkv, bqkv, wo, bias, bias_row_stride, bias_q_stride, g, rows_live, dqkv, scratch,
                    partial, partial_b, dwo, dbo, rows, seq, hidden, inner, num_heads, scale, drop, splits,
                    chunk, dtype, static_cast<cudaStream_t>(stream));
}
