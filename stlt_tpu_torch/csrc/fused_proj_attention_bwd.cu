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
// in place as in the forward kernel. The three remaining products (dx, dWqkv,
// dbqkv) are plain GEMMs the wrapper leaves to torch.matmul, as the JAX
// package leaves them to XLA.
//
// Design. The TPU kernel keeps a row block's whole f32 qkv in VMEM and
// carries dWo/dbo across its sequential grid. On this card a block has 227 KB
// of shared memory and blocks run in no order, so the work is split in two
// kernels:
//
// 1. fused_proj_bwd_*: one block per tile of whole rows (floor(32 / T) rows
//    for T <= 32, one row of up to 64 tokens otherwise), looping over the
//    heads (head dim D = 32, 64 or 128 a template argument, H any multiple
//    of 64 up to 1024 a runtime value; at D = 128 and H = 1024 the bf16
//    kernel takes 226,560 bytes of shared memory, its q/k/v held in bf16 as
//    they are rounded to it (f32 below D = 128), its weight slices 16 rows). Per head it projects q/k/v from the x tile and do from the g tile
//    (32-token chunks through one shared A tile: on the tensor cores in bf16,
//    Wqkv and Wo^T streamed by cp.async; on the SIMT pipes in f32), runs the
//    T x T softmax backward in f32 on the SIMT pipes, and writes that head's
//    dq/dk/dv slices of dqkv and its slice of the rounded, dropped attention
//    output to a scratch buffer the wrapper allocates.
// 2. proj_bwd_dwo_*: dWo = attn^T g and dbo = sum g as a split reduction:
//    one block per 64 x 64 output tile and token chunk writes its partial sum
//    (WMMA in bf16, SIMT in f32), and proj_bwd_finalize adds the partials in
//    split order. No atomics: two runs give the same bits.
//
// Dead rows (rows_live 0) write exact zeros into dqkv and the attention
// scratch, so they add nothing to dWo; dbo sums live rows only. A block with
// no live row skips all compute. This is the exact gradient of the forward,
// whose dead rows are constant zeros.
//
// Bound on this card: per live row 10*T*H^2 + 12*T^2*H flops (q/k/v and do
// recompute, dWo, the T x T products) against x, g read and dqkv written, far
// above the H100's ~295 flop/byte ridge at the main-path shapes, so the
// tensor cores bound it. The design recomputes rather than store qkv, as the
// TPU kernel does; what holds it back is its WMMA tiles on 32-token chunks,
// with Wqkv and Wo^T re-read from L2 by every block.
#include <cstdint>

#include "common.cuh"

namespace {

using namespace stlt;
using bf16 = __nv_bfloat16;

constexpr int kKT = 16;  // k-slice staged per SIMT step

// bf16: rows of Wqkv / Wo^T per streamed slice (16 at D = 128 keeps the block
// inside 227 KB at H = 1024: 226,560 bytes).
template <int D>
__host__ __device__ constexpr int bwd_slice_rows() {
  return D > 64 ? 16 : 32;
}
constexpr int kTO = 64;  // dWo output tile edge
constexpr int kKM = 32;  // tokens per step of the dWo reduction

struct BwdArgs {
  const void* x;
  const void* wqkv;
  const void* bqkv;
  const void* wot;  // Wo^T [H, H]: row j holds Wo[:, j]
  const float* bias;
  long long bias_row_stride;
  long long bias_q_stride;
  const void* g;
  const uint8_t* rows_live;
  void* dqkv;
  void* attn;  // scratch [rows * T, H]
  int rows;
  int seq;
  int num_heads;
  int rows_per_block;
  float scale;
  Dropout drop;
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
// q_s/k_s/v_s [kTK][D] (f32, or bf16 in the bf16 kernel: they are rounded to
// it) and do_s [kTK][D] f32 in shared memory, with p_s/dp_s [kTK][kTK] as
// scratch. Writes dq/dk/dv of the head into dqkv and the rounded, dropped
// attention output into the scratch, zeros for dead rows.
template <typename E, int D, typename QE>
__device__ void head_backward(const BwdArgs& p, const Tile& tl, int h, const QE* q_s,
                              const QE* k_s, const QE* v_s, const float* do_s, float* p_s,
                              float* dp_s) {
  const int tid = threadIdx.x, seq = p.seq, H = p.num_heads * D;
  E* __restrict__ dqkv = static_cast<E*>(p.dqkv);
  E* __restrict__ attn = static_cast<E*>(p.attn);
  const int n = tl.ntok * seq;
  // p = softmax(q k^T * scale + bias); dp = (do v^T) * keep * 1/(1-rate).
  for (int idx = tid; idx < n; idx += kThreads) {
    const int i = idx / seq, s = idx % seq, lr = i / seq, t = i % seq;
    const QE* qi = q_s + i * D;
    const QE* ks = k_s + (lr * seq + s) * D;
    const float* di = do_s + i * D;
    const QE* vs = v_s + (lr * seq + s) * D;
    float dot = 0.f, dpv = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      dot = fmaf(to_float(qi[d]), to_float(ks[d]), dot);
      dpv = fmaf(di[d], to_float(vs[d]), dpv);
    }
    const float b = p.bias[(long long)(tl.row0 + lr) * p.bias_row_stride +
                           (long long)t * p.bias_q_stride + s];
    p_s[i * kTK + s] = dot * p.scale + b;
    if (p.drop.on) dpv *= p.drop.keep_scale(tl.row0 + lr, h, p.num_heads, t, s, seq);
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
    for (int s = 0; s < seq; ++s) {
      dr[s] = pr[s] * (dr[s] - r);
      if (p.drop.on) pr[s] *= p.drop.keep_scale(tl.row0 + lr, h, p.num_heads, t, s, seq);
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
        o = fmaf(pj[s], to_float(v_s[(base + s) * D + d]), o);
        dq = fmaf(zj[s], to_float(k_s[(base + s) * D + d]), dq);
      }
      const int sj = j - base;  // j as a key: sum over the queries of its row
      for (int t = 0; t < seq; ++t) {
        dk = fmaf(dp_s[(base + t) * kTK + sj], to_float(q_s[(base + t) * D + d]), dk);
        dv = fmaf(p_s[(base + t) * kTK + sj], do_s[(base + t) * D + d], dv);
      }
      dq *= p.scale;
      dk *= p.scale;
    }
    const long long tok = tl.tok0 + j;
    E* row = dqkv + tok * 3 * H + h * D + d;
    row[0] = from_float<E>(dq);
    row[H] = from_float<E>(dk);
    row[2 * H] = from_float<E>(dv);
    attn[tok * H + h * D + d] = from_float<E>(o);
  }
  __syncthreads();
}

// A tile with no live row: zeros for its dqkv and attention-scratch rows.
template <typename E>
__device__ __forceinline__ void zero_tile(const BwdArgs& p, const Tile& tl, int H) {
  const long long n3 = (long long)tl.ntok * 3 * H, n1 = (long long)tl.ntok * H;
  E* dq = static_cast<E*>(p.dqkv) + tl.tok0 * 3 * H;
  E* at = static_cast<E*>(p.attn) + tl.tok0 * H;
  for (long long i = threadIdx.x; i < n3; i += kThreads) dq[i] = from_float<E>(0.f);
  for (long long i = threadIdx.x; i < n1; i += kThreads) at[i] = from_float<E>(0.f);
}

// --- f32: SIMT ----------------------------------------------------------------

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
  const int H = p.num_heads * D;
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
    zero_tile<float>(p, tl, H);
    return;
  }
  const int nchunks = (tl.ntok + kTM - 1) / kTM;

  for (int h = 0; h < p.num_heads; ++h) {
    const FSegs wqkv_head{{wqkv + h * D, wqkv + H + h * D, wqkv + 2 * H + h * D}, D, 3 * H, 3 * D};
    const FSegs wot_head{{wot + h * D, nullptr, nullptr}, D, H, D};
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
        const float b = bqkv[part * H + h * D + d];
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
    head_backward<float, D>(p, tl, h, q_s, k_s, v_s, do_s, p_s, dp_s);
  }
}

// --- bf16: tensor cores -------------------------------------------------------

template <int D>
size_t bwd_tc_smem_bytes(int H) {
  return sizeof(bf16) * ((size_t)kTM * (H + kPad) + ring_elems(bwd_slice_rows<D>(), 3 * D)) +
         sizeof(typename QkvType<D>::type) * (size_t)3 * kTK * D +
         sizeof(float) * (size_t)(kTK * D + 2 * kTK * kTK + kWarps * 256);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) fused_proj_bwd_tc_kernel(BwdArgs p) {
  constexpr int kKS = bwd_slice_rows<D>();
  constexpr int kQCF = (3 * D / 16 + 3) / 4, kDCF = (D / 16 + 3) / 4;  // fragments of a warp
  using QE = typename QkvType<D>::type;
  const int H = p.num_heads * D, LDA = H + kPad;
  const bf16* __restrict__ x = static_cast<const bf16*>(p.x);
  const bf16* __restrict__ wqkv = static_cast<const bf16*>(p.wqkv);
  const bf16* __restrict__ bqkv = static_cast<const bf16*>(p.bqkv);
  const bf16* __restrict__ wot = static_cast<const bf16*>(p.wot);
  const bf16* __restrict__ g = static_cast<const bf16*>(p.g);

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* a_s = reinterpret_cast<bf16*>(smem_raw);  // [kTM][LDA]: a chunk of x or g
  bf16* stages = a_s + kTM * LDA;                 // ring of Wqkv / Wo^T slices
  QE* q_s = reinterpret_cast<QE*>(stages + ring_elems(kKS, 3 * D));  // [kTK][D], rounded
  QE* k_s = q_s + kTK * D;
  QE* v_s = k_s + kTK * D;
  float* do_s = reinterpret_cast<float*>(v_s + kTK * D);  // [kTK][D]
  float* p_s = do_s + kTK * D;    // [kTK][kTK]
  float* dp_s = p_s + kTK * kTK;  // [kTK][kTK]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* scratch = dp_s + kTK * kTK + warp * 256;

  const Tile tl = block_tile(p);
  if (!block_has_live(p.rows_live, tl.row0, tl.nrows)) {
    zero_tile<bf16>(p, tl, H);
    return;
  }
  const int nchunks = (tl.ntok + kTM - 1) / kTM;
  // q/k/v: warp covers row fragment warp / 4, column fragments warp % 4 + 4 j
  // of [kTM, 3 * D]; do: the same of [kTM, D].
  const int qrf = warp / 4, qcf0 = warp % 4;

  auto load_chunk = [&](const bf16* src, int c) {
    copy_rows(a_s, LDA, src + (tl.tok0 + kTM * c) * H, H, min(kTM, tl.ntok - kTM * c), kTM, H);
  };

  for (int h = 0; h < p.num_heads; ++h) {
    const BCols<3, D> wqkv_head{{wqkv + h * D, wqkv + H + h * D, wqkv + 2 * H + h * D}, 3 * H};
    const BCols<1, D> wot_head{{wot + h * D}, H};
    for (int c = 0; c < nchunks; ++c) {
      // gemm_ring synchronises the block before it reads a_s and after.
      load_chunk(x, c);
      FragC qacc[1][kQCF];
      zero(qacc);
      gemm_ring<1, kQCF, kKS>(qacc, a_s + qrf * 16 * LDA, LDA, wqkv_head, H, stages, qcf0, 4);
#pragma unroll
      for (int j = 0; j < kQCF; ++j) {
        const int cf = qcf0 + 4 * j;
        if (cf >= 3 * D / 16) continue;  // uniform over the warp
        for_each_element(qacc[0][j], scratch, lane, [&](int i, int jj, float v) {
          const int cc = cf * 16 + jj, part = cc / D, d = cc % D;
          QE* dst = part == 0 ? q_s : (part == 1 ? k_s : v_s);
          dst[(c * kTM + qrf * 16 + i) * D + d] =
              from_float<QE>(round_to<bf16>(v + to_float(bqkv[part * H + h * D + d])));
        });
      }
      load_chunk(g, c);
      FragC dacc[1][kDCF];
      zero(dacc);
      gemm_ring<1, kDCF, kKS>(dacc, a_s + qrf * 16 * LDA, LDA, wot_head, H, stages, qcf0, 4);
#pragma unroll
      for (int j = 0; j < kDCF; ++j) {
        const int cf = qcf0 + 4 * j;
        if (cf >= D / 16) continue;  // uniform over the warp
        for_each_element(dacc[0][j], scratch, lane, [&](int i, int jj, float v) {
          do_s[(c * kTM + qrf * 16 + i) * D + cf * 16 + jj] = v;
        });
      }
    }
    __syncthreads();
    head_backward<bf16, D>(p, tl, h, q_s, k_s, v_s, do_s, p_s, dp_s);
  }
}

// --- dWo = attn^T g, dbo = sum g: split reduction -----------------------------

struct WoArgs {
  const void* attn;
  const void* g;
  const uint8_t* rows_live;
  float* partial;    // [splits, H, H]
  float* partial_b;  // [splits, H]
  float* dwo;
  float* dbo;
  long long tokens;
  long long chunk;  // tokens per split, a multiple of kKM
  int seq;
  int hidden;
  int splits;
};

__device__ __forceinline__ bool token_live(const WoArgs& a, long long m) {
  return a.rows_live == nullptr || a.rows_live[m / a.seq];
}

// Column sums of g over the live tokens of the staged step, for the blocks
// of the first row of tiles: thread k < kTO owns output column k0 + k.
template <typename E>
__device__ __forceinline__ void add_bias_sums(const WoArgs& a, const E* g_t, int ld, long long m0,
                                              int nm, float& sum) {
  if (threadIdx.x >= kTO) return;
  for (int m = 0; m < nm; ++m) {
    if (token_live(a, m0 + m)) sum += to_float(g_t[m * ld + threadIdx.x]);
  }
}

template <typename E>
__device__ __forceinline__ void stage_tokens(const WoArgs& a, E* a_t, E* g_t, int ld, int j0,
                                             int k0, long long m0, int nm) {
  const E* attn = static_cast<const E*>(a.attn);
  const E* g = static_cast<const E*>(a.g);
  for (int i = threadIdx.x; i < kKM * kTO; i += kThreads) {
    const int m = i / kTO, c = i % kTO;
    const bool in = m < nm;
    a_t[m * ld + c] = in ? attn[(m0 + m) * a.hidden + j0 + c] : from_float<E>(0.f);
    g_t[m * ld + c] = in ? g[(m0 + m) * a.hidden + k0 + c] : from_float<E>(0.f);
  }
}

// f32: each thread owns a 4 x 4 patch of the 64 x 64 tile.
__global__ void __launch_bounds__(kThreads) proj_bwd_dwo_kernel(WoArgs a) {
  __shared__ float a_t[kKM * kTO], g_t[kKM * kTO];
  const int tiles = a.hidden / kTO;
  const int j0 = (blockIdx.x / tiles) * kTO, k0 = (blockIdx.x % tiles) * kTO;
  const long long m_begin = blockIdx.y * a.chunk;
  const long long m_end = min(a.tokens, m_begin + a.chunk);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};
  float bsum = 0.f;
  for (long long m0 = m_begin; m0 < m_end; m0 += kKM) {
    const int nm = (int)min((long long)kKM, m_end - m0);
    stage_tokens<float>(a, a_t, g_t, kTO, j0, k0, m0, nm);
    __syncthreads();
    for (int m = 0; m < nm; ++m) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float av = a_t[m * kTO + ty * 4 + r];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av, g_t[m * kTO + tx * 4 + c], acc[r][c]);
      }
    }
    if (j0 == 0) add_bias_sums<float>(a, g_t, kTO, m0, nm, bsum);
    __syncthreads();
  }
  float* out = a.partial + (long long)blockIdx.y * a.hidden * a.hidden;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) out[(long long)(j0 + ty * 4 + r) * a.hidden + k0 + tx * 4 + c] = acc[r][c];
  if (j0 == 0 && tid < kTO) a.partial_b[(long long)blockIdx.y * a.hidden + k0 + tid] = bsum;
}

// bf16: WMMA, attn^T as a col-major A operand; warp w owns row fragment w / 2
// and column fragments 2 * (w % 2) + {0, 1} of the tile.
__global__ void __launch_bounds__(kThreads) proj_bwd_dwo_tc_kernel(WoArgs a) {
  constexpr int LD = kTO + kPad;
  __shared__ __align__(128) bf16 a_t[kKM * LD];
  __shared__ __align__(128) bf16 g_t[kKM * LD];
  __shared__ __align__(128) float scratch[kWarps * 256];
  using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
  const int tiles = a.hidden / kTO;
  const int j0 = (blockIdx.x / tiles) * kTO, k0 = (blockIdx.x % tiles) * kTO;
  const long long m_begin = blockIdx.y * a.chunk;
  const long long m_end = min(a.tokens, m_begin + a.chunk);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rf = warp / 2, cf0 = 2 * (warp % 2);
  FragC acc[1][2];
  zero(acc);
  float bsum = 0.f;
  for (long long m0 = m_begin; m0 < m_end; m0 += kKM) {
    const int nm = (int)min((long long)kKM, m_end - m0);
    stage_tokens<bf16>(a, a_t, g_t, LD, j0, k0, m0, nm);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKM; kk += 16) {
      FragAT fa;
      wmma::load_matrix_sync(fa, a_t + kk * LD + rf * 16, LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        FragB fb;
        wmma::load_matrix_sync(fb, g_t + kk * LD + (cf0 + j) * 16, LD);
        wmma::mma_sync(acc[0][j], fa, fb, acc[0][j]);
      }
    }
    if (j0 == 0) add_bias_sums<bf16>(a, g_t, LD, m0, nm, bsum);
    __syncthreads();
  }
  float* out = a.partial + (long long)blockIdx.y * a.hidden * a.hidden;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    for_each_element(acc[0][j], scratch + warp * 256, lane, [&](int i, int jj, float v) {
      out[(long long)(j0 + rf * 16 + i) * a.hidden + k0 + (cf0 + j) * 16 + jj] = v;
    });
  }
  if (j0 == 0 && tid < kTO) a.partial_b[(long long)blockIdx.y * a.hidden + k0 + tid] = bsum;
}

// dWo and dbo: the partials summed in split order.
__global__ void proj_bwd_finalize_kernel(WoArgs a) {
  const long long hh = (long long)a.hidden * a.hidden;
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

template <int D, bool kTensorCores>
int launch(const BwdArgs& a, int H, cudaStream_t stream) {
  auto kernel = kTensorCores ? fused_proj_bwd_tc_kernel<D> : fused_proj_bwd_kernel<D>;
  const size_t smem = kTensorCores ? bwd_tc_smem_bytes<D>(H) : bwd_smem_bytes<D>();
  if (smem > kMaxSmem) return -1;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (a.rows + a.rows_per_block - 1) / a.rows_per_block;
  if (grid > 0) kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kTensorCores>
int dispatch(int head_dim, const BwdArgs& a, int H, cudaStream_t s) {
  switch (head_dim) {
    case 32: return launch<32, kTensorCores>(a, H, s);
    case 64: return launch<64, kTensorCores>(a, H, s);
    case 128: return launch<128, kTensorCores>(a, H, s);
    default: return -1;
  }
}

}  // namespace

// Returns 0, a cudaError_t from a launch, -1 for a shape the kernels do not
// take (H not a multiple of 64 up to 1024, H / num_heads not in {32, 64,
// 128}, T > 64, a split chunk that is not a multiple of 32 tokens) or -2 for an unknown dtype code
// (0 = float32, 1 = bfloat16). Launches the backward kernel, the split dWo/dbo
// reduction and its finalize pass on `stream`. wot is Wo transposed; attn,
// partial [splits, H, H] and partial_b [splits, H] are scratch.
extern "C" int stlt_fused_proj_attention_bwd(
    const void* x, const void* wqkv, const void* bqkv, const void* wot, const void* bias,
    long long bias_row_stride, long long bias_q_stride, const void* g, const void* rows_live,
    void* dqkv, void* attn, float* partial, float* partial_b, float* dwo, float* dbo, int rows,
    int seq, int hidden, int num_heads, float scale, int dropout, unsigned int seed,
    unsigned int thresh, float dropout_scale, int splits, long long chunk, int dtype,
    void* stream) {
  if (hidden % 64 != 0 || hidden < 64 || hidden > 64 * kMaxNC || num_heads < 1 ||
      hidden % num_heads != 0 || seq < 1 || seq > kTK) {
    return -1;
  }
  if (splits < 1 || chunk % kKM != 0) return -1;
  if (dtype != 0 && dtype != 1) return -2;
  BwdArgs a{x, wqkv, bqkv, wot, static_cast<const float*>(bias), bias_row_stride, bias_q_stride,
            g, static_cast<const uint8_t*>(rows_live), dqkv, attn, rows, seq, num_heads,
            seq > kTM ? 1 : kTM / seq, scale, Dropout{dropout, seed, thresh, dropout_scale}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int head_dim = hidden / num_heads;
  int err = dtype == 1 ? dispatch<true>(head_dim, a, hidden, s) : dispatch<false>(head_dim, a, hidden, s);
  if (err != 0) return err;
  const long long tokens = (long long)rows * seq;
  WoArgs w{attn, g, static_cast<const uint8_t*>(rows_live), partial, partial_b, dwo, dbo,
           tokens, chunk, seq, hidden, splits};
  const int tiles = hidden / kTO;
  const dim3 grid(tiles * tiles, splits);  // a split past the last token writes zeros
  if (dtype == 1) {
    proj_bwd_dwo_tc_kernel<<<grid, kThreads, 0, s>>>(w);
  } else {
    proj_bwd_dwo_kernel<<<grid, kThreads, 0, s>>>(w);
  }
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long long n = (long long)hidden * hidden + hidden;
  proj_bwd_finalize_kernel<<<(int)((n + 255) / 256), 256, 0, s>>>(w);
  return (int)cudaGetLastError();
}
