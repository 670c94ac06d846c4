// Self-attention sublayer in one kernel: for each row of x [rows, T, H],
//
//   qkv = x @ Wqkv + bqkv                      (rounded to the compute dtype)
//   o_h = softmax(q_h k_h^T / sqrt(D) + bias) v_h     (f32 logits and softmax)
//   y   = concat_h(o_h) @ Wo + bo              (o_h rounded before the product)
//
// Replaces the TPU kernel stlt_tpu/ops/fused_encoder.py::_fused_proj_attn_kernel,
// both as launched by fused_proj_attention (eval) and by _fused_proj_train_fwd
// (train, with `prng`): with dropout on, each probability is multiplied by
// keep * 1/(1-rate) before the product with v, the keep bit hashed in place
// from (seed, global row, head, t, s) exactly as _keep_block does, so the
// backward kernel (fused_proj_attention_bwd.cu) and the plain version
// regenerate the same bits. The numerics follow the TPU kernel's contract;
// its TPU blocking (T padded to 8, whole-grid-resident weights) does not
// carry over.
//
// Design. For T <= 32 one block owns floor(32 / T) rows (32 tokens at the
// spatial T=8, one row of 17 at the temporal T=17). For 32 < T <= 64 a block
// owns the 32 queries of one half of one row and all T keys of that row; it
// projects the row's keys in two 32-token chunks through the same x tile.
// Per head the block projects only that head's q/k/v ([tokens, D] each)
// from the x tile, runs the attention on chip, and adds
// o_h @ Wo[hD:(h+1)D, :] into an f32 [32, H] accumulator kept in registers:
// the same sum as concat-then-project, in another order. Neither qkv nor
// the attention output reaches device memory. Rows whose rows_live flag is 0
// write exact zeros; a block with no live row skips all compute. The bias is
// read per row as [T, T] or broadcast [1, T] through its strides, never
// materialised.
//
// Widths. The head dim D (32, 64 or 128) is a template argument; H (any
// multiple of 64 up to 1024, N = H / D heads) is a runtime value: the
// accumulator is sized for H <= 768 or for H = 1024 and a column past H is
// skipped, so two instantiations serve every width. The bf16 kernel is also
// instantiated at the reference width (HC = 768, D = 64) with H a
// compile-time constant: there its indices fold and both GEMMs run
// gemm_streamed with no per-fragment guard, as before H became a runtime
// value (the runtime-width kernel measured slower there, PERF.md §6). Shared memory at the widest shapes
// (H = 1024): the f32 kernel stages x in 16-column slices beside the weight
// slices (141,312 bytes at D = 128); the bf16 kernel holds the bf16 x tile,
// keeps q/k/v in f32 (bf16 at D = 128, common.cuh's QkvType) and lays the
// probabilities over the weight ring between the GEMMs, with Wqkv slices of
// 64 rows at D <= 64 and 32 at D = 128 (218,880 bytes at D = 64, 222,976 at
// D = 128, of the 232,448 a block may take).
//
// The bf16 kernel runs both projections on the tensor cores (WMMA, f32 sums)
// and streams Wqkv and Wo (4.7 MB in bf16 at H = 768, resident in L2)
// through a ring of shared-memory slices with cp.async; the f32 kernel
// multiplies on the SIMT pipes, so f32 stays true f32. The T x T attention
// itself is small (T <= 64) and runs on the SIMT pipes in both.
//
// Bound on this card: at the main-path shapes the work is two GEMMs of
// 2*tokens*H*4H flops against ~2 x 2*tokens*H bytes of activations, far above
// the H100's ~295 flop/byte ridge, so the tensor cores bound it. What holds
// the bf16 kernel back from that bound is the weight traffic from L2: every
// block of 32 tokens reads all of Wqkv and Wo once (twice the Wqkv k/v
// columns for T > 32, whose keys span two chunks).
#include <cstdint>

#include "common.cuh"

namespace {

using namespace stlt;
using bf16 = __nv_bfloat16;

constexpr int kKT = 16;   // f32: k-slice of x and Wqkv staged per SIMT step
constexpr int kKTo = 8;   // f32: k-slice (rows) of Wo staged per SIMT step
constexpr int kKS2 = 16;  // bf16: rows of Wo per streamed slice
// bf16: the output accumulator's column fragments a warp, sized for H <= 768
// (the reference width: 6, 96 registers) or for H <= 1024 (8, 128 registers,
// with a few spilled ones).
constexpr int kOutCF768 = 4 * 12 / kWarps, kOutCFMax = 4 * kMaxNC / kWarps;

__host__ __device__ constexpr int out_cf(int H) { return H <= 768 ? kOutCF768 : kOutCFMax; }

// bf16: rows of Wqkv per streamed slice.
template <int D>
__host__ __device__ constexpr int qkv_slice_rows() {
  return D > 64 ? 32 : 64;
}

struct ProjArgs {
  const void* x;
  const void* wqkv;
  const void* bqkv;
  const void* wo;
  const void* bo;
  const float* bias;
  long long bias_row_stride;
  long long bias_q_stride;
  const uint8_t* rows_live;
  void* out;
  int rows;
  int seq;
  int hidden;
  int num_heads;
  int rows_per_block;  // T <= 32: rows of one block; T > 32: 1
  float scale;
  Dropout drop;
};

// T > 32: kKeyChunks blocks (query halves) per row, each projecting the
// row's keys in kKeyChunks chunks of kTM tokens.
constexpr int kKeyChunks = kTK / kTM;

// The tokens one block works on. Its key tile holds nkv tokens (nrows whole
// rows) from token tok0; its queries are the nq tokens from q0 of that tile.
struct Tile {
  int row0, nrows, nkv, q0, nq;
  long long tok0;
};

template <bool kChunked>
__device__ __forceinline__ Tile block_tile(const ProjArgs& p) {
  Tile t;
  if (!kChunked) {
    t.row0 = blockIdx.x * p.rows_per_block;
    t.nrows = min(p.rows_per_block, p.rows - t.row0);
    t.nkv = t.nrows * p.seq;
    t.q0 = 0;
    t.nq = t.nkv;
  } else {
    t.row0 = blockIdx.x / kKeyChunks;
    t.nrows = 1;
    t.nkv = p.seq;
    t.q0 = kTM * (blockIdx.x % kKeyChunks);
    t.nq = min(kTM, p.seq - t.q0);
  }
  t.tok0 = (long long)t.row0 * p.seq;
  return t;
}

// Softmax probabilities of head h for the block's nq queries, into
// p_s [kTM][kTK]: f32 logits q.k * scale + bias over the keys of each
// query's own row, max-subtracted exp, normalised, then (kDrop) dropped.
// q_s [kTM][D] and k_s [kTK][D] hold f32 (f32 kernel) or bf16 values.
template <int D, bool kDrop, typename QE>
__device__ __forceinline__ void head_probs(const ProjArgs& p, const Tile& tl, int h,
                                           const QE* q_s, const QE* k_s, float* p_s) {
  const int tid = threadIdx.x, seq = p.seq;
  for (int idx = tid; idx < tl.nq * seq; idx += kThreads) {
    const int i = idx / seq, s = idx % seq;
    const int tok = tl.q0 + i, lr = tok / seq, t = tok % seq;
    const QE* qi = q_s + i * D;
    const QE* ks = k_s + (lr * seq + s) * D;
    float dot = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) dot = fmaf(to_float(qi[d]), to_float(ks[d]), dot);
    const float b = p.bias[(long long)(tl.row0 + lr) * p.bias_row_stride +
                           (long long)t * p.bias_q_stride + s];
    p_s[i * kTK + s] = dot * p.scale + b;
  }
  __syncthreads();
  if (tid < tl.nq) {
    const int tok = tl.q0 + tid, lr = tok / seq, t = tok % seq;
    float* pr = p_s + tid * kTK;
    float m = pr[0];
    for (int s = 1; s < seq; ++s) m = fmaxf(m, pr[s]);
    float sum = 0.f;
    for (int s = 0; s < seq; ++s) {
      const float e = expf(pr[s] - m);
      pr[s] = e;
      sum += e;
    }
    for (int s = 0; s < seq; ++s) pr[s] = pr[s] / sum;
    if (kDrop) {
      for (int s = 0; s < seq; ++s) {
        pr[s] *= p.drop.keep_scale(tl.row0 + lr, h, p.num_heads, t, s, seq);
      }
    }
  }
  __syncthreads();
}

// Attention output o[i][d] of query i (< nq): probabilities times the
// values of its row.
template <int D, typename QE>
__device__ __forceinline__ float head_out(const float* p_s, const QE* v_s, const Tile& tl, int i,
                                          int d, int seq) {
  const float* pr = p_s + i * kTK;
  const QE* vs = v_s + ((tl.q0 + i) / seq) * seq * D + d;
  float o = 0.f;
  for (int s = 0; s < seq; ++s) o = fmaf(pr[s], to_float(vs[s * D]), o);
  return o;
}

// Key-tile chunk c (kTM tokens from token kTM * c) of x into x_s (row stride
// ld), zero-padded past the tile.
template <typename E>
__device__ __forceinline__ void load_x_chunk(E* x_s, int ld, const E* x, const Tile& tl, int c,
                                             int H) {
  copy_rows(x_s, ld, x + (tl.tok0 + kTM * c) * H, H, min(kTM, tl.nkv - kTM * c), kTM, H);
}

// --- f32: SIMT ----------------------------------------------------------------

template <int D>
size_t proj_smem_bytes(int H) {
  const int w = kKT * 3 * D > kKTo * H ? kKT * 3 * D : kKTo * H;
  return sizeof(float) * (size_t)(kTM * kKT + w + 2 * kTM * D + 2 * kTK * D + kTM * kTK);
}

// kChunked: T > 32 (a block takes one query half of one row); kDrop: the
// train forward's probability dropout. Both are template flags so that the
// eval kernel at T <= 32 carries neither's registers.
template <int D, bool kChunked, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1) fused_proj_attn_kernel(ProjArgs p) {
  constexpr int kQJ = (3 * D + 63) / 64;  // q/k/v columns of a thread, 64 apart
  const int H = p.hidden, nc = H / 64;
  const int W = kKT * 3 * D > kKTo * H ? kKT * 3 * D : kKTo * H;
  const float* __restrict__ x = static_cast<const float*>(p.x);
  const float* __restrict__ wqkv = static_cast<const float*>(p.wqkv);
  const float* __restrict__ bqkv = static_cast<const float*>(p.bqkv);
  const float* __restrict__ wo = static_cast<const float*>(p.wo);
  const float* __restrict__ bo = static_cast<const float*>(p.bo);
  float* __restrict__ out = static_cast<float*>(p.out);

  extern __shared__ float smem[];
  float* x_sl = smem;              // [kTM][kKT] slice of the x chunk
  float* w_s = x_sl + kTM * kKT;   // [kKT][3 * D] slices of Wqkv, then
  float* wo_s = w_s;               // [kKTo][H] slices of Wo
  float* q_s = w_s + W;            // [kTM][D]
  float* o_s = q_s + kTM * D;      // [kTM][D]
  float* k_s = o_s + kTM * D;      // [kTK][D]
  float* v_s = k_s + kTK * D;      // [kTK][D]
  float* p_s = v_s + kTK * D;      // [kTM][kTK] logits, then probabilities

  const int tid = threadIdx.x, tx = tid & 63, ty = tid >> 6;
  const int seq = p.seq;
  const Tile tl = block_tile<kChunked>(p);
  constexpr int nchunks = kChunked ? kKeyChunks : 1;
  const int qchunk = kChunked ? tl.q0 / kTM : 0;
  if (!block_has_live(p.rows_live, tl.row0, tl.nrows)) {
    for (int i = tid; i < tl.nq * H; i += kThreads) out[(tl.tok0 + tl.q0) * H + i] = 0.f;
    return;
  }

  float acc[kRM][kMaxNC];
#pragma unroll
  for (int r = 0; r < kRM; ++r)
#pragma unroll
    for (int j = 0; j < kMaxNC; ++j) acc[r][j] = 0.f;

  for (int h = 0; h < p.num_heads; ++h) {
#pragma unroll 1
    for (int c = 0; c < nchunks; ++c) {
      const int ntok = min(kTM, tl.nkv - kTM * c);
      const float* xc = x + (tl.tok0 + kTM * c) * H;
      // q/k/v of head h: thread column tx + 64 j of the head's [3 D] columns.
      float pq[kRM][kQJ];
#pragma unroll
      for (int r = 0; r < kRM; ++r)
#pragma unroll
        for (int j = 0; j < kQJ; ++j) pq[r][j] = 0.f;
      for (int k0 = 0; k0 < H; k0 += kKT) {
        for (int i = tid; i < kTM * kKT; i += kThreads) {
          const int r = i / kKT;
          x_sl[i] = r < ntok ? xc[(long long)r * H + k0 + i % kKT] : 0.f;
        }
        for (int i = tid; i < kKT * 3 * D; i += kThreads) {
          const int kk = i / (3 * D), cc = i % (3 * D);
          w_s[i] = wqkv[(long long)(k0 + kk) * 3 * H + (cc / D) * H + h * D + cc % D];
        }
        __syncthreads();
        // Columns past 3 D (D = 32) read the next slice row and are dropped.
        tile_fma<kRM, kQJ>(pq, x_sl, kKT, ty * kRM, w_s, 3 * D, tx, kKT);
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < kQJ; ++j) {
        const int cc = tx + 64 * j, part = cc / D, d = cc % D;
        if (cc >= 3 * D || (part == 0 && c != qchunk)) continue;
        float* dst = part == 0 ? q_s : (part == 1 ? k_s + c * kTM * D : v_s + c * kTM * D);
        const float b = bqkv[part * H + h * D + d];
#pragma unroll
        for (int r = 0; r < kRM; ++r) dst[(ty * kRM + r) * D + d] = pq[r][j] + b;
      }
    }
    __syncthreads();
    head_probs<D, kDrop>(p, tl, h, q_s, k_s, p_s);
    for (int idx = tid; idx < kTM * D; idx += kThreads) {
      const int i = idx / D, d = idx % D;
      o_s[idx] = i < tl.nq ? head_out<D>(p_s, v_s, tl, i, d, seq) : 0.f;
    }
    __syncthreads();

    // acc += o_h @ Wo[h*D:(h+1)*D, :]
    for (int k0 = 0; k0 < D; k0 += kKTo) {
      for (int i = tid; i < kKTo * H; i += kThreads) {
        wo_s[i] = wo[(long long)(h * D + k0) * H + i];
      }
      __syncthreads();
      tile_fma<kRM, kMaxNC>(acc, o_s + k0, D, ty * kRM, wo_s, H, tx, kKTo, nc);
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < kRM; ++r) {
    const int i = ty * kRM + r;
    if (i >= tl.nq) continue;
    const bool live = p.rows_live == nullptr || p.rows_live[tl.row0 + (tl.q0 + i) / seq];
#pragma unroll
    for (int j = 0; j < kMaxNC; ++j) {
      const int c = tx + 64 * j;
      if (j < nc) out[(tl.tok0 + tl.q0 + i) * H + c] = live ? acc[r][j] + bo[c] : 0.f;
    }
  }
}

// --- bf16: tensor cores -------------------------------------------------------

template <int D>
__host__ __device__ int proj_ring_elems(int H) {
  const int s1 = ring_elems(qkv_slice_rows<D>(), 3 * D), s2 = ring_elems(kKS2, H);
  return s1 > s2 ? s1 : s2;
}

template <int D>
size_t proj_tc_smem_bytes(int H) {
  return sizeof(bf16) * ((size_t)kTM * ((H + kPad) + (D + kPad)) + proj_ring_elems<D>(H)) +
         sizeof(typename QkvType<D>::type) * (size_t)(kTM + 2 * kTK) * D +
         sizeof(float) * (size_t)kWarps * 256;
}

// HC: H at compile time (kRefHidden), or 0 for H from the arguments.
template <int D, int HC, int OCF, bool kChunked, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1) fused_proj_attn_tc_kernel(ProjArgs p) {
  constexpr int LDO = D + kPad, kKS1 = qkv_slice_rows<D>();
  // One head's q/k/v [kTM, 3 D] has kQF column fragments. Where they split
  // evenly over the four warps of a row fragment (D = 64, 128), a warp owns
  // a run of kQCF of them, else (D = 32) kQCF fragments 4 apart.
  constexpr int kQF = 3 * D / 16, kQCF = (kQF + 3) / 4;
  constexpr bool kQRun = kQF % 4 == 0;
  static_assert(HC == 0 || HC / 16 == kWarps * OCF, "a compile-time width splits evenly");
  using QE = typename QkvType<D>::type;
  const int H = HC > 0 ? HC : p.hidden, LDX = H + kPad;
  const int num_heads = HC > 0 ? HC / D : p.num_heads;
  const bf16* __restrict__ x = static_cast<const bf16*>(p.x);
  const bf16* __restrict__ wqkv = static_cast<const bf16*>(p.wqkv);
  const bf16* __restrict__ bqkv = static_cast<const bf16*>(p.bqkv);
  const bf16* __restrict__ wo = static_cast<const bf16*>(p.wo);
  const bf16* __restrict__ bo = static_cast<const bf16*>(p.bo);
  bf16* __restrict__ out = static_cast<bf16*>(p.out);

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* x_s = reinterpret_cast<bf16*>(smem_raw);  // [kTM][LDX]
  bf16* o_s = x_s + kTM * LDX;                    // [kTM][LDO]: one head's output, rounded
  bf16* stages = o_s + kTM * LDO;                 // ring of Wqkv / Wo slices
  QE* q_s = reinterpret_cast<QE*>(stages + proj_ring_elems<D>(H));  // [kTM][D], rounded
  QE* k_s = q_s + kTM * D;                                          // [kTK][D]
  QE* v_s = k_s + kTK * D;                                          // [kTK][D]
  // [kTM][kTK] probabilities, over the ring: they live between the GEMMs.
  float* p_s = reinterpret_cast<float*>(stages);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* scratch = reinterpret_cast<float*>(v_s + kTK * D) + warp * 256;

  const int seq = p.seq;
  const Tile tl = block_tile<kChunked>(p);
  constexpr int nchunks = kChunked ? kKeyChunks : 1;
  const int qchunk = kChunked ? tl.q0 / kTM : 0;
  if (!block_has_live(p.rows_live, tl.row0, tl.nrows)) {
    for (int i = tid; i < tl.nq * H; i += kThreads) {
      out[(tl.tok0 + tl.q0) * H + i] = from_float<bf16>(0.f);
    }
    return;
  }

  if (!kChunked) load_x_chunk(x_s, LDX, x, tl, 0, H);
  // The output [kTM, H]: both row fragments and the warp's run of column
  // fragments, ocf0 + j (H / 128 of them, the last warps' runs cut at H).
  const int per_warp = (H / 16 + kWarps - 1) / kWarps, ocf0 = warp * per_warp;
  FragC acc[2][OCF];
  zero(acc);
  // This warp's share of one head's q/k/v: row fragment warp / 4, column
  // fragments qcf0 + qstep j.
  constexpr int qstep = kQRun ? 1 : 4;
  const int qrf = warp / 4, qcf0 = (warp % 4) * (kQRun ? kQCF : 1);
  __syncthreads();

  for (int h = 0; h < num_heads; ++h) {
    const BCols<3, D> wqkv_head{{wqkv + h * D, wqkv + H + h * D, wqkv + 2 * H + h * D}, 3 * H};
#pragma unroll 1
    for (int c = 0; c < nchunks; ++c) {
      // gemm_ring synchronises the block before it reads x_s and after.
      if (kChunked) load_x_chunk(x_s, LDX, x, tl, c, H);
      FragC qacc[1][kQCF];
      zero(qacc);
      if constexpr (kQRun) {
        gemm_streamed<1, kQCF, kKS1>(qacc, x_s + qrf * 16 * LDX, LDX, wqkv_head, H, stages, qcf0);
      } else {
        gemm_ring<1, kQCF, kKS1>(qacc, x_s + qrf * 16 * LDX, LDX, wqkv_head, H, stages, qcf0, qstep);
      }
#pragma unroll
      for (int j = 0; j < kQCF; ++j) {
        const int cf = qcf0 + qstep * j;
        if (!kQRun && cf >= kQF) continue;  // uniform over the warp
        for_each_element(qacc[0][j], scratch, lane, [&](int i, int jj, float v) {
          const int cc = cf * 16 + jj, part = cc / D, d = cc % D;
          const QE val = from_float<QE>(round_to<bf16>(v + to_float(bqkv[part * H + h * D + d])));
          if (part == 0) {
            if (c == qchunk) q_s[(qrf * 16 + i) * D + d] = val;
          } else {
            (part == 1 ? k_s : v_s)[(c * kTM + qrf * 16 + i) * D + d] = val;
          }
        });
      }
    }
    __syncthreads();
    head_probs<D, kDrop>(p, tl, h, q_s, k_s, p_s);
    for (int idx = tid; idx < kTM * D; idx += kThreads) {
      const int i = idx / D, d = idx % D;
      o_s[i * LDO + d] = from_float<bf16>(i < tl.nq ? head_out<D>(p_s, v_s, tl, i, d, seq) : 0.f);
    }
    __syncthreads();

    // acc += o_h @ Wo[h*D:(h+1)*D, :]
    if constexpr (HC > 0) {
      const BCols<1, HC> wo_head{{wo + (long long)h * D * H}, H};
      gemm_streamed<2, OCF, kKS2>(acc, o_s, LDO, wo_head, D, stages, ocf0);
    } else {
      const BWide wo_head{wo + (long long)h * D * H, H, H};
      gemm_ring<2, OCF, kKS2>(acc, o_s, LDO, wo_head, D, stages, ocf0, 1, per_warp);
    }
  }

  const int ncf = H / 16;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int j = 0; j < OCF; ++j) {
      const int cf = ocf0 + j;
      if (HC == 0 && (j >= per_warp || cf >= ncf)) continue;  // uniform over the warp
      for_each_element(acc[r][j], scratch, lane, [&](int i, int jj, float v) {
        const int row = r * 16 + i, c = cf * 16 + jj;
        if (row >= tl.nq) return;
        const bool live = p.rows_live == nullptr || p.rows_live[tl.row0 + (tl.q0 + row) / seq];
        out[(tl.tok0 + tl.q0 + row) * H + c] = from_float<bf16>(live ? v + to_float(bo[c]) : 0.f);
      });
    }
  }
}

template <int D, int HC, int OCF, bool kTensorCores, bool kChunked, bool kDrop>
int launch(const ProjArgs& a, cudaStream_t stream) {
  auto kernel = kTensorCores ? fused_proj_attn_tc_kernel<D, HC, OCF, kChunked, kDrop>
                             : fused_proj_attn_kernel<D, kChunked, kDrop>;
  const size_t smem = kTensorCores ? proj_tc_smem_bytes<D>(a.hidden) : proj_smem_bytes<D>(a.hidden);
  if (smem > kMaxSmem) return -1;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = kChunked ? a.rows * kKeyChunks
                            : (a.rows + a.rows_per_block - 1) / a.rows_per_block;
  if (grid > 0) kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D, int HC, int OCF, bool kTensorCores>
int launch_flags(const ProjArgs& a, cudaStream_t s) {
  const bool chunked = a.seq > kTM, drop = a.drop.on;
  if (chunked) {
    return drop ? launch<D, HC, OCF, kTensorCores, true, true>(a, s)
                : launch<D, HC, OCF, kTensorCores, true, false>(a, s);
  }
  return drop ? launch<D, HC, OCF, kTensorCores, false, true>(a, s)
              : launch<D, HC, OCF, kTensorCores, false, false>(a, s);
}

template <int D, bool kTensorCores>
int launch_variant(const ProjArgs& a, cudaStream_t s) {
  if constexpr (kTensorCores && D == kRefHeadDim) {
    if (a.hidden == kRefHidden) return launch_flags<D, kRefHidden, kOutCF768, true>(a, s);
  }
  if (kTensorCores && out_cf(a.hidden) == kOutCF768) return launch_flags<D, 0, kOutCF768, true>(a, s);
  return launch_flags<D, 0, kOutCFMax, kTensorCores>(a, s);
}

template <bool kTensorCores>
int dispatch(int head_dim, const ProjArgs& a, cudaStream_t s) {
  switch (head_dim) {
    case 32: return launch_variant<32, kTensorCores>(a, s);
    case 64: return launch_variant<64, kTensorCores>(a, s);
    case 128: return launch_variant<128, kTensorCores>(a, s);
    default: return -1;
  }
}

}  // namespace

// Returns 0, a cudaError_t from the launch, or -1 for a shape the kernel does
// not take (H not a multiple of 64 up to 1024, H / num_heads not in {32, 64,
// 128}, T > 64) or -2 for an unknown dtype code (0 = float32, 1 = bfloat16).
// dropout = 0 is the eval kernel; otherwise probabilities are dropped with
// (seed, thresh) and kept ones scaled by dropout_scale.
extern "C" int stlt_fused_proj_attention(
    const void* x, const void* wqkv, const void* bqkv, const void* wo, const void* bo,
    const void* bias, long long bias_row_stride, long long bias_q_stride,
    const void* rows_live, void* out, int rows, int seq, int hidden, int num_heads,
    float scale, int dropout, unsigned int seed, unsigned int thresh, float dropout_scale,
    int dtype, void* stream) {
  if (hidden % 64 != 0 || hidden < 64 || hidden > 64 * kMaxNC || num_heads < 1 ||
      hidden % num_heads != 0 || seq < 1 || seq > kTK) {
    return -1;
  }
  ProjArgs a{x, wqkv, bqkv, wo, bo, static_cast<const float*>(bias), bias_row_stride,
             bias_q_stride, static_cast<const uint8_t*>(rows_live), out, rows, seq, hidden,
             num_heads, seq > kTM ? 1 : kTM / seq, scale,
             Dropout{dropout, seed, thresh, dropout_scale}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<false>(hidden / num_heads, a, s);
  if (dtype == 1) return dispatch<true>(hidden / num_heads, a, s);
  return -2;
}
