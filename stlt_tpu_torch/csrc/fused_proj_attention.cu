// Eval self-attention sublayer in one kernel: for each row of x [rows, T, H],
//
//   qkv = x @ Wqkv + bqkv                      (rounded to the compute dtype)
//   o_h = softmax(q_h k_h^T / sqrt(D) + bias) v_h     (f32 logits and softmax)
//   y   = concat_h(o_h) @ Wo + bo              (o_h rounded before the product)
//
// Replaces the TPU kernel stlt_tpu/ops/fused_encoder.py::_fused_proj_attn_kernel
// (launched by fused_proj_attention). The numerics follow its contract; its
// TPU blocking (T padded to 8, whole-grid-resident weights) does not carry over.
//
// Design. One block owns floor(32 / T) rows (32 tokens at the spatial T=8, one
// row of 17 at the temporal T=17) and loops over the heads. Per head it
// projects only that head's q/k/v ([tokens, 64] each) from the x tile held in
// shared memory, runs the attention on chip, and adds o_h @ Wo[hD:(h+1)D, :]
// into an f32 [tokens, H] accumulator kept in registers: the same sum as
// concat-then-project, in another order. Neither qkv nor the attention output
// reaches device memory. Rows whose rows_live flag is 0 write exact zeros; a
// block with no live row skips all compute. The bias is read per row as
// [T, T] or broadcast [1, T] through its strides, never materialised.
//
// The bf16 kernel runs both projections on the tensor cores (WMMA, f32 sums)
// and streams Wqkv and Wo (4.7 MB in bf16 at H = 768, resident in L2)
// through a ring of shared-memory slices with cp.async; the f32 kernel
// multiplies on the SIMT pipes, so f32 stays true f32. The T x T attention
// itself is small (T <= 32) and runs on the SIMT pipes in both.
//
// Bound on this card: at the main-path shapes the work is two GEMMs of
// 2*tokens*H*4H flops against ~2 x 2*tokens*H bytes of activations, far above
// the H100's ~295 flop/byte ridge, so the tensor cores bound it. What holds
// the bf16 kernel back from that bound is the weight traffic from L2: every
// block of 32 tokens reads all of Wqkv and Wo once.
#include <cstdint>

#include "common.cuh"

namespace {

using namespace stlt;
using bf16 = __nv_bfloat16;

constexpr int kD = 64;    // head dim the kernel takes
constexpr int kKT = 16;   // k-slice of Wqkv staged per SIMT step
constexpr int kKTo = 8;   // k-slice (rows) of Wo staged per SIMT step
constexpr int kKS1 = 64;  // rows of Wqkv per streamed slice (tensor cores)
constexpr int kKS2 = 16;  // rows of Wo per streamed slice (tensor cores)

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
  int rows_per_block;
  float scale;
};

// 1 if any of the block's rows is live (no live flags: all are).
__device__ __forceinline__ int block_has_live(const uint8_t* live, int row0, int nrows) {
  __shared__ int any_live;
  if (threadIdx.x == 0) {
    int l = 0;
    for (int r = 0; r < nrows; ++r) l |= live == nullptr || live[row0 + r];
    any_live = l;
  }
  __syncthreads();
  return any_live;
}

// Softmax probabilities of one head for the block's ntok query tokens, into
// p_s [kTM][kTM]: f32 logits q.k * scale + bias over the keys of each
// query's own row, max-subtracted exp, normalised.
__device__ __forceinline__ void head_probs(const ProjArgs& p, const float* q_s, const float* k_s,
                                           float* p_s, int row0, int ntok) {
  const int tid = threadIdx.x, seq = p.seq;
  for (int idx = tid; idx < ntok * seq; idx += kThreads) {
    const int i = idx / seq, s = idx % seq;
    const int lr = i / seq, t = i % seq;
    const float* qi = q_s + i * kD;
    const float* ks = k_s + (lr * seq + s) * kD;
    float dot = 0.f;
#pragma unroll 16
    for (int d = 0; d < kD; ++d) dot = fmaf(qi[d], ks[d], dot);
    const float b = p.bias[(long long)(row0 + lr) * p.bias_row_stride +
                           (long long)t * p.bias_q_stride + s];
    p_s[i * kTM + s] = dot * p.scale + b;
  }
  __syncthreads();
  if (tid < ntok) {
    float* pr = p_s + tid * kTM;
    float m = pr[0];
    for (int s = 1; s < seq; ++s) m = fmaxf(m, pr[s]);
    float sum = 0.f;
    for (int s = 0; s < seq; ++s) {
      const float e = expf(pr[s] - m);
      pr[s] = e;
      sum += e;
    }
    for (int s = 0; s < seq; ++s) pr[s] = pr[s] / sum;
  }
  __syncthreads();
}

// Attention output o[i][d] of query token i (< ntok): probabilities times
// the values of its row.
__device__ __forceinline__ float head_out(const float* p_s, const float* v_s, int i, int d,
                                          int seq) {
  const float* pr = p_s + i * kTM;
  const float* vs = v_s + (i / seq) * seq * kD + d;
  float o = 0.f;
  for (int s = 0; s < seq; ++s) o = fmaf(pr[s], vs[s * kD], o);
  return o;
}

// --- f32: SIMT ----------------------------------------------------------------

template <int NC>
constexpr size_t proj_smem_bytes() {
  constexpr int H = NC * 64;
  return sizeof(float) *
         (size_t)(kTM * H + kKT * 3 * kD + kKTo * H + 4 * kTM * kD + kTM * kTM);
}

template <int NC>
__global__ void __launch_bounds__(kThreads, 1) fused_proj_attn_kernel(ProjArgs p) {
  constexpr int H = NC * 64;
  const float* __restrict__ x = static_cast<const float*>(p.x);
  const float* __restrict__ wqkv = static_cast<const float*>(p.wqkv);
  const float* __restrict__ bqkv = static_cast<const float*>(p.bqkv);
  const float* __restrict__ wo = static_cast<const float*>(p.wo);
  const float* __restrict__ bo = static_cast<const float*>(p.bo);
  float* __restrict__ out = static_cast<float*>(p.out);

  extern __shared__ float smem[];
  float* x_s = smem;                 // [kTM][H]
  float* w_s = x_s + kTM * H;        // [kKT][3 * kD]
  float* wo_s = w_s + kKT * 3 * kD;  // [kKTo][H]
  float* q_s = wo_s + kKTo * H;      // [kTM][kD]
  float* k_s = q_s + kTM * kD;       // [kTM][kD]
  float* v_s = k_s + kTM * kD;       // [kTM][kD]
  float* o_s = v_s + kTM * kD;       // [kTM][kD]
  float* p_s = o_s + kTM * kD;       // [kTM][kTM] logits, then probabilities

  const int tid = threadIdx.x, tx = tid & 63, ty = tid >> 6;
  const int seq = p.seq;
  const int row0 = blockIdx.x * p.rows_per_block;
  const int nrows = min(p.rows_per_block, p.rows - row0);
  const int ntok = nrows * seq;
  const long long tok0 = (long long)row0 * seq;
  if (!block_has_live(p.rows_live, row0, nrows)) {
    for (int i = tid; i < ntok * H; i += kThreads) out[tok0 * H + i] = 0.f;
    return;
  }

  for (int i = tid; i < kTM * H; i += kThreads) x_s[i] = i < ntok * H ? x[tok0 * H + i] : 0.f;

  float acc[kRM][NC];
#pragma unroll
  for (int r = 0; r < kRM; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[r][j] = 0.f;
  __syncthreads();

  for (int h = 0; h < NC; ++h) {  // NC == number of heads, since D == 64
    // q/k/v of head h: thread column tx of block j (0 = q, 1 = k, 2 = v).
    float pq[kRM][3];
#pragma unroll
    for (int r = 0; r < kRM; ++r)
#pragma unroll
      for (int j = 0; j < 3; ++j) pq[r][j] = 0.f;
    for (int k0 = 0; k0 < H; k0 += kKT) {
      for (int i = tid; i < kKT * 3 * kD; i += kThreads) {
        const int kk = i / (3 * kD), c = i % (3 * kD);
        w_s[i] = wqkv[(long long)(k0 + kk) * 3 * H + (c / kD) * H + h * kD + c % kD];
      }
      __syncthreads();
      tile_fma<kRM, 3>(pq, x_s + k0, H, ty * kRM, w_s, 3 * kD, tx, kKT);
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float* dst = j == 0 ? q_s : (j == 1 ? k_s : v_s);
      const float b = bqkv[j * H + h * kD + tx];
#pragma unroll
      for (int r = 0; r < kRM; ++r) dst[(ty * kRM + r) * kD + tx] = pq[r][j] + b;
    }
    __syncthreads();
    head_probs(p, q_s, k_s, p_s, row0, ntok);
    for (int idx = tid; idx < kTM * kD; idx += kThreads) {
      const int i = idx / kD, d = idx % kD;
      o_s[idx] = i < ntok ? head_out(p_s, v_s, i, d, seq) : 0.f;
    }
    __syncthreads();

    // acc += o_h @ Wo[h*D:(h+1)*D, :]
    for (int k0 = 0; k0 < kD; k0 += kKTo) {
      for (int i = tid; i < kKTo * H; i += kThreads) {
        wo_s[i] = wo[(long long)(h * kD + k0) * H + i];
      }
      __syncthreads();
      tile_fma<kRM, NC>(acc, o_s + k0, kD, ty * kRM, wo_s, H, tx, kKTo);
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < kRM; ++r) {
    const int i = ty * kRM + r;
    if (i >= ntok) continue;
    const bool live = p.rows_live == nullptr || p.rows_live[row0 + i / seq];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = tx + 64 * j;
      out[(tok0 + i) * H + c] = live ? acc[r][j] + bo[c] : 0.f;
    }
  }
}

// --- bf16: tensor cores -------------------------------------------------------

template <int NC>
__host__ __device__ constexpr int proj_stage_elems() {
  constexpr int s1 = stage_elems<kKS1, 3 * kD>(), s2 = stage_elems<kKS2, NC * 64>();
  return s1 > s2 ? s1 : s2;
}

template <int NC>
constexpr size_t proj_tc_smem_bytes() {
  constexpr int H = NC * 64;
  return sizeof(bf16) * ((size_t)kTM * ((H + kPad) + (kD + kPad)) + proj_stage_elems<NC>()) +
         sizeof(float) * (size_t)(3 * kTM * kD + kTM * kTM + kWarps * 256);
}

template <int NC>
__global__ void __launch_bounds__(kThreads, 1) fused_proj_attn_tc_kernel(ProjArgs p) {
  using Tile = WarpTile<NC>;
  constexpr int H = NC * 64, LDX = H + kPad, LDO = kD + kPad;
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
  float* q_s = reinterpret_cast<float*>(stages + proj_stage_elems<NC>());  // [kTM][kD]
  float* k_s = q_s + kTM * kD;                    // [kTM][kD]
  float* v_s = k_s + kTM * kD;                    // [kTM][kD]
  float* p_s = v_s + kTM * kD;                    // [kTM][kTM]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* scratch = p_s + kTM * kTM + warp * 256;

  const int seq = p.seq;
  const int row0 = blockIdx.x * p.rows_per_block;
  const int nrows = min(p.rows_per_block, p.rows - row0);
  const int ntok = nrows * seq;
  const long long tok0 = (long long)row0 * seq;
  if (!block_has_live(p.rows_live, row0, nrows)) {
    for (int i = tid; i < ntok * H; i += kThreads) out[tok0 * H + i] = from_float<bf16>(0.f);
    return;
  }

  for (int i = tid; i < kTM * H; i += kThreads) {
    x_s[(i / H) * LDX + i % H] = i < ntok * H ? x[tok0 * H + i] : from_float<bf16>(0.f);
  }
  const int rf0 = Tile::row0(warp), cf0 = Tile::col0(warp);
  FragC acc[Tile::kRF][Tile::kCF];
  zero(acc);
  // This warp's share of one head's q/k/v [kTM, 3 * kD]: row fragment
  // warp / 4, column fragments 3 * (warp % 4) + j.
  const int qrf = warp / 4, qcf0 = 3 * (warp % 4);
  __syncthreads();

  for (int h = 0; h < NC; ++h) {  // NC == number of heads, since D == 64
    FragC qacc[1][3];
    zero(qacc);
    const BCols<3, kD> wqkv_head{{wqkv + h * kD, wqkv + H + h * kD, wqkv + 2 * H + h * kD},
                                 3 * H};
    gemm_streamed<1, 3, kKS1>(qacc, x_s + qrf * 16 * LDX, LDX, wqkv_head, H, stages, qcf0);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      for_each_element(qacc[0][j], scratch, lane, [&](int i, int jj, float v) {
        const int c = (qcf0 + j) * 16 + jj, part = c / kD, d = c % kD;
        float* dst = part == 0 ? q_s : (part == 1 ? k_s : v_s);
        dst[(qrf * 16 + i) * kD + d] = round_to<bf16>(v + to_float(bqkv[part * H + h * kD + d]));
      });
    }
    __syncthreads();
    head_probs(p, q_s, k_s, p_s, row0, ntok);
    for (int idx = tid; idx < kTM * kD; idx += kThreads) {
      const int i = idx / kD, d = idx % kD;
      o_s[i * LDO + d] = from_float<bf16>(i < ntok ? head_out(p_s, v_s, i, d, seq) : 0.f);
    }
    __syncthreads();

    // acc += o_h @ Wo[h*D:(h+1)*D, :]
    const BCols<1, H> wo_head{{wo + (long long)h * kD * H}, H};
    gemm_streamed<Tile::kRF, Tile::kCF, kKS2>(acc, o_s + rf0 * 16 * LDO, LDO, wo_head, kD, stages,
                                              cf0);
  }

#pragma unroll
  for (int r = 0; r < Tile::kRF; ++r) {
#pragma unroll
    for (int j = 0; j < Tile::kCF; ++j) {
      for_each_element(acc[r][j], scratch, lane, [&](int i, int jj, float v) {
        const int row = (rf0 + r) * 16 + i, c = (cf0 + j) * 16 + jj;
        if (row >= ntok) return;
        const bool live = p.rows_live == nullptr || p.rows_live[row0 + row / seq];
        out[(tok0 + row) * H + c] = from_float<bf16>(live ? v + to_float(bo[c]) : 0.f);
      });
    }
  }
}

template <int NC, bool kTensorCores>
int launch(const ProjArgs& a, cudaStream_t stream) {
  auto kernel = kTensorCores ? fused_proj_attn_tc_kernel<NC> : fused_proj_attn_kernel<NC>;
  const size_t smem = kTensorCores ? proj_tc_smem_bytes<NC>() : proj_smem_bytes<NC>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (a.rows + a.rows_per_block - 1) / a.rows_per_block;
  if (grid > 0) kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kTensorCores>
int dispatch(int nc, const ProjArgs& a, cudaStream_t s) {
  switch (nc) {
    case 1: return launch<1, kTensorCores>(a, s);
    case 2: return launch<2, kTensorCores>(a, s);
    case 4: return launch<4, kTensorCores>(a, s);
    case 8: return launch<8, kTensorCores>(a, s);
    case 12: return launch<12, kTensorCores>(a, s);
    case 16: return launch<16, kTensorCores>(a, s);
    default: return -1;
  }
}

}  // namespace

// Returns 0, a cudaError_t from the launch, or -1 for a shape the kernel does
// not take (H not in 64 x {1, 2, 4, 8, 12, 16}, D != 64, T > 32) or -2 for an
// unknown dtype code (0 = float32, 1 = bfloat16).
extern "C" int stlt_fused_proj_attention(
    const void* x, const void* wqkv, const void* bqkv, const void* wo, const void* bo,
    const void* bias, long long bias_row_stride, long long bias_q_stride,
    const void* rows_live, void* out, int rows, int seq, int hidden, int num_heads,
    float scale, int dtype, void* stream) {
  if (hidden % 64 != 0 || hidden / num_heads != kD || seq < 1 || seq > kTM) return -1;
  ProjArgs a{x, wqkv, bqkv, wo, bo, static_cast<const float*>(bias), bias_row_stride,
             bias_q_stride, static_cast<const uint8_t*>(rows_live), out, rows, seq,
             kTM / seq, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<false>(hidden / 64, a, s);
  if (dtype == 1) return dispatch<true>(hidden / 64, a, s);
  return -2;
}
