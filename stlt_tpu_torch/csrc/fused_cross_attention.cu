// Cross-attention sublayer of the fusion models, eval: for each row b of
// x [rows, T, H] (queries) and ctx [rows, S, H] (keys and values),
//
//   q   = x @ Wq + bq, kv = ctx @ Wkv + bkv     (each rounded to the compute dtype)
//   o_h = softmax(q_h k_h^T / sqrt(D) + bias) v_h     (f32 logits and softmax)
//   y   = concat_h(o_h) @ Wo + bo               (o_h rounded before the product)
//
// with Wkv = [Wk | Wv] [H, 2H] and a head-invariant f32 bias [rows or 1,
// T or 1, S] read through its strides. T, S <= 64.
//
// Replaces the TPU kernel stlt_tpu/ops/fused_encoder.py::_fused_cross_attn_kernel
// as launched by fused_cross_attention. The numerics follow its contract; its
// TPU blocking (T and S padded to 8, padded keys at bias -1e9, row blocks with
// the weights resident in VMEM) does not carry over: here the loops stop at
// the real S, so there are no padded keys, and a row whose keys are all masked
// by the caller's -1e9 bias gets finite logits and a finite softmax.
//
// Design. Two kernels behind one entry point, so that the context projection
// is computed once per row even when the queries of a row are split over two
// blocks:
//
// 1. kv_proj: kv = round(ctx @ Wkv + bkv) into a [rows * S, 2H] scratch
//    (written once, read once per head by step 2, mostly from L2). A block
//    owns 32 context tokens (their ctx tile in shared memory) and one slab of
//    128 kv columns;
// 2. cross_attn: a block owns 32 queries of one row (T > 32: two blocks per
//    row, the query split of fused_proj_attention.cu). Its x tile sits in
//    shared memory; per head it projects q_h from the x tile, reads k_h, v_h
//    of its row from the scratch, runs the T x S attention on the SIMT pipes
//    and adds o_h @ Wo[hD:(h+1)D, :] into an f32 [32, H] accumulator in
//    registers: the same sum as concat-then-project, in another order. Neither
//    q nor the attention output reaches device memory.
//
// The bf16 kernels multiply on the tensor cores (WMMA, f32 sums) with Wq,
// Wkv and Wo streamed through the cp.async slice ring of common.cuh; the f32
// kernels multiply on the SIMT pipes, so f32 stays true f32.
//
// Bound on this card: at the fusion models' shapes (B = 32, T = 17 against
// S = 33 and back, H = 768) the work is ~4 * rows * (T + S) * H^2 flops for
// the projections (~3 GFLOP) against ~3 MB of weights and activations: ~1000
// flop/byte, above the H100's ~295 flop/byte ridge, so the tensor cores bound
// it (a few microseconds). What holds this simple kernel back is the grid:
// one block per row and 32 queries (rows x ceil(T / 32) blocks, 32 at B = 32
// on 132 SMs), each streaming all of Wq and Wo from L2, and the kv scratch's
// write and read.
#include <cstdint>

#include "common.cuh"

namespace {

using namespace stlt;
using bf16 = __nv_bfloat16;

constexpr int kD = 64;       // head dim the kernel takes
constexpr int kKT = 16;      // f32: k-slice of Wq / Wkv staged per SIMT step
constexpr int kKTo = 8;      // f32: k-slice (rows) of Wo staged per SIMT step
constexpr int kKS1 = 64;     // bf16: rows of Wq / Wkv per streamed slice
constexpr int kKS2 = 16;     // bf16: rows of Wo per streamed slice
constexpr int kSlab = 128;   // kv columns of one kv_proj block

struct CrossArgs {
  const void* x;
  const void* ctx;
  const void* wq;
  const void* bq;
  const void* wkv;
  const void* bkv;
  const void* wo;
  const void* bo;
  const float* bias;
  long long bias_row_stride;
  long long bias_q_stride;
  void* kv;   // scratch [rows * S, 2H], storage type
  void* out;  // [rows, T, H], storage type
  int rows;
  int tq;  // T, queries of a row
  int skv; // S, keys of a row
  int num_heads;
  float scale;
};

// n (<= kTM) tokens from `src` (row stride H) into a [kTM][ld] tile, zeros
// past n.
template <typename E>
__device__ __forceinline__ void load_tokens(E* dst, int ld, const E* src, int n, int H) {
  for (int i = threadIdx.x; i < kTM * H; i += kThreads) {
    dst[(i / H) * ld + i % H] = i < n * H ? src[i] : from_float<E>(0.f);
  }
}

// k_h and v_h of row b (S keys) from the kv scratch into f32 [kTK][kD] tiles.
template <typename E>
__device__ __forceinline__ void load_kv_head(float* k_s, float* v_s, const E* kv, int b, int h,
                                             int S, int H) {
  for (int idx = threadIdx.x; idx < S * kD; idx += kThreads) {
    const int s = idx / kD, d = idx % kD;
    const E* row = kv + ((long long)b * S + s) * 2 * H + h * kD + d;
    k_s[idx] = to_float(row[0]);
    v_s[idx] = to_float(row[H]);
  }
}

// o_s[i][d] (i < nq, row stride ld) = sum_s softmax(q_i . k_s * scale +
// bias[b, q0 + i, s]) v[s][d], the softmax normalised before the product;
// rows i >= nq are zeros. p_s: [kTM][kTK] f32 scratch.
template <typename E>
__device__ __forceinline__ void head_attention(const CrossArgs& p, int b, int q0, int nq,
                                               const float* q_s, const float* k_s,
                                               const float* v_s, float* p_s, E* o_s, int ld) {
  const int tid = threadIdx.x, S = p.skv;
  for (int idx = tid; idx < nq * S; idx += kThreads) {
    const int i = idx / S, s = idx % S;
    const float* qi = q_s + i * kD;
    const float* ks = k_s + s * kD;
    float dot = 0.f;
#pragma unroll 16
    for (int d = 0; d < kD; ++d) dot = fmaf(qi[d], ks[d], dot);
    const float bias = p.bias[(long long)b * p.bias_row_stride +
                              (long long)(q0 + i) * p.bias_q_stride + s];
    p_s[i * kTK + s] = dot * p.scale + bias;
  }
  __syncthreads();
  if (tid < nq) {
    float* pr = p_s + tid * kTK;
    float m = pr[0];
    for (int s = 1; s < S; ++s) m = fmaxf(m, pr[s]);
    float sum = 0.f;
    for (int s = 0; s < S; ++s) {
      const float e = expf(pr[s] - m);
      pr[s] = e;
      sum += e;
    }
    for (int s = 0; s < S; ++s) pr[s] = pr[s] / sum;
  }
  __syncthreads();
  for (int idx = tid; idx < kTM * kD; idx += kThreads) {
    const int i = idx / kD, d = idx % kD;
    float o = 0.f;
    if (i < nq) {
      const float* pr = p_s + i * kTK;
      for (int s = 0; s < S; ++s) o = fmaf(pr[s], v_s[s * kD + d], o);
    }
    o_s[i * ld + d] = from_float<E>(o);
  }
  __syncthreads();
}

// --- f32: SIMT ----------------------------------------------------------------

template <int NC>
constexpr size_t kv_smem_bytes() {
  return sizeof(float) * (size_t)(kTM * NC * 64 + kKT * kSlab);
}

template <int NC>
__global__ void __launch_bounds__(kThreads, 1) kv_proj_kernel(CrossArgs p) {
  constexpr int H = NC * 64;
  const float* __restrict__ ctx = static_cast<const float*>(p.ctx);
  const float* __restrict__ wkv = static_cast<const float*>(p.wkv);
  const float* __restrict__ bkv = static_cast<const float*>(p.bkv);
  float* __restrict__ kv = static_cast<float*>(p.kv);
  extern __shared__ float smem[];
  float* a_s = smem;            // [kTM][H] ctx tokens
  float* w_s = a_s + kTM * H;   // [kKT][kSlab] slice of Wkv
  const int tid = threadIdx.x, tx = tid & 63, ty = tid >> 6;
  const long long tok0 = (long long)blockIdx.x * kTM;
  const int n = (int)min((long long)kTM, (long long)p.rows * p.skv - tok0);
  const int col0 = blockIdx.y * kSlab;
  load_tokens(a_s, H, ctx + tok0 * H, n, H);
  float acc[kRM][2];
#pragma unroll
  for (int r = 0; r < kRM; ++r) acc[r][0] = acc[r][1] = 0.f;
  __syncthreads();
  for (int k0 = 0; k0 < H; k0 += kKT) {
    for (int i = tid; i < kKT * kSlab; i += kThreads) {
      w_s[i] = wkv[(long long)(k0 + i / kSlab) * 2 * H + col0 + i % kSlab];
    }
    __syncthreads();
    tile_fma<kRM, 2>(acc, a_s + k0, H, ty * kRM, w_s, kSlab, tx, kKT);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kRM; ++r) {
    const int i = ty * kRM + r;
    if (i >= n) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = col0 + tx + 64 * j;
      kv[(tok0 + i) * 2 * H + c] = acc[r][j] + bkv[c];
    }
  }
}

template <int NC>
constexpr size_t cross_smem_bytes() {
  constexpr int H = NC * 64;
  constexpr int w = kKT * kD > kKTo * H ? kKT * kD : kKTo * H;
  return sizeof(float) * (size_t)(kTM * H + w + 2 * kTM * kD + 2 * kTK * kD + kTM * kTK);
}

template <int NC>
__global__ void __launch_bounds__(kThreads, 1) cross_attn_kernel(CrossArgs p) {
  constexpr int H = NC * 64;
  constexpr int W = kKT * kD > kKTo * H ? kKT * kD : kKTo * H;
  const float* __restrict__ x = static_cast<const float*>(p.x);
  const float* __restrict__ wq = static_cast<const float*>(p.wq);
  const float* __restrict__ bq = static_cast<const float*>(p.bq);
  const float* __restrict__ wo = static_cast<const float*>(p.wo);
  const float* __restrict__ bo = static_cast<const float*>(p.bo);
  const float* __restrict__ kv = static_cast<const float*>(p.kv);
  float* __restrict__ out = static_cast<float*>(p.out);

  extern __shared__ float smem[];
  float* x_s = smem;              // [kTM][H]
  float* w_s = x_s + kTM * H;     // [kKT][kD] slices of Wq, then [kKTo][H] of Wo
  float* q_s = w_s + W;           // [kTM][kD]
  float* o_s = q_s + kTM * kD;    // [kTM][kD]
  float* k_s = o_s + kTM * kD;    // [kTK][kD]
  float* v_s = k_s + kTK * kD;    // [kTK][kD]
  float* p_s = v_s + kTK * kD;    // [kTM][kTK]

  const int tid = threadIdx.x, tx = tid & 63, ty = tid >> 6;
  const int chunks = (p.tq + kTM - 1) / kTM;
  const int b = blockIdx.x / chunks, q0 = kTM * (blockIdx.x % chunks);
  const int nq = min(kTM, p.tq - q0);
  const long long tok0 = (long long)b * p.tq + q0;
  load_tokens(x_s, H, x + tok0 * H, nq, H);
  float acc[kRM][NC];
#pragma unroll
  for (int r = 0; r < kRM; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[r][j] = 0.f;
  __syncthreads();

  for (int h = 0; h < NC; ++h) {  // NC == number of heads, since D == 64
    float pq[kRM][1];
#pragma unroll
    for (int r = 0; r < kRM; ++r) pq[r][0] = 0.f;
    for (int k0 = 0; k0 < H; k0 += kKT) {
      for (int i = tid; i < kKT * kD; i += kThreads) {
        w_s[i] = wq[(long long)(k0 + i / kD) * H + h * kD + i % kD];
      }
      __syncthreads();
      tile_fma<kRM, 1>(pq, x_s + k0, H, ty * kRM, w_s, kD, tx, kKT);
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < kRM; ++r) q_s[(ty * kRM + r) * kD + tx] = pq[r][0] + bq[h * kD + tx];
    load_kv_head(k_s, v_s, kv, b, h, p.skv, H);
    __syncthreads();
    head_attention(p, b, q0, nq, q_s, k_s, v_s, p_s, o_s, kD);

    // acc += o_h @ Wo[h*D:(h+1)*D, :]
    for (int k0 = 0; k0 < kD; k0 += kKTo) {
      for (int i = tid; i < kKTo * H; i += kThreads) w_s[i] = wo[(long long)(h * kD + k0) * H + i];
      __syncthreads();
      tile_fma<kRM, NC>(acc, o_s + k0, kD, ty * kRM, w_s, H, tx, kKTo);
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < kRM; ++r) {
    const int i = ty * kRM + r;
    if (i >= nq) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = tx + 64 * j;
      out[(tok0 + i) * H + c] = acc[r][j] + bo[c];
    }
  }
}

// --- bf16: tensor cores -------------------------------------------------------

template <int NC>
constexpr size_t kv_tc_smem_bytes() {
  return sizeof(bf16) * ((size_t)kTM * (NC * 64 + kPad) + stage_elems<kKS1, kSlab>()) +
         sizeof(float) * (size_t)(kWarps * 256);
}

template <int NC>
__global__ void __launch_bounds__(kThreads, 1) kv_proj_tc_kernel(CrossArgs p) {
  constexpr int H = NC * 64, LDX = H + kPad;
  const bf16* __restrict__ ctx = static_cast<const bf16*>(p.ctx);
  const bf16* __restrict__ wkv = static_cast<const bf16*>(p.wkv);
  const bf16* __restrict__ bkv = static_cast<const bf16*>(p.bkv);
  bf16* __restrict__ kv = static_cast<bf16*>(p.kv);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* a_s = reinterpret_cast<bf16*>(smem_raw);  // [kTM][LDX] ctx tokens
  bf16* stages = a_s + kTM * LDX;                 // ring of Wkv slices
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* scratch = reinterpret_cast<float*>(stages + stage_elems<kKS1, kSlab>()) + warp * 256;
  const long long tok0 = (long long)blockIdx.x * kTM;
  const int n = (int)min((long long)kTM, (long long)p.rows * p.skv - tok0);
  const int col0 = blockIdx.y * kSlab;
  load_tokens(a_s, LDX, ctx + tok0 * H, n, H);
  // This warp's share of the [kTM, kSlab] tile: row fragment warp / 4,
  // column fragments 2 * (warp % 4) and the next.
  const int rf = warp / 4, cf0 = 2 * (warp % 4);
  FragC acc[1][2];
  zero(acc);
  const BCols<1, kSlab> slab{{wkv + col0}, 2 * H};
  gemm_streamed<1, 2, kKS1>(acc, a_s + rf * 16 * LDX, LDX, slab, H, stages, cf0);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    for_each_element(acc[0][j], scratch, lane, [&](int i, int jj, float v) {
      const int row = rf * 16 + i, c = col0 + (cf0 + j) * 16 + jj;
      if (row < n) kv[(tok0 + row) * 2 * H + c] = from_float<bf16>(v + to_float(bkv[c]));
    });
  }
}

template <int NC>
__host__ __device__ constexpr int cross_stage_elems() {
  constexpr int s1 = stage_elems<kKS1, kD>(), s2 = stage_elems<kKS2, NC * 64>();
  return s1 > s2 ? s1 : s2;
}

template <int NC>
constexpr size_t cross_tc_smem_bytes() {
  constexpr int H = NC * 64;
  return sizeof(bf16) * ((size_t)kTM * ((H + kPad) + (kD + kPad)) + cross_stage_elems<NC>()) +
         sizeof(float) * (size_t)(kTM * kD + 2 * kTK * kD + kTM * kTK + kWarps * 256);
}

template <int NC>
__global__ void __launch_bounds__(kThreads, 1) cross_attn_tc_kernel(CrossArgs p) {
  using Tile_ = WarpTile<NC>;
  constexpr int H = NC * 64, LDX = H + kPad, LDO = kD + kPad;
  const bf16* __restrict__ x = static_cast<const bf16*>(p.x);
  const bf16* __restrict__ wq = static_cast<const bf16*>(p.wq);
  const bf16* __restrict__ bq = static_cast<const bf16*>(p.bq);
  const bf16* __restrict__ wo = static_cast<const bf16*>(p.wo);
  const bf16* __restrict__ bo = static_cast<const bf16*>(p.bo);
  const bf16* __restrict__ kv = static_cast<const bf16*>(p.kv);
  bf16* __restrict__ out = static_cast<bf16*>(p.out);

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* x_s = reinterpret_cast<bf16*>(smem_raw);  // [kTM][LDX]
  bf16* o_s = x_s + kTM * LDX;                    // [kTM][LDO]: one head's output, rounded
  bf16* stages = o_s + kTM * LDO;                 // ring of Wq / Wo slices
  float* q_s = reinterpret_cast<float*>(stages + cross_stage_elems<NC>());  // [kTM][kD]
  float* k_s = q_s + kTM * kD;                    // [kTK][kD]
  float* v_s = k_s + kTK * kD;                    // [kTK][kD]
  float* p_s = v_s + kTK * kD;                    // [kTM][kTK]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* scratch = p_s + kTM * kTK + warp * 256;

  const int chunks = (p.tq + kTM - 1) / kTM;
  const int b = blockIdx.x / chunks, q0 = kTM * (blockIdx.x % chunks);
  const int nq = min(kTM, p.tq - q0);
  const long long tok0 = (long long)b * p.tq + q0;
  load_tokens(x_s, LDX, x + tok0 * H, nq, H);
  const int rf0 = Tile_::row0(warp), cf0 = Tile_::col0(warp);
  FragC acc[Tile_::kRF][Tile_::kCF];
  zero(acc);
  // This warp's share of q_h [kTM, kD]: row fragment warp / 4, column
  // fragment warp % 4.
  const int qrf = warp / 4, qcf = warp % 4;

  for (int h = 0; h < NC; ++h) {  // NC == number of heads, since D == 64
    // gemm_streamed synchronises the block before it reads x_s and after.
    FragC qacc[1][1];
    zero(qacc);
    const BCols<1, kD> wq_head{{wq + h * kD}, H};
    gemm_streamed<1, 1, kKS1>(qacc, x_s + qrf * 16 * LDX, LDX, wq_head, H, stages, qcf);
    for_each_element(qacc[0][0], scratch, lane, [&](int i, int jj, float v) {
      const int d = qcf * 16 + jj;
      q_s[(qrf * 16 + i) * kD + d] = round_to<bf16>(v + to_float(bq[h * kD + d]));
    });
    load_kv_head(k_s, v_s, kv, b, h, p.skv, H);
    __syncthreads();
    head_attention(p, b, q0, nq, q_s, k_s, v_s, p_s, o_s, LDO);

    // acc += o_h @ Wo[h*D:(h+1)*D, :]
    const BCols<1, H> wo_head{{wo + (long long)h * kD * H}, H};
    gemm_streamed<Tile_::kRF, Tile_::kCF, kKS2>(acc, o_s + rf0 * 16 * LDO, LDO, wo_head, kD,
                                                stages, cf0);
  }

#pragma unroll
  for (int r = 0; r < Tile_::kRF; ++r) {
#pragma unroll
    for (int j = 0; j < Tile_::kCF; ++j) {
      for_each_element(acc[r][j], scratch, lane, [&](int i, int jj, float v) {
        const int row = (rf0 + r) * 16 + i, c = (cf0 + j) * 16 + jj;
        if (row < nq) out[(tok0 + row) * H + c] = from_float<bf16>(v + to_float(bo[c]));
      });
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int NC, bool kTensorCores>
int launch(const CrossArgs& a, cudaStream_t stream) {
  auto kv_kernel = kTensorCores ? kv_proj_tc_kernel<NC> : kv_proj_kernel<NC>;
  auto attn_kernel = kTensorCores ? cross_attn_tc_kernel<NC> : cross_attn_kernel<NC>;
  const size_t kv_smem = kTensorCores ? kv_tc_smem_bytes<NC>() : kv_smem_bytes<NC>();
  const size_t attn_smem = kTensorCores ? cross_tc_smem_bytes<NC>() : cross_smem_bytes<NC>();
  cudaError_t err = set_smem(kv_kernel, kv_smem);
  if (err == cudaSuccess) err = set_smem(attn_kernel, attn_smem);
  if (err != cudaSuccess) return (int)err;
  const long long kv_tiles = ((long long)a.rows * a.skv + kTM - 1) / kTM;
  const long long attn_blocks = (long long)a.rows * ((a.tq + kTM - 1) / kTM);
  if (kv_tiles > 0x7fffffffLL || attn_blocks > 0x7fffffffLL) return -1;
  if (a.rows > 0) {
    kv_kernel<<<dim3((unsigned)kv_tiles, 2 * NC * 64 / kSlab), kThreads, kv_smem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    attn_kernel<<<(unsigned)attn_blocks, kThreads, attn_smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <bool kTensorCores>
int dispatch(int nc, const CrossArgs& a, cudaStream_t s) {
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

// Returns 0, a cudaError_t from a launch, -1 for a shape the kernels do not
// take (H not in 64 x {1, 2, 4, 8, 12, 16}, D != 64, T or S outside 1..64) or
// -2 for an unknown dtype code (0 = float32, 1 = bfloat16). kv is the
// caller's [rows * S, 2H] scratch in the storage type.
extern "C" int stlt_fused_cross_attention(
    const void* x, const void* ctx, const void* wq, const void* bq, const void* wkv,
    const void* bkv, const void* wo, const void* bo, const void* bias,
    long long bias_row_stride, long long bias_q_stride, void* kv, void* out, int rows, int tq,
    int skv, int hidden, int num_heads, float scale, int dtype, void* stream) {
  if (hidden % 64 != 0 || num_heads < 1 || hidden / num_heads != kD || hidden % num_heads != 0 ||
      tq < 1 || tq > kTK || skv < 1 || skv > kTK || rows < 0) {
    return -1;
  }
  CrossArgs a{x, ctx, wq, bq, wkv, bkv, wo, bo, static_cast<const float*>(bias), bias_row_stride,
              bias_q_stride, kv, out, rows, tq, skv, num_heads, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<false>(hidden / 64, a, s);
  if (dtype == 1) return dispatch<true>(hidden / 64, a, s);
  return -2;
}
