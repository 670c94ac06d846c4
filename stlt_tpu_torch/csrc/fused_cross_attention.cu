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
// Widths, as in fused_proj_attention.cu: the head dim D (32, 64 or 128) is a
// template argument of cross_attn, H (a multiple of 64 up to 1024) a runtime
// value of both kernels; the f32 cross_attn stages x in 16-column slices, the
// bf16 one keeps k_h and v_h in f32 (bf16 at D = 128) and the probabilities
// over its weight ring (231,168 bytes of shared memory at D = 128, H = 1024).
// The bf16 cross_attn is also instantiated at the reference width (H = 768,
// D = 64) with H at compile time, its GEMMs on gemm_streamed (the
// runtime-width kernel measured slower there, PERF.md §6).
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

constexpr int kKT = 16;      // f32: k-slice of x, Wq, Wkv staged per SIMT step
constexpr int kKTo = 8;      // f32: k-slice (rows) of Wo staged per SIMT step
constexpr int kKS1 = 64;     // bf16: rows of Wq / Wkv per streamed slice
constexpr int kKS2 = 16;     // bf16: rows of Wo per streamed slice
constexpr int kSlab = 128;   // kv columns of one kv_proj block
// bf16: the output accumulator's column fragments a warp, sized for H <= 768
// (6) or for H <= 1024 (8), as in fused_proj_attention.cu.
constexpr int kOutCF768 = 4 * 12 / kWarps, kOutCFMax = 4 * kMaxNC / kWarps;

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
  int hidden;
  int num_heads;
  float scale;
};

// n (<= kTM) tokens from `src` (row stride H) into a [kTM][ld] tile, zeros
// past n.
template <typename E>
__device__ __forceinline__ void load_tokens(E* dst, int ld, const E* src, int n, int H) {
  copy_rows(dst, ld, src, H, n, kTM, H);
}

// k_h and v_h of row b (S keys) from the kv scratch (rounded to the storage
// type E) into [kTK][D] tiles of type KE.
template <int D, typename KE, typename E>
__device__ __forceinline__ void load_kv_head(KE* k_s, KE* v_s, const E* kv, int b, int h, int S,
                                             int H) {
  for (int idx = threadIdx.x; idx < S * D; idx += kThreads) {
    const int s = idx / D, d = idx % D;
    const E* row = kv + ((long long)b * S + s) * 2 * H + h * D + d;
    k_s[idx] = from_float<KE>(to_float(row[0]));
    v_s[idx] = from_float<KE>(to_float(row[H]));
  }
}

// o_s[i][d] (i < nq, row stride ld) = sum_s softmax(q_i . k_s * scale +
// bias[b, q0 + i, s]) v[s][d], the softmax normalised before the product;
// rows i >= nq are zeros. q_s holds f32 values (rounded to the storage type
// where the contract rounds), k_s and v_s type KE. p_s: [kTM][kTK] f32
// scratch; o_s the storage type E.
template <int D, typename KE, typename E>
__device__ __forceinline__ void head_attention(const CrossArgs& p, int b, int q0, int nq,
                                               const float* q_s, const KE* k_s, const KE* v_s,
                                               float* p_s, E* o_s, int ld) {
  const int tid = threadIdx.x, S = p.skv;
  for (int idx = tid; idx < nq * S; idx += kThreads) {
    const int i = idx / S, s = idx % S;
    const float* qi = q_s + i * D;
    const KE* ks = k_s + s * D;
    float dot = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) dot = fmaf(qi[d], to_float(ks[d]), dot);
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
  for (int idx = tid; idx < kTM * D; idx += kThreads) {
    const int i = idx / D, d = idx % D;
    float o = 0.f;
    if (i < nq) {
      const float* pr = p_s + i * kTK;
      for (int s = 0; s < S; ++s) o = fmaf(pr[s], to_float(v_s[s * D + d]), o);
    }
    o_s[i * ld + d] = from_float<E>(o);
  }
  __syncthreads();
}

// --- f32: SIMT ----------------------------------------------------------------

size_t kv_smem_bytes(int H) {
  return sizeof(float) * (size_t)(kTM * H + kKT * kSlab);
}

__global__ void __launch_bounds__(kThreads, 1) kv_proj_kernel(CrossArgs p) {
  const int H = p.hidden;
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

// f32 cross_attn: the weight slices take [kKT][64 kQJ] of Wq (zero columns
// past D) or [kKTo][H] of Wo.
template <int D>
__host__ __device__ int cross_w_elems(int H) {
  constexpr int wq = kKT * 64 * ((D + 63) / 64);
  return wq > kKTo * H ? wq : kKTo * H;
}

template <int D>
size_t cross_smem_bytes(int H) {
  const int w = cross_w_elems<D>(H);
  return sizeof(float) * (size_t)(kTM * kKT + w + 2 * kTM * D + 2 * kTK * D + kTM * kTK);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) cross_attn_kernel(CrossArgs p) {
  constexpr int kQJ = (D + 63) / 64;  // q columns of a thread, 64 apart
  const int H = p.hidden, nc = H / 64;
  const int W = cross_w_elems<D>(H);
  const float* __restrict__ x = static_cast<const float*>(p.x);
  const float* __restrict__ wq = static_cast<const float*>(p.wq);
  const float* __restrict__ bq = static_cast<const float*>(p.bq);
  const float* __restrict__ wo = static_cast<const float*>(p.wo);
  const float* __restrict__ bo = static_cast<const float*>(p.bo);
  const float* __restrict__ kv = static_cast<const float*>(p.kv);
  float* __restrict__ out = static_cast<float*>(p.out);

  extern __shared__ float smem[];
  float* x_sl = smem;             // [kTM][kKT] slice of the x tile
  float* w_s = x_sl + kTM * kKT;  // [kKT][64 kQJ] slices of Wq, then [kKTo][H] of Wo
  float* q_s = w_s + W;           // [kTM][D]
  float* o_s = q_s + kTM * D;     // [kTM][D]
  float* k_s = o_s + kTM * D;     // [kTK][D]
  float* v_s = k_s + kTK * D;     // [kTK][D]
  float* p_s = v_s + kTK * D;     // [kTM][kTK]

  const int tid = threadIdx.x, tx = tid & 63, ty = tid >> 6;
  const int chunks = (p.tq + kTM - 1) / kTM;
  const int b = blockIdx.x / chunks, q0 = kTM * (blockIdx.x % chunks);
  const int nq = min(kTM, p.tq - q0);
  const long long tok0 = (long long)b * p.tq + q0;
  const float* xb = x + tok0 * H;
  float acc[kRM][kMaxNC];
#pragma unroll
  for (int r = 0; r < kRM; ++r)
#pragma unroll
    for (int j = 0; j < kMaxNC; ++j) acc[r][j] = 0.f;

  for (int h = 0; h < p.num_heads; ++h) {
    float pq[kRM][kQJ];
#pragma unroll
    for (int r = 0; r < kRM; ++r)
#pragma unroll
      for (int j = 0; j < kQJ; ++j) pq[r][j] = 0.f;
    for (int k0 = 0; k0 < H; k0 += kKT) {
      for (int i = tid; i < kTM * kKT; i += kThreads) {
        const int r = i / kKT;
        x_sl[i] = r < nq ? xb[(long long)r * H + k0 + i % kKT] : 0.f;
      }
      for (int i = tid; i < kKT * 64 * kQJ; i += kThreads) {
        const int kk = i / (64 * kQJ), c = i % (64 * kQJ);
        w_s[i] = c < D ? wq[(long long)(k0 + kk) * H + h * D + c] : 0.f;
      }
      __syncthreads();
      tile_fma<kRM, kQJ>(pq, x_sl, kKT, ty * kRM, w_s, 64 * kQJ, tx, kKT);
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kQJ; ++j) {
      const int d = tx + 64 * j;
      if (d >= D) continue;
#pragma unroll
      for (int r = 0; r < kRM; ++r) q_s[(ty * kRM + r) * D + d] = pq[r][j] + bq[h * D + d];
    }
    load_kv_head<D>(k_s, v_s, kv, b, h, p.skv, H);
    __syncthreads();
    head_attention<D>(p, b, q0, nq, q_s, k_s, v_s, p_s, o_s, D);

    // acc += o_h @ Wo[h*D:(h+1)*D, :]
    for (int k0 = 0; k0 < D; k0 += kKTo) {
      for (int i = tid; i < kKTo * H; i += kThreads) w_s[i] = wo[(long long)(h * D + k0) * H + i];
      __syncthreads();
      tile_fma<kRM, kMaxNC>(acc, o_s + k0, D, ty * kRM, w_s, H, tx, kKTo, nc);
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < kRM; ++r) {
    const int i = ty * kRM + r;
    if (i >= nq) continue;
#pragma unroll
    for (int j = 0; j < kMaxNC; ++j) {
      const int c = tx + 64 * j;
      if (j < nc) out[(tok0 + i) * H + c] = acc[r][j] + bo[c];
    }
  }
}

// --- bf16: tensor cores -------------------------------------------------------

size_t kv_tc_smem_bytes(int H) {
  return sizeof(bf16) * ((size_t)kTM * (H + kPad) + ring_elems(kKS1, kSlab)) +
         sizeof(float) * (size_t)(kWarps * 256);
}

__global__ void __launch_bounds__(kThreads, 1) kv_proj_tc_kernel(CrossArgs p) {
  const int H = p.hidden, LDX = H + kPad;
  const bf16* __restrict__ ctx = static_cast<const bf16*>(p.ctx);
  const bf16* __restrict__ wkv = static_cast<const bf16*>(p.wkv);
  const bf16* __restrict__ bkv = static_cast<const bf16*>(p.bkv);
  bf16* __restrict__ kv = static_cast<bf16*>(p.kv);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* a_s = reinterpret_cast<bf16*>(smem_raw);  // [kTM][LDX] ctx tokens
  bf16* stages = a_s + kTM * LDX;                 // ring of Wkv slices
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* scratch = reinterpret_cast<float*>(stages + ring_elems(kKS1, kSlab)) + warp * 256;
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
  gemm_ring<1, 2, kKS1>(acc, a_s + rf * 16 * LDX, LDX, slab, H, stages, cf0, 1);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    for_each_element(acc[0][j], scratch, lane, [&](int i, int jj, float v) {
      const int row = rf * 16 + i, c = col0 + (cf0 + j) * 16 + jj;
      if (row < n) kv[(tok0 + row) * 2 * H + c] = from_float<bf16>(v + to_float(bkv[c]));
    });
  }
}

template <int D>
__host__ __device__ int cross_ring_elems(int H) {
  const int s1 = ring_elems(kKS1, D), s2 = ring_elems(kKS2, H);
  return s1 > s2 ? s1 : s2;
}

// 231,168 bytes at D = 128, H = 1024 (k_h, v_h in bf16 there; f32 below).
template <int D>
size_t cross_tc_smem_bytes(int H) {
  return sizeof(bf16) * ((size_t)kTM * ((H + kPad) + (D + kPad)) + cross_ring_elems<D>(H)) +
         sizeof(typename QkvType<D>::type) * (size_t)2 * kTK * D +
         sizeof(float) * (size_t)(kTM * D + kWarps * 256);
}

// HC: H at compile time (kRefHidden), or 0 for H from the arguments.
template <int D, int HC, int OCF>
__global__ void __launch_bounds__(kThreads, 1) cross_attn_tc_kernel(CrossArgs p) {
  constexpr int LDO = D + kPad;
  // q_h [kTM, D] has kQF column fragments: a run of kQCF a warp where they
  // split evenly over the four warps of a row fragment (D = 64, 128), else
  // (D = 32) kQCF fragments 4 apart.
  constexpr int kQF = D / 16, kQCF = (kQF + 3) / 4;
  constexpr bool kQRun = kQF % 4 == 0;
  static_assert(HC == 0 || HC / 16 == kWarps * OCF, "a compile-time width splits evenly");
  using KE = typename QkvType<D>::type;
  const int H = HC > 0 ? HC : p.hidden, LDX = H + kPad;
  const int num_heads = HC > 0 ? HC / D : p.num_heads;
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
  float* q_s = reinterpret_cast<float*>(stages + cross_ring_elems<D>(H));  // [kTM][D]
  KE* k_s = reinterpret_cast<KE*>(q_s + kTM * D);  // [kTK][D]
  KE* v_s = k_s + kTK * D;                         // [kTK][D]
  // [kTM][kTK] probabilities, over the ring: they live between the GEMMs.
  float* p_s = reinterpret_cast<float*>(stages);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* scratch = reinterpret_cast<float*>(v_s + kTK * D) + warp * 256;

  const int chunks = (p.tq + kTM - 1) / kTM;
  const int b = blockIdx.x / chunks, q0 = kTM * (blockIdx.x % chunks);
  const int nq = min(kTM, p.tq - q0);
  const long long tok0 = (long long)b * p.tq + q0;
  load_tokens(x_s, LDX, x + tok0 * H, nq, H);
  // The output [kTM, H]: both row fragments and the warp's run of column
  // fragments, ocf0 + j (H / 128 of them, the last warps' runs cut at H).
  const int per_warp = (H / 16 + kWarps - 1) / kWarps, ocf0 = warp * per_warp;
  FragC acc[2][OCF];
  zero(acc);
  // This warp's share of q_h [kTM, D]: row fragment warp / 4, column
  // fragments qcf0 + qstep j.
  constexpr int qstep = kQRun ? 1 : 4;
  const int qrf = warp / 4, qcf0 = (warp % 4) * (kQRun ? kQCF : 1);

  for (int h = 0; h < num_heads; ++h) {
    // The GEMMs synchronise the block before they read x_s and after.
    FragC qacc[1][kQCF];
    zero(qacc);
    const BCols<1, D> wq_head{{wq + h * D}, H};
    if constexpr (kQRun) {
      gemm_streamed<1, kQCF, kKS1>(qacc, x_s + qrf * 16 * LDX, LDX, wq_head, H, stages, qcf0);
    } else {
      gemm_ring<1, kQCF, kKS1>(qacc, x_s + qrf * 16 * LDX, LDX, wq_head, H, stages, qcf0, qstep);
    }
#pragma unroll
    for (int j = 0; j < kQCF; ++j) {
      const int cf = qcf0 + qstep * j;
      if (!kQRun && cf >= kQF) continue;  // uniform over the warp
      for_each_element(qacc[0][j], scratch, lane, [&](int i, int jj, float v) {
        const int d = cf * 16 + jj;
        q_s[(qrf * 16 + i) * D + d] = round_to<bf16>(v + to_float(bq[h * D + d]));
      });
    }
    load_kv_head<D>(k_s, v_s, kv, b, h, p.skv, H);
    __syncthreads();
    head_attention<D>(p, b, q0, nq, q_s, k_s, v_s, p_s, o_s, LDO);

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
        if (row < nq) out[(tok0 + row) * H + c] = from_float<bf16>(v + to_float(bo[c]));
      });
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D, int HC, int OCF, bool kTensorCores>
int launch(const CrossArgs& a, cudaStream_t stream) {
  auto kv_kernel = kTensorCores ? kv_proj_tc_kernel : kv_proj_kernel;
  auto attn_kernel = kTensorCores ? cross_attn_tc_kernel<D, HC, OCF> : cross_attn_kernel<D>;
  const size_t kv_smem = kTensorCores ? kv_tc_smem_bytes(a.hidden) : kv_smem_bytes(a.hidden);
  const size_t attn_smem = kTensorCores ? cross_tc_smem_bytes<D>(a.hidden) : cross_smem_bytes<D>(a.hidden);
  if (kv_smem > kMaxSmem || attn_smem > kMaxSmem) return -1;
  cudaError_t err = set_smem(kv_kernel, kv_smem);
  if (err == cudaSuccess) err = set_smem(attn_kernel, attn_smem);
  if (err != cudaSuccess) return (int)err;
  const long long kv_tiles = ((long long)a.rows * a.skv + kTM - 1) / kTM;
  const long long attn_blocks = (long long)a.rows * ((a.tq + kTM - 1) / kTM);
  if (kv_tiles > 0x7fffffffLL || attn_blocks > 0x7fffffffLL) return -1;
  if (a.rows > 0) {
    kv_kernel<<<dim3((unsigned)kv_tiles, 2 * a.hidden / kSlab), kThreads, kv_smem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    attn_kernel<<<(unsigned)attn_blocks, kThreads, attn_smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <int D, bool kTensorCores>
int launch_width(const CrossArgs& a, cudaStream_t s) {
  if constexpr (kTensorCores && D == kRefHeadDim) {
    if (a.hidden == kRefHidden) return launch<D, kRefHidden, kOutCF768, true>(a, s);
  }
  if (kTensorCores && a.hidden <= 768) return launch<D, 0, kOutCF768, true>(a, s);
  return launch<D, 0, kOutCFMax, kTensorCores>(a, s);
}

template <bool kTensorCores>
int dispatch(int head_dim, const CrossArgs& a, cudaStream_t s) {
  switch (head_dim) {
    case 32: return launch_width<32, kTensorCores>(a, s);
    case 64: return launch_width<64, kTensorCores>(a, s);
    case 128: return launch_width<128, kTensorCores>(a, s);
    default: return -1;
  }
}

}  // namespace

// Returns 0, a cudaError_t from a launch, -1 for a shape the kernels do not
// take (H not a multiple of 64 up to 1024, H / num_heads not in {32, 64,
// 128}, T or S outside 1..64) or -2 for an unknown dtype code (0 = float32,
// 1 = bfloat16). kv is the caller's [rows * S, 2H] scratch in the storage
// type.
extern "C" int stlt_fused_cross_attention(
    const void* x, const void* ctx, const void* wq, const void* bq, const void* wkv,
    const void* bkv, const void* wo, const void* bo, const void* bias,
    long long bias_row_stride, long long bias_q_stride, void* kv, void* out, int rows, int tq,
    int skv, int hidden, int num_heads, float scale, int dtype, void* stream) {
  if (hidden % 64 != 0 || hidden < 64 || hidden > 64 * kMaxNC || num_heads < 1 ||
      hidden % num_heads != 0 || tq < 1 || tq > kTK || skv < 1 || skv > kTK || rows < 0) {
    return -1;
  }
  CrossArgs a{x, ctx, wq, bq, wkv, bkv, wo, bo, static_cast<const float*>(bias), bias_row_stride,
              bias_q_stride, kv, out, rows, tq, skv, hidden, num_heads, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<false>(hidden / num_heads, a, s);
  if (dtype == 1) return dispatch<true>(hidden / num_heads, a, s);
  return -2;
}
