// Shared device helpers of the port's hand-written Hopper kernels.
//
// Values are carried in f32 inside the kernels. A storage type T (float or
// __nv_bfloat16) is the compute dtype of the JAX kernel contract: where the
// JAX kernel rounds to the compute dtype, these kernels call round_to<T>.
//
// Two kinds of kernel share these helpers: the f32 ones multiply on the SIMT
// pipes (tile_fma), so the f32 path stays true f32 with no TF32; the bf16
// ones multiply on the tensor cores through WMMA (16x16x16 bf16 products
// accumulated in f32, gemm_streamed), which is what the JAX kernels' bf16
// dots with f32 accumulation compute.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace stlt {

namespace wmma = nvcuda::wmma;

constexpr int kThreads = 256;  // 8 warps; SIMT thread (ty, tx) = (tid / 64, tid % 64)
constexpr int kWarps = kThreads / 32;
constexpr int kTM = 32;        // token rows of one block's tile
constexpr int kRM = kTM / (kThreads / 64);  // rows each SIMT thread accumulates
constexpr int kPad = 8;        // bf16 padding of shared tile rows (spreads banks, keeps 32 B alignment)

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round an f32 value to T and back: the compute-dtype rounding point.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_float(from_float<T>(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// flax LayerNorm statistics of one token row held in shared memory, by one
// warp: (mean, rsqrt(var + eps)) with var = E[x^2] - E[x]^2 clipped at 0.
template <int H, typename E>
__device__ __forceinline__ float2 row_stats(const E* row, int lane, float eps) {
  float s = 0.f, s2 = 0.f;
  for (int c = lane; c < H; c += 32) {
    const float v = to_float(row[c]);
    s += v;
    s2 = fmaf(v, v, s2);
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mu = s / H;
  const float var = fmaxf(0.f, s2 / H - mu * mu);
  return make_float2(mu, rsqrtf(var + eps));
}

// acc[r][j] += A[(row0 + r) * lda + k] * B[k * ldb + tx + 64 * j] for k < kt:
// the register-tiled f32 inner product of the SIMT kernels on staged tiles.
template <int RM, int NJ>
__device__ __forceinline__ void tile_fma(float (&acc)[RM][NJ], const float* A, int lda,
                                         int row0, const float* B, int ldb, int tx, int kt) {
  for (int k = 0; k < kt; ++k) {
    float a[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) a[r] = A[(row0 + r) * lda + k];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float b = B[k * ldb + tx + 64 * j];
#pragma unroll
      for (int r = 0; r < RM; ++r) acc[r][j] = fmaf(a[r], b, acc[r][j]);
    }
  }
}

// --- tensor-core (WMMA) helpers of the bf16 kernels --------------------------

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// The block's [kTM, H] f32 output tile, split over its warps: each warp owns
// kRF row fragments by kCF column fragments of 16 x 16, starting at
// (row0(warp), col0(warp)) in fragment units.
template <int NC>
struct WarpTile {
  static_assert(kTM == 32 && kWarps == 8, "the split assumes two row fragments and 8 warps");
  static constexpr int kRF = NC >= 2 ? 2 : 1;
  static constexpr int kCF = NC >= 2 ? NC / 2 : 1;
  __device__ static int row0(int warp) { return NC >= 2 ? 0 : warp % 2; }
  __device__ static int col0(int warp) { return NC >= 2 ? warp * kCF : warp / 2; }
};

template <int RF, int CF>
__device__ __forceinline__ void zero(FragC (&acc)[RF][CF]) {
#pragma unroll
  for (int r = 0; r < RF; ++r)
#pragma unroll
    for (int j = 0; j < CF; ++j) wmma::fill_fragment(acc[r][j], 0.f);
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The B operand of a block GEMM: NSEG segments of SEGW contiguous columns of
// a row-major bf16 matrix in device memory (row stride ld), side by side.
template <int NSEG, int SEGW>
struct BCols {
  const __nv_bfloat16* seg[NSEG];
  int ld;
};

constexpr int kStages = 3;  // B slices in flight: one computed on, two landing

// Shared-memory elements of a kStages ring of KS-row slices of B.
template <int KS, int NCOLS>
__host__ __device__ constexpr int stage_elems() {
  return kStages * KS * (NCOLS + kPad);
}

// acc[r][j] += A[r * 16 : r * 16 + 16, :K] @ B[:K, (cf0 + j) * 16 : +16]:
// bf16 operands, f32 sums, for all warps of the block at once. A is a bf16
// tile in shared memory (row stride lda), offset to this warp's first row
// fragment. B streams from device memory through `stages` in slices of KS
// rows: cp.async keeps kStages - 1 slices landing while the warps multiply
// the one that has arrived, so the weights' L2 latency hides behind the
// tensor cores. Every warp of the block calls it (it synchronises the block).
template <int RF, int CF, int KS, int NSEG, int SEGW>
__device__ __forceinline__ void gemm_streamed(FragC (&acc)[RF][CF], const __nv_bfloat16* A,
                                              int lda, const BCols<NSEG, SEGW>& b, int K,
                                              __nv_bfloat16* stages, int cf0) {
  constexpr int NB = NSEG * SEGW, LDB = NB + kPad, STAGE = KS * LDB;
  constexpr int kCopies = KS * NB / 8;  // 16-byte copies of one slice
  static_assert(KS % 16 == 0 && SEGW % 8 == 0, "slices are whole fragments and 16-byte copies");
  const int nslices = K / KS;
  auto load = [&](int slice) {
    __nv_bfloat16* dst = stages + (slice % kStages) * STAGE;
    for (int c = threadIdx.x; c < kCopies; c += kThreads) {
      const int row = c / (NB / 8), col = (c % (NB / 8)) * 8;
      cp_async16(dst + row * LDB + col,
                 b.seg[col / SEGW] + (long long)(slice * KS + row) * b.ld + col % SEGW);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nslices) load(s);
    cp_async_commit();
  }
  for (int i = 0; i < nslices; ++i) {
    cp_async_wait<kStages - 2>();  // slice i has landed
    __syncthreads();               // for every thread; slice i - 1 is consumed
    if (i + kStages - 1 < nslices) load(i + kStages - 1);
    cp_async_commit();
    const __nv_bfloat16* B = stages + (i % kStages) * STAGE;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      FragA a[RF];
#pragma unroll
      for (int r = 0; r < RF; ++r) {
        wmma::load_matrix_sync(a[r], A + r * 16 * lda + i * KS + kk, lda);
      }
#pragma unroll
      for (int j = 0; j < CF; ++j) {
        FragB bf;
        wmma::load_matrix_sync(bf, B + kk * LDB + (cf0 + j) * 16, LDB);
#pragma unroll
        for (int r = 0; r < RF; ++r) wmma::mma_sync(acc[r][j], a[r], bf, acc[r][j]);
      }
    }
  }
  __syncthreads();  // the ring is free for the next GEMM
}

// Calls f(i, j, value) for every element (i, j) of a 16 x 16 accumulator,
// through the warp's own 256-float shared scratch tile.
template <typename F>
__device__ __forceinline__ void for_each_element(const FragC& frag, float* scratch, int lane,
                                                 F&& f) {
  wmma::store_matrix_sync(scratch, frag, 16, wmma::mem_row_major);
  __syncwarp();
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int idx = lane + 32 * e;
    f(idx / 16, idx % 16, scratch[idx]);
  }
  __syncwarp();
}

}  // namespace stlt
