// Shared device helpers of the port's hand-written Hopper kernels.
//
// Values are carried in f32 inside the kernels. A storage type T (float or
// __nv_bfloat16) is the compute dtype of the JAX kernel contract: where the
// JAX kernel rounds to the compute dtype, these kernels call round_to<T>.
//
// Two kinds of kernel share these helpers: the f32 ones multiply on the SIMT
// pipes (tile_fma), so the f32 path stays true f32 with no TF32; the bf16
// ones multiply on the tensor cores, through WMMA (16x16x16 bf16 products
// accumulated in f32: attention_core.cuh) or through wgmma (hopper.cuh),
// which is what the JAX kernels' bf16 dots with f32 accumulation compute.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace stlt {

namespace wmma = nvcuda::wmma;

constexpr int kThreads = 256;  // 8 warps; SIMT thread (ty, tx) = (tid / 64, tid % 64)
constexpr int kWarps = kThreads / 32;
constexpr int kTM = 32;        // token rows of one block's tile
constexpr int kTK = 64;        // keys of one attention row at most (T <= 64)
constexpr int kRM = kTM / (kThreads / 64);  // rows each SIMT thread accumulates
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory one block may take (227 KB)

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

// lowbias32, the full-avalanche 32-bit mix of the counter-hashed dropout
// (stlt_tpu/ops/flash.py::_lowbias32); unsigned arithmetic wraps mod 2**32.
__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// Attention-probability dropout of the train kernels: the scale 1/(1-rate)
// for a kept (row b, head n, query t, key s), else 0. The bit is
// stlt_tpu/ops/flash.py::_keep_block_heads's at the global row row_base + b
// and the global head head0 + n of `heads`: lane lowbias32(((row_base +
// b)*heads + head0 + n) ^ seed), counter t*S + s over the unpadded key count
// S, kept when lowbias32(counter ^ lane) >= thresh. A launch on rows [r0,
// r0 + B) of a batch passes row_base = r0 (mod 2**32, the lane's wrap) and
// hashes the bits of those rows of the whole batch; a model rank's launch on
// heads [head0, head0 + N/M) of the N passes head0 and heads = N and hashes
// those heads' bits; a one-process launch passes 0 and its own N. The
// long-clip attention kernels (rows 6-10) take it; rows 3 and 4 take a
// RowMap (RowDropout).
struct Dropout {
  int on;
  uint32_t seed, thresh;
  float scale;
  uint32_t row_base;
  uint32_t head0, heads;
  __device__ __forceinline__ float keep_scale(uint32_t b, uint32_t n, uint32_t t, uint32_t s,
                                              uint32_t s_total) const {
    const uint32_t lane = lowbias32(((row_base + b) * heads + head0 + n) ^ seed);
    return lowbias32((t * s_total + s) ^ lane) >= thresh ? scale : 0.f;
  }
};

// The global row (or token) of a launch's local index i, at which the
// dropout bits are hashed: g(i) = (i / period) * stride + base + i % period,
// mod 2**32 (the 64-bit index truncated where JAX's uint32 counter wraps:
// truncation commutes with + and *, so 32-bit arithmetic gives its low
// bits). A ring rank's frame rows (t of each clip's F frames) take period
// t, stride F; the affine map base + i (a launch on rows [base, base + n)
// of a batch) takes period = stride = 2**31, past any local index. The
// quotient is a multiply-high by magic = ceil(2**(31 + l) / period), l =
// ceil(log2 period), exact for i < 2**31 (ops/dropout.py::RowMap
// .kernel_args): no division and no branch, taken once per row
// (attention) or per token row (tails).
struct RowMap {
  uint32_t base, period, stride, magic;
  __device__ __forceinline__ uint32_t operator()(uint32_t i) const {
    const uint32_t shift = 63 - __clz(period - 1);  // 31 + l; period 1: __clz(0) = 32
    const uint32_t q = static_cast<uint32_t>((static_cast<unsigned long long>(i) * magic) >> shift);
    return q * stride + base + (i - q * period);
  }
};

// Rows 3 and 4's dropout: Dropout's bits at the global row rows(b) and the
// global head head0 + n of `heads`: the lane of (b, n) once per row and head
// (row_lane), then keep_at per key.
struct RowDropout {
  int on;
  uint32_t seed, thresh;
  float scale;
  RowMap rows;
  uint32_t head0, heads;
  __device__ __forceinline__ uint32_t row_lane(uint32_t b, uint32_t n) const {
    return lowbias32((rows(b) * heads + head0 + n) ^ seed);
  }
  __device__ __forceinline__ float keep_at(uint32_t lane, uint32_t t, uint32_t s,
                                           uint32_t s_total) const {
    return lowbias32((t * s_total + s) ^ lane) >= thresh ? scale : 0.f;
  }
};

// The train layer tail's three dropout sites (stlt_tpu/ops/fused_tail_train.py
// TAG_* :90-92 and _keep_rows :97): the stream of a site has the lane
// lowbias32(seed ^ tag); the element (token, feature) of a stream of `width`
// features has the counter g(token) * width + feature (mod 2**32, g = tokens
// the global index over the flattened tokens) and is kept when
// lowbias32(counter ^ lane) >= thresh. row_counter gives g(token) * width,
// once per token row; keep_at gives 1/(1-rate) for a kept element, else 0,
// so v * keep_at is JAX's v * keep * drop_scale.
constexpr uint32_t kTagAttnDrop = 0x9E3779B9u;
constexpr uint32_t kTagMidDrop = 0x85EBCA6Bu;
constexpr uint32_t kTagOutDrop = 0xC2B2AE35u;

struct TailDropout {
  int on;
  uint32_t seed, thresh;
  float scale;
  RowMap tokens;
  __device__ __forceinline__ uint32_t lane(uint32_t tag) const { return lowbias32(seed ^ tag); }
  __device__ __forceinline__ uint32_t row_counter(long long token, uint32_t width) const {
    return tokens(static_cast<uint32_t>(token)) * width;
  }
  __device__ __forceinline__ float keep_at(uint32_t lane, uint32_t row_counter,
                                           uint32_t feature) const {
    return lowbias32((row_counter + feature) ^ lane) >= thresh ? scale : 0.f;
  }
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

// Rows [0, n) of src (row stride ld_src) into rows of dst (row stride ld),
// rows [n, rows) zeros, `width` elements a row: one warp a row, 16-byte
// copies where src, dst and both strides allow (width a multiple of 64 and
// the row strides of the tiles here always do), else element by element.
// No division per element, so a runtime width costs nothing.
template <typename E>
__device__ __forceinline__ void copy_rows(E* dst, int ld, const E* src, long long ld_src, int n,
                                          int rows, int width) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kVec = 16 / sizeof(E);
  const bool vec = ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0 &&
                   width % kVec == 0 && ld % kVec == 0 && ld_src % kVec == 0;
  for (int r = warp; r < rows; r += kWarps) {
    E* d = dst + (long long)r * ld;
    const E* s = src + r * ld_src;
    if (vec) {
      for (int c = lane; c < width / kVec; c += 32) {
        reinterpret_cast<uint4*>(d)[c] =
            r < n ? reinterpret_cast<const uint4*>(s)[c] : make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      for (int c = lane; c < width; c += 32) d[c] = r < n ? s[c] : from_float<E>(0.f);
    }
  }
}

// acc[r][j] += A[(row0 + r) * lda + k] * B[k * ldb + tx + 64 * j] for k < kt
// and j < nj (a runtime width <= NJ: the register array keeps its
// compile-time size, the segments past nj are skipped): the register-tiled
// f32 inner product of the SIMT kernels on staged tiles.
template <int RM, int NJ>
__device__ __forceinline__ void tile_fma(float (&acc)[RM][NJ], const float* A, int lda, int row0,
                                         const float* B, int ldb, int tx, int kt, int nj = NJ) {
  for (int k = 0; k < kt; ++k) {
    float a[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) a[r] = A[(row0 + r) * lda + k];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < nj) {
        const float b = B[k * ldb + tx + 64 * j];
#pragma unroll
        for (int r = 0; r < RM; ++r) acc[r][j] = fmaf(a[r], b, acc[r][j]);
      }
    }
  }
}

// --- tensor-core (WMMA) helpers of the bf16 kernels --------------------------

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int kMaxNC = 16;
#define STLT_NC_CASES(F) \
  F(1) F(2) F(3) F(4) F(5) F(6) F(7) F(8) F(9) F(10) F(11) F(12) F(13) F(14) F(15) F(16)

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace stlt
