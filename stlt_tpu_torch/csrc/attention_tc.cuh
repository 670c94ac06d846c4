// The building blocks that the attention forward's and backward's bf16
// bodies at head dims 64 and 128 share (attention_core.cuh's
// tc::attention_fwd_kernel, attention_bwd_core.cuh's tc::attention_dq_kernel
// and tc::attention_dkdv_kernel): one consumer warpgroup that owns a block's
// 64 rows and one producer warp that fills a two-stage ring of TMA tiles
// (and, in a bias mode, each stage's f32 bias tile by cp.async) behind
// mbarriers; the SS wgmma of a [64 x 64] logits tile, the hi + lo split of an
// f32 accumulator fragment into RS wgmma A fragments, the RS product with an
// MN-major [64][D] tile, and the store of accumulator rows. Tiles and
// descriptors as hopper.cuh states them. Also zero_rows, which the staged
// bodies use too.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace stlt {
namespace attn {

// Zeros into rows r0 .. r0 + rows - 1 of head n of clip B_idx of a
// contiguous [B, R, N, D] output, by the whole block.
template <int D, typename E>
__device__ __forceinline__ void zero_rows(E* base, int B_idx, int r0, int rows, int R, int N, int n) {
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    base[(((long long)B_idx * R + r0 + i / D) * N + n) * D + i % D] = from_float<E>(0.f);
  }
}

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kStages = 2;                 // ring stages of the streamed tiles
constexpr int kConsumers = 128;            // one consumer warpgroup: the block's 64 rows
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kLdT = 68;  // bias tile row (floats) the dk/dv kernel reads transposed: conflict free
constexpr int kLdR = 72;  // bias tile row the dq kernel reads in float2 along its rows: conflict free
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
__host__ __device__ constexpr int tile_elems() { return 64 * D; }  // one [64][D] tile: D / 64 boxes of [64][64]

struct Bars {
  uint64_t full[kStages];   // a stage's TMA bytes landed and its 32 producer lanes' cp.async
  uint64_t empty[kStages];  // the consumer warpgroup is done with a stage
  uint64_t once;            // the resident tiles landed
};

// Shared memory of a kernel with kRes resident [64][D] tiles, two streamed
// ones a stage, each stage's bias tile of rows of kLd floats (kLd = 0: none)
// and kRowFloats more f32 of a stage, after the barriers (in 1 KB),
// 1,024-byte aligned (carve aligns; the first 1 KB is slack). The backward
// takes two resident tiles and 128 row floats (lse and dsum): D = 64 87,040
// (dk/dv) and 89,088 (dq) bytes, D = 128 136,192 and 138,240; the forward
// (attention_core.cuh) one resident tile and no row floats.
template <int D, int kRes, int kLd, int kRowFloats>
constexpr size_t smem_bytes() {
  return 1024 + 1024 + (size_t)(kRes + 2 * kStages) * tile_elems<D>() * sizeof(bf16) +
         (size_t)kStages * (64 * kLd + kRowFloats) * sizeof(float);
}

struct Smem {
  Bars* bars;
  bf16* res;    // the resident tiles: q (forward), q and dO (dq), k and v (dk/dv)
  bf16* str;    // stage s's streamed pair at str + 2 s tile: k and v (forward, dq), q and dO (dk/dv)
  float* bias;  // stage s's bias tile at bias + s 64 kLd, [query][key]
  float* rows;  // stage s's row floats at rows + kRowFloats s: lse, then dsum (dk/dv)
};

template <int D, int kRes, int kLd>
__device__ __forceinline__ Smem carve(unsigned char* raw) {
  // Aligned by an offset from raw (not through an integer), so the compiler
  // still knows every pointer below is shared memory (LDS, not generic LD).
  unsigned char* base = raw + ((1024 - (hopper::smem_addr(raw) & 1023)) & 1023);
  Smem m;
  m.bars = reinterpret_cast<Bars*>(base);
  m.res = reinterpret_cast<bf16*>(base + 1024);
  m.str = m.res + kRes * tile_elems<D>();
  m.bias = reinterpret_cast<float*>(m.str + 2 * kStages * tile_elems<D>());
  m.rows = m.bias + kStages * 64 * kLd;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&m.bars->full[s], 1 + 32);  // the TMA's expect_tx and 32 cp.async arrivals
      hopper::mbar_init(&m.bars->empty[s], 1);
    }
    hopper::mbar_init(&m.bars->once, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  return m;
}

// Rows r0 .. r0 + 63 of head n of clip b into a [64][D] tile, onto `bar`.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const CUtensorMap* map, uint64_t* bar, int n, int r0,
                                          int b) {
#pragma unroll
  for (int box = 0; box < D / 64; ++box) hopper::tma_load_4d(dst + box * 64 * 64, map, bar, box * 64, n, r0, b);
}

// The [64 query x 64 key] bias tile of queries t0 .. and keys s0 .. into a
// [64][ld] f32 tile by the producer warp, lanes along the keys (4-byte
// cp.async: the rows need not be 16-byte aligned); entries past tlim or
// klim are zeros. The element of (t, key) is bias[t st + key sk]. With
// kSwizzle (ld = 64) column c of row r lands at column c ^ bias_swizzle(r),
// so that reads of a float2 along the rows of a wgmma fragment hit distinct
// banks without padded rows.
__device__ __forceinline__ int bias_swizzle(int r) { return 8 * (r & 3); }

template <bool kSwizzle = false>
__device__ __forceinline__ void load_bias_tile(float* dst, int ld, const float* bias, long long st,
                                               long long sk, int t0, int tlim, int s0, int klim,
                                               int lane) {
  for (int r = 0; r < 64; ++r) {
    const int t = t0 + r;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = s0 + lane + 32 * h;
      const bool valid = t < tlim && key < klim;
      const int col = kSwizzle ? (lane + 32 * h) ^ bias_swizzle(r) : lane + 32 * h;
      hopper::cp_async4_zfill(dst + r * ld + col, valid ? bias + t * st + key * sk : bias, valid);
    }
  }
}

// The bf16 hi and lo parts of a m64n64 f32 accumulator fragment x, in the
// RS wgmma's A-fragment words: hi[4 kk .. 4 kk + 3] (and lo's) are the A
// fragment of x's columns 16 kk .. 16 kk + 15 (hopper.cuh, WgmmaRS).
__device__ __forceinline__ void split_hi_lo(const float (&x)[32], uint32_t (&hi)[16], uint32_t (&lo)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    const __nv_bfloat162 l = __floats2bfloat162_rn(x[2 * i] - __low2float(h), x[2 * i + 1] - __high2float(h));
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = *reinterpret_cast<const uint32_t*>(&l);
  }
}

// acc[64 x D] += A[64 x 64] B[64 x D]: A's hi and lo parts from registers, B
// a [64][D] tile stored k-row by k-row (MN-major).
template <int D>
__device__ __forceinline__ void rs_product(float (&acc)[D / 2], const uint32_t (&hi)[16],
                                           const uint32_t (&lo)[16], const bf16* b) {
  using hopper::WgmmaRS;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    WgmmaRS<D, 1>::mma(acc, hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2], hi[4 * kk + 3],
                       hopper::desc_mn(b, kk), 1);
    WgmmaRS<D, 1>::mma(acc, lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2], lo[4 * kk + 3],
                       hopper::desc_mn(b, kk), 1);
  }
}

// s[64 x 64] = A[64 x D] B[64 x D]^T, both [64][D] tiles K-major.
template <int D>
__device__ __forceinline__ void ss_logits(float (&s)[32], const bf16* a, const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = kk / 4 * 64 * 64;
    hopper::Wgmma<64, 0, 0>::mma(s, hopper::desc_k(a + box, kk % 4), hopper::desc_k(b + box, kk % 4), kk > 0);
  }
}

// Rows r0 (+ 8) of the consumer fragment, f32 accumulator acc[D / 2], into
// a contiguous [B, R, N, D] bf16 output at row base `row` (times `mul`), or
// zeros when !live.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, long long row, const float (&acc)[D / 2], int h,
                                           float mul, bool live, int tig) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const __nv_bfloat162 v = live ? __floats2bfloat162_rn(acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul)
                                  : __floats2bfloat162_rn(0.f, 0.f);
    *reinterpret_cast<__nv_bfloat162*>(out + row * D + 8 * j + 2 * tig) = v;
  }
}

}  // namespace tc
}  // namespace attn
}  // namespace stlt
