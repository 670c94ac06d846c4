// Shared pieces of the bf16 layer-tail kernels on Hopper: the forward's
// (fused_layer_tail.cu: rows 2 and 11) and the train backward's
// (fused_tail_train_bwd.cu: rows 13 and 14); the scan and the mainloop also
// serve the split attention sublayers (sublayer.cuh: rows 1, 3 and 5).
// Each .cu builds into a library of its own, so each holds its own copy of
// these kernels.
//
// - tail_live_rows_kernel packs the live tokens in order (rows[i] = the i-th
//   live token, *count their number); live_rows_scan is its body, which
//   can also place the dead items after the live ones (the split
//   attention sublayers, sublayer.cuh);
// - residual_row / ln1_row: one token's r1 = round(x + drop(a)) and its
//   u = LN1(r1), a warp a token, H at run time in 16-byte vectors;
// - a warp-specialised GEMM mainloop: a kRingStages ring of TMA-loaded tiles
//   behind mbarriers, filled by one producer thread (produce) and drained
//   by two consumer warpgroups of wgmma (consume), each kernel passing its
//   own loads and products as lambdas.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace stlt {
namespace tail {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;         // tokens of a GEMM tile: two consumer warpgroups of 64 rows
constexpr int kBK = 64;          // k of a stage: one 128-byte swizzle row of bf16
constexpr int kRingStages = 3;   // stages of the shared-memory ring
constexpr int kConsumers = 256;  // threads 0..255 multiply, a one-warp producer follows
constexpr int kGemmThreads = kConsumers + 32;
constexpr int kRowWarps = 8;     // tokens of a row-kernel block, one a warp
constexpr int kRowVecs = 1024 / 256;  // 16-byte vectors a lane holds of a row of H <= 1024
constexpr int kScanThreads = 1024;

// bar.sync on barrier `id` among `count` threads (the consumer warpgroups;
// the producer has left).
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__host__ __device__ constexpr long long round_up(long long v, long long m) { return (v + m - 1) / m * m; }

// The live items (tokens, or rows of a sublayer) packed in order: rows[i] =
// the i-th live item, *count = their number; with kDead, the dead items
// follow in order (rows[*count + j] = the j-th dead item). One block: each
// thread counts a run of items, a block scan places the runs, each thread
// writes its run's items. The flags are 0/1 bytes, 16-byte aligned.
template <bool kDead>
__device__ __forceinline__ void live_rows_scan(const uint8_t* live, int tokens, int* rows, int* count) {
  __shared__ int warp_total[kScanThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // Runs of whole 16-byte vectors.
  const int run = (tokens + 16 * kScanThreads - 1) / (16 * kScanThreads) * 16;
  const int lo = min(tokens, threadIdx.x * run), hi = min(tokens, lo + run);
  int n = 0;
  for (int i = lo; i < hi; i += 16) {
    if (i + 16 <= hi) {
      const uint4 v = *reinterpret_cast<const uint4*>(live + i);
      n += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
    } else {
      for (int j = i; j < hi; ++j) n += live[j];
    }
  }
  int incl = n;  // inclusive scan over the warp, then over the warps' totals
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_total[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += v;
    }
    warp_total[lane] = w;  // inclusive over the warps
  }
  __syncthreads();
  int at = incl - n + (warp > 0 ? warp_total[warp - 1] : 0);
  int dead_at = warp_total[kScanThreads / 32 - 1] + (lo - at);  // the live total, then the dead before lo
  auto place = [&](int item, bool is_live) {
    if (is_live) {
      rows[at++] = item;
    } else if (kDead) {
      rows[dead_at++] = item;
    }
  };
  for (int i = lo; i < hi; i += 16) {
    if (i + 16 <= hi) {
      const uint4 v = *reinterpret_cast<const uint4*>(live + i);
      const uint8_t* f = reinterpret_cast<const uint8_t*>(&v);
#pragma unroll
      for (int j = 0; j < 16; ++j) place(i + j, f[j] != 0);
    } else {
      for (int j = i; j < hi; ++j) place(j, live[j] != 0);
    }
  }
  if (threadIdx.x == kScanThreads - 1) *count = at;
}

__global__ void __launch_bounds__(kScanThreads) tail_live_rows_kernel(const uint8_t* live, int tokens,
                                                                      int* rows, int* count) {
  live_rows_scan<false>(live, tokens, rows, count);
}

// r1 = round(x + drop(a)) of token `tok` into v (vector i of the lane holds
// columns 8 (lane + 32 i) ..+7; vectors past H are left unset) and its flax
// LayerNorm statistics (mean, rsqrt(var + eps)): layer_norm1's arithmetic.
__device__ __forceinline__ float2 residual_row(const bf16* x, const bf16* a, const TailDropout& drop,
                                               float eps, long long tok, int H, float (&v)[kRowVecs][8]) {
  const int lane = threadIdx.x & 31;
  const uint32_t lane1 = drop.lane(kTagAttnDrop);
  const uint32_t rc1 = drop.on ? drop.row_counter(tok, H) : 0u;
  const uint4* xrow = reinterpret_cast<const uint4*>(x + tok * H);
  const uint4* arow = reinterpret_cast<const uint4*>(a + tok * H);
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kRowVecs; ++i) {
    const int vi = lane + 32 * i;
    if (vi * 8 >= H) continue;  // (no break: the loop unrolls, v takes constant indices)
    const uint4 xv = xrow[vi], av = arow[vi];
    const bf16* xe = reinterpret_cast<const bf16*>(&xv);
    const bf16* ae = reinterpret_cast<const bf16*>(&av);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float ai = to_float(ae[e]);
      if (drop.on) ai = round_to<bf16>(ai * drop.keep_at(lane1, rc1, vi * 8 + e));
      v[i][e] = round_to<bf16>(to_float(xe[e]) + ai);
      s += v[i][e];
      s2 = fmaf(v[i][e], v[i][e], s2);
    }
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mu = s / H;
  return make_float2(mu, rsqrtf(fmaxf(0.f, s2 / H - mu * mu) + eps));
}

// u = LN1(x + drop(a)) of token `tok` into the bf16 row `urow`, one warp:
// the train form (r - mu) * rstd * scale + bias, or the eval form with the
// scale folded into rstd (flax).
__device__ __forceinline__ void ln1_row(const bf16* x, const bf16* a, const float* n1s, const float* n1b,
                                        const TailDropout& drop, float eps, bool train, long long tok,
                                        int H, bf16* urow) {
  const int lane = threadIdx.x & 31;
  float v[kRowVecs][8];
  const float2 st = residual_row(x, a, drop, eps, tok, H, v);
#pragma unroll
  for (int i = 0; i < kRowVecs; ++i) {
    const int vi = lane + 32 * i;
    if (vi * 8 >= H) continue;  // (no break: the loop unrolls, v takes constant indices)
    uint4 ov;
    bf16* oe = reinterpret_cast<bf16*>(&ov);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = vi * 8 + e;
      const float d = v[i][e] - st.x;
      oe[e] = from_float<bf16>(train ? d * st.y * n1s[c] + n1b[c] : d * (st.y * n1s[c]) + n1b[c]);
    }
    reinterpret_cast<uint4*>(urow)[vi] = ov;
  }
}

// --- the GEMM mainloop ----------------------------------------------------------

// A ring of kRingStages stages of bf16 tiles in dynamic shared memory: the
// stages' A tiles (a_elems each), then their B tiles (b_elems each), after
// the barriers, 1,024-byte aligned; `full` (the TMA bytes landed) and
// `empty` (both consumer warpgroups done) a stage. The ring's bytes from
// `a` on are the kernel's to reuse once every consumer has passed its last
// stage (the epilogues park their tiles there).
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  bf16* a;
  bf16* b;
  int a_elems, b_elems;
  __device__ bf16* a_stage(int s) const { return a + s * a_elems; }
  __device__ bf16* b_stage(int s) const { return b + s * b_elems; }
};

// Dynamic shared memory of a kernel whose ring stages hold a_elems + b_elems
// bf16 and whose epilogue parks `park` bytes over them.
__host__ __device__ constexpr size_t ring_smem(int a_elems, int b_elems, size_t park = 0) {
  const size_t ring = (size_t)kRingStages * (a_elems + b_elems) * sizeof(bf16);
  return 1024 + 1024 + (ring > park ? ring : park);  // alignment slack, the barriers' 1 KB, the stages
}

// Lays the ring out and initialises its barriers (the whole block calls it).
__device__ __forceinline__ Ring make_ring(unsigned char* smem_raw, int a_elems, int b_elems) {
  using namespace hopper;
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  Ring r;
  r.full = reinterpret_cast<uint64_t*>(base);
  r.empty = r.full + kRingStages;
  r.a = reinterpret_cast<bf16*>(base + 1024);
  r.b = r.a + kRingStages * a_elems;
  r.a_elems = a_elems;
  r.b_elems = b_elems;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRingStages; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], 2);
    }
    fence_barrier_init();
  }
  __syncthreads();
  return r;
}

// The producer thread: step k goes to stage k % kRingStages once both
// consumers have freed it, expecting `bytes`; load(stage, k) issues its TMA
// loads onto r.full[stage].
template <typename Load>
__device__ __forceinline__ void produce(const Ring& r, int nk, uint32_t bytes, Load&& load) {
  using namespace hopper;
  for (int k = 0; k < nk; ++k) {
    const int s = k % kRingStages;
    if (k >= kRingStages) mbar_wait(&r.empty[s], (k / kRingStages - 1) & 1);
    mbar_expect_tx(&r.full[s], bytes);
    load(s, k);
  }
}

// A consumer warpgroup: for each step, once its stage has landed, the
// products mma(stage, k) (wgmmas into the accumulators acc...), waited for,
// then the stage freed.
template <typename Mma, typename... Acc>
__device__ __forceinline__ void consume(const Ring& r, int nk, Mma&& mma, Acc&... acc) {
  using namespace hopper;
  for (int k = 0; k < nk; ++k) {
    const int s = k % kRingStages;
    mbar_wait(&r.full[s], (k / kRingStages) & 1);
    wgmma_fence();
    mma(s, k);
    wgmma_commit();
    wgmma_wait<0>();
    (fence_operands(acc), ...);
    if (threadIdx.x % 128 == 0) mbar_arrive(&r.empty[s]);
  }
}

// Descriptors of the 128-byte-swizzled tiles (hopper.cuh).
using hopper::desc_k;
using hopper::desc_mn;

}  // namespace tail
}  // namespace stlt
