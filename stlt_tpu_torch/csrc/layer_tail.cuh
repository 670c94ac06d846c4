// Device helpers of the layer-tail kernels: fused_layer_tail.cu (the eval
// tail and the train forward) and fused_tail_train_bwd.cu (the train
// backward). They follow stlt_tpu/ops/fused_tail_train.py: the activation
// runs on the compute-dtype hidden op for op in that dtype (_act_cd), its
// gradient in f32 on the f32 pre-activation (_act_grad32), and LayerNorm is
// flax's (f32 stats, fast variance clipped at 0).
#pragma once

#include <cstdint>

#include "common.cuh"

namespace stlt {

enum Act { kRelu = 0, kGeluErf = 1, kGeluTanh = 2 };

// jax.nn.gelu op for op in T: the constants round to T and so does every
// step, as JAX computes a bf16 GELU (for T = float each round is a no-op).
template <typename T>
__device__ __forceinline__ float activation(float v, int act) {
  if (act == kGeluErf) {
    const float z = round_to<T>(-v * round_to<T>(0.70710678118654752f));
    return round_to<T>(round_to<T>(0.5f * v) * round_to<T>(erfcf(z)));
  }
  if (act == kGeluTanh) {
    const float cube = round_to<T>(round_to<T>(v * v) * v);
    const float inner = round_to<T>(v + round_to<T>(round_to<T>(0.044715f) * cube));
    const float t = round_to<T>(tanhf(round_to<T>(round_to<T>(0.79788456080286536f) * inner)));
    return round_to<T>(v * round_to<T>(0.5f * round_to<T>(1.f + t)));
  }
  return fmaxf(v, 0.f);
}

// d act / dz in f32 from the f32 pre-activation z, term for term as
// _act_grad32 (fused_tail_train.py:131-146).
__device__ __forceinline__ float activation_grad(float z, int act) {
  if (act == kRelu) return z > 0.f ? 1.f : 0.f;
  if (act == kGeluTanh) {
    const float c = 0.7978845608028654f, k = 0.044715f;
    const float t = tanhf(c * (z + k * z * z * z));
    return 0.5f * (1.f + t) +
           0.5f * z * (1.f - t * t) * c * (1.f + static_cast<float>(3.0 * 0.044715) * z * z);
  }
  const float cdf = 0.5f * (1.f + erff(z * 0.7071067811865476f));
  const float pdf = 0.3989422804014327f * expf(-0.5f * z * z);
  return cdf + z * pdf;
}

// 1 if any of the ntok tokens from tok0 is live (no live flags: all are).
__device__ __forceinline__ int tokens_have_live(const uint8_t* live, long long tok0, int ntok) {
  __shared__ int any_live;
  if (threadIdx.x == 0) {
    int l = 0;
    for (int i = 0; i < ntok; ++i) l |= live == nullptr || live[tok0 + i];
    any_live = l;
  }
  __syncthreads();
  return any_live;
}

// The residual r1 = x + drop(a) of one token's column c, as a T value:
// _recompute_u32 (fused_tail_train.py:165-185) drops a, rounds it to T, and
// rounds the sum to T. rc1: the token's row_counter over H features.
template <typename T>
__device__ __forceinline__ float residual1(const T* x, const T* a, long long g, const TailDropout& drop,
                                           uint32_t lane1, uint32_t rc1, int c) {
  float av = to_float(a[g]);
  if (drop.on) av = round_to<T>(av * drop.keep_at(lane1, rc1, c));
  return round_to<T>(to_float(x[g]) + av);
}

// u = LN1(x + drop(a)) of `rows` token rows from tok0 into u_s (row stride
// ld), one warp per token; rows from ntok on are zeros. kTrain is the train
// tail's form, (r - mu) * rstd * scale + bias after the attn-site dropout
// (_recompute_u32); the eval form folds the scale into rstd (flax).
template <typename T, typename E, int H, bool kTrain>
__device__ __forceinline__ void layer_norm1(const T* __restrict__ x, const T* __restrict__ a,
                                            const float* n1s, const float* n1b, float eps,
                                            const TailDropout& drop, E* u_s, int ld,
                                            long long tok0, int ntok, int rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t lane1 = drop.lane(kTagAttnDrop);
  for (int i = warp; i < rows; i += kWarps) {
    E* row = u_s + i * ld;
    if (i >= ntok) {
      for (int c = lane; c < H; c += 32) row[c] = from_float<E>(0.f);
      continue;
    }
    const long long tok = tok0 + i;
    const uint32_t rc1 = kTrain && drop.on ? drop.row_counter(tok, H) : 0u;
    for (int c = lane; c < H; c += 32) {
      const long long g = tok * H + c;
      row[c] = from_float<E>(kTrain ? residual1<T>(x, a, g, drop, lane1, rc1, c)
                                    : round_to<T>(to_float(x[g]) + to_float(a[g])));
    }
    __syncwarp();
    const float2 st = row_stats<H>(row, lane, eps);
    for (int c = lane; c < H; c += 32) {
      const float v = to_float(row[c]) - st.x;
      row[c] = from_float<E>(round_to<T>(kTrain ? v * st.y * n1s[c] + n1b[c]
                                                : v * (st.y * n1s[c]) + n1b[c]));
    }
  }
}

}  // namespace stlt
