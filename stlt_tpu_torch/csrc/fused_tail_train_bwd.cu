// Backward of the train layer tail (fused_layer_tail.cu's train kernel):
// given the layer inputs x, a [tokens, H], the saved residual r2 and the
// output cotangent g (compute dtype),
//
//   dx, dattn [tokens, H] (compute dtype)
//   dn1s, dn1b, dW1 [H, FF], db1 [FF], dW2 [FF, H], db2, dn2s, dn2b  (f32)
//
// Replaces the three TPU kernels of stlt_tpu/ops/fused_tail_train.py::
// _tail_train_bwd, one C entry point each, step for step as their bodies:
//
// row   (_tail_train_bwd_row_kernel :284) LN2 backward from r2:
//         xhat2 = LN(r2); dr2 = ln_bwd(g, xhat2, n2s)  (written in cd)
//         dn2s = sum g xhat2, dn2b = sum g, db2 = sum dr2 keep2  (f32 sums)
// input (_tail_train_bwd_input_kernel :350) FFN input side + LN1 backward:
//         u = LN1(x + drop(a)) recomputed; dh2 = cd(dr2 keep2); per FF chunk
//         z1 = u W1 + b1 (f32), dh1 = (dh2 W2^T) keepm act'(z1) with act'
//         taken on the f32 z1; du = dr2 + sum cd(dh1) W1^T (f32);
//         dr1 = ln_bwd(du, xhat1, n1s); dx = cd(dr1), dattn = cd(dr1 keep1);
//         dn1s = sum du xhat1, dn1b = sum du
// weight (_tail_train_bwd_weight_kernel :459)
//         dW1 = u^T cd(dh1), db1 = sum dh1 (the f32 dh1), dW2 = h1d^T dh2
//         with h1d = cd(act_cd(cd(z1)) keepm), the forward's dropped hidden
//
// The keep bits are the forward's (common.cuh::TailDropout). The cotangent of
// a dead token (live flag 0) counts as zero, as JAX masks g on entry: its dr2,
// dx and dattn are exact zeros and it adds nothing to any sum.
//
// Design. The TPU kernels carry their sums over tokens across a sequential
// grid, and the weight kernel recomputes z1 and dh1 in VMEM beside [H, chunk]
// f32 accumulators. On this card blocks run in parallel in no order and a
// block holds at most 227 KB, far less than those accumulators at H = 768, so:
//
// - every sum over tokens is a split reduction without atomics: each block
//   writes the partial sum of its own tokens and reduce_parts_kernel adds the
//   partials in block order, so two runs give the same bits;
// - row: one warp per token, in 264 blocks or fewer of contiguous tokens;
// - input: one block per 32 tokens (16 in f32), the FF chunks of 128 looped
//   inside it as in the forward kernel (z1 and dh2 W2^T on the tensor cores
//   in bf16 with W1 and W2^T streamed by cp.async, du accumulated in
//   registers, SIMT in f32). It already forms cd(dh1) and the dropped hidden
//   h1d for every (token, FF) pair, so it writes them, with u and cd(dh2),
//   to scratch in device memory (its db1 column sums too, as partials);
// - weight: dW1 and dW2 are then two products with the tokens as their
//   depth, tiled 64 x 128 / 128 x 64 over the output and split over token
//   chunks of the wrapper's choosing (WMMA in bf16, SIMT in f32), so each
//   block owns one output tile of one split. That computes each of the five
//   products of the backward once (z1, dh1d, du, dW1, dW2), where the TPU
//   kernels recompute z1 and dh1d in both the input and the weight kernel,
//   for ~2 x tokens x (2H + 2FF) bytes of scratch traffic.
//
// Bound on this card: five GEMMs of 2*tokens*H*FF flops against x, a, r2, g
// read and dx, dattn written: far above the ~295 flop/byte ridge, so the
// tensor cores bound rows input and weight; row is bound by its bytes (r2, g
// read, dr2 written).
#include <cstdint>

#include "common.cuh"
#include "layer_tail.cuh"

namespace {

using namespace stlt;
using bf16 = __nv_bfloat16;

constexpr int kFC = 128;   // FF chunk of the input kernel: one 16-column fragment per warp
constexpr int kKS1 = 64;   // rows of W1 / W2^T per streamed slice (z1, dh1d; tensor cores)
constexpr int kKS2 = 16;   // rows of W1^T per streamed slice (du; tensor cores)
constexpr int kKT1 = 16;   // k-slice of W1 / W2^T staged per SIMT step
constexpr int kKT2 = 8;    // k-slice of W1^T staged per SIMT step
constexpr int kTMF = 16;   // tokens of one f32 input block
constexpr int kKW = 32;    // tokens per step of the weight products
static_assert(kFC / 16 == kWarps, "one column fragment of the chunk per warp");

__device__ __forceinline__ bool is_live(const uint8_t* live, long long tok) {
  return live == nullptr || live[tok];
}

// out[i] = sum over k of part[k * width + i], k in order.
__global__ void reduce_parts_kernel(const float* __restrict__ part, int nparts, long long width,
                                    float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= width) return;
  float s = 0.f;
  for (int k = 0; k < nparts; ++k) s += part[k * width + i];
  out[i] = s;
}

int reduce_parts(const float* part, int nparts, long long width, float* out, cudaStream_t s) {
  if (width > 0) reduce_parts_kernel<<<(int)((width + 255) / 256), 256, 0, s>>>(part, nparts, width, out);
  return (int)cudaGetLastError();
}

// --- row: LN2 backward --------------------------------------------------------

struct RowArgs {
  const void* r2;
  const void* g;
  const float* n2s;
  const uint8_t* live;
  void* dr2;
  float* partial;  // [blocks][3][H]: dn2s, dn2b, db2
  long long tokens;
  long long chunk;  // tokens per block
  float eps;
  TailDropout drop;
};

// One warp per token; each lane holds the token's columns lane + 32 j. The
// warp's column sums live in its own slice of shared memory, and the block
// adds its warps' slices in order.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) tail_bwd_row_kernel(RowArgs p) {
  constexpr int H = NC * 64, V = H / 32;
  extern __shared__ float red[];  // [kWarps][3][H]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* mine = red + warp * 3 * H;
  for (int c = lane; c < 3 * H; c += 32) mine[c] = 0.f;
  const T* __restrict__ r2 = static_cast<const T*>(p.r2);
  const T* __restrict__ g = static_cast<const T*>(p.g);
  T* __restrict__ dr2 = static_cast<T*>(p.dr2);
  const long long t_begin = blockIdx.x * p.chunk;
  const long long t_end = min(p.tokens, t_begin + p.chunk);
  const uint32_t lane2 = p.drop.lane(kTagOutDrop);
  for (long long tok = t_begin + warp; tok < t_end; tok += kWarps) {
    T* drow = dr2 + tok * H;
    if (!is_live(p.live, tok)) {
      for (int c = lane; c < H; c += 32) drow[c] = from_float<T>(0.f);
      continue;
    }
    float xv[V], gv[V], s = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = lane + 32 * j;
      xv[j] = to_float(r2[tok * H + c]);
      gv[j] = to_float(g[tok * H + c]);
      s += xv[j];
      s2 = fmaf(xv[j], xv[j], s2);
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mu = s / H, rstd = rsqrtf(fmaxf(0.f, s2 / H - mu * mu) + p.eps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      xv[j] = (xv[j] - mu) * rstd;  // xhat2
      const float dxhat = gv[j] * p.n2s[lane + 32 * j];
      m1 += dxhat;
      m2 += dxhat * xv[j];
    }
    m1 = warp_sum(m1) / H;
    m2 = warp_sum(m2) / H;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = lane + 32 * j;
      const float d = rstd * (gv[j] * p.n2s[c] - m1 - xv[j] * m2);
      mine[c] += gv[j] * xv[j];
      mine[H + c] += gv[j];
      mine[2 * H + c] += p.drop.on ? d * p.drop.keep_scale(lane2, tok, H, c) : d;
      drow[c] = from_float<T>(d);
    }
  }
  __syncthreads();
  float* out = p.partial + (long long)blockIdx.x * 3 * H;
  for (int c = threadIdx.x; c < 3 * H; c += kThreads) {
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += red[w * 3 * H + c];
    out[c] = sum;
  }
}

template <typename T, int NC>
int launch_row(const RowArgs& a, int blocks, cudaStream_t s) {
  const size_t smem = sizeof(float) * kWarps * 3 * NC * 64;
  cudaError_t err = cudaFuncSetAttribute(tail_bwd_row_kernel<T, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (blocks > 0) tail_bwd_row_kernel<T, NC><<<blocks, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_row(int nc, const RowArgs& a, int blocks, cudaStream_t s) {
  switch (nc) {
#define STLT_CASE(n) \
    case n: return launch_row<T, n>(a, blocks, s);
    STLT_NC_CASES(STLT_CASE)
#undef STLT_CASE
    default: return -1;
  }
}

// --- input: FFN input side + LN1 backward ---------------------------------------

struct InputArgs {
  const void* x;
  const void* a;
  const void* dr2;
  const float* n1s;
  const float* n1b;
  const void* w1;   // [H, FF]
  const float* b1;
  const void* w1t;  // W1^T [FF, H]
  const void* w2t;  // W2^T [H, FF]
  const uint8_t* live;
  void* dx;
  void* dattn;
  void* u;    // scratch [tokens, H]: u (cd)
  void* dh2;  // scratch [tokens, H]: cd(dr2 keep2)
  void* dh1;  // scratch [tokens, FF]: cd(dh1)
  void* h1d;  // scratch [tokens, FF]: the dropped hidden
  float* partial_ln;  // [blocks][2][H]: dn1s, dn1b
  float* partial_b1;  // [blocks][FF]
  long long tokens;
  int ff;
  float eps;
  int act;
  TailDropout drop;
};

// dh1 and the dropped hidden of one (token, FF column) from z1 - b1 and
// dh2 W2^T (f32): dh1 = dh1d keepm act'(z1), h1d = cd(act_cd(cd(z1)) keepm).
template <typename T>
__device__ __forceinline__ float2 hidden_grads(const InputArgs& p, float zacc, float dacc,
                                               uint32_t lane_mid, long long tok, int f) {
  const float z = zacc + p.b1[f];
  float h1 = activation<T>(round_to<T>(z), p.act);
  if (p.drop.on) {
    const float k = p.drop.keep_scale(lane_mid, tok, p.ff, f);
    dacc *= k;
    h1 = round_to<T>(h1 * k);
  }
  return make_float2(dacc * activation_grad(z, p.act), h1);
}

// Zeros for the outputs, scratch rows and partials of a block with no live
// token.
template <typename T, int H>
__device__ void zero_input_block(const InputArgs& p, long long tok0, int ntok) {
  const long long nh = (long long)ntok * H, nf = (long long)ntok * p.ff;
  T* outs[4] = {static_cast<T*>(p.dx), static_cast<T*>(p.dattn), static_cast<T*>(p.u),
                static_cast<T*>(p.dh2)};
  for (long long i = threadIdx.x; i < nh; i += kThreads) {
    for (T* o : outs) o[tok0 * H + i] = from_float<T>(0.f);
  }
  T* dh1 = static_cast<T*>(p.dh1) + tok0 * p.ff;
  T* h1d = static_cast<T*>(p.h1d) + tok0 * p.ff;
  for (long long i = threadIdx.x; i < nf; i += kThreads) {
    dh1[i] = from_float<T>(0.f);
    h1d[i] = from_float<T>(0.f);
  }
  for (int c = threadIdx.x; c < 2 * H; c += kThreads) p.partial_ln[blockIdx.x * 2LL * H + c] = 0.f;
  for (int c = threadIdx.x; c < p.ff; c += kThreads) p.partial_b1[(long long)blockIdx.x * p.ff + c] = 0.f;
}

// LN1 backward of the block's tokens from du_s [rows][H] (the f32 sum of the
// FFN products, without the residual dr2): du = du_s + dr2; dr1 = ln_bwd(du,
// xhat1, n1s) with xhat1 recomputed from x and the dropped a; dx = cd(dr1),
// dattn = cd(dr1 keep1); zeros for dead tokens. One warp per token; the
// warps' dn1s / dn1b column sums go through red_s [kWarps][2][H] and the
// block adds them in warp order into its partial.
template <typename T, int H>
__device__ void ln1_backward(const InputArgs& p, const float* du_s, float* red_s, long long tok0,
                             int ntok) {
  constexpr int V = H / 32;
  const T* __restrict__ x = static_cast<const T*>(p.x);
  const T* __restrict__ a = static_cast<const T*>(p.a);
  const T* __restrict__ dr2 = static_cast<const T*>(p.dr2);
  T* __restrict__ dx = static_cast<T*>(p.dx);
  T* __restrict__ dattn = static_cast<T*>(p.dattn);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* mine = red_s + warp * 2 * H;
  for (int c = lane; c < 2 * H; c += 32) mine[c] = 0.f;
  const uint32_t lane1 = p.drop.lane(kTagAttnDrop);
  for (int i = warp; i < ntok; i += kWarps) {
    const long long tok = tok0 + i;
    if (!is_live(p.live, tok)) {
      for (int c = lane; c < H; c += 32) {
        dx[tok * H + c] = from_float<T>(0.f);
        dattn[tok * H + c] = from_float<T>(0.f);
      }
      continue;
    }
    float xv[V], dv[V], s = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = lane + 32 * j;
      xv[j] = residual1<T>(x, a, tok * H + c, p.drop, lane1, tok, H, c);
      s += xv[j];
      s2 = fmaf(xv[j], xv[j], s2);
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mu = s / H, rstd = rsqrtf(fmaxf(0.f, s2 / H - mu * mu) + p.eps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = lane + 32 * j;
      xv[j] = (xv[j] - mu) * rstd;  // xhat1
      dv[j] = du_s[i * H + c] + to_float(dr2[tok * H + c]);
      const float dxhat = dv[j] * p.n1s[c];
      m1 += dxhat;
      m2 += dxhat * xv[j];
    }
    m1 = warp_sum(m1) / H;
    m2 = warp_sum(m2) / H;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = lane + 32 * j;
      const float d = rstd * (dv[j] * p.n1s[c] - m1 - xv[j] * m2);
      dx[tok * H + c] = from_float<T>(d);
      dattn[tok * H + c] =
          from_float<T>(p.drop.on ? d * p.drop.keep_scale(lane1, tok, H, c) : d);
      mine[c] += dv[j] * xv[j];
      mine[H + c] += dv[j];
    }
  }
  __syncthreads();
  float* out = p.partial_ln + blockIdx.x * 2LL * H;
  for (int c = threadIdx.x; c < 2 * H; c += kThreads) {
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += red_s[w * 2 * H + c];
    out[c] = sum;
  }
}

// dh2 = cd(dr2 keep2) of the block's rows into dh2_s (row stride ld), zeros
// past ntok and for dead tokens; u (from u_s) and dh2 rows to the scratch.
template <typename T, typename E, int H>
__device__ void stage_dh2(const InputArgs& p, const E* u_s, E* dh2_s, int ld, long long tok0,
                          int ntok, int rows) {
  const T* __restrict__ dr2 = static_cast<const T*>(p.dr2);
  T* __restrict__ u = static_cast<T*>(p.u);
  T* __restrict__ dh2 = static_cast<T*>(p.dh2);
  const uint32_t lane2 = p.drop.lane(kTagOutDrop);
  for (int idx = threadIdx.x; idx < rows * H; idx += kThreads) {
    const int i = idx / H, c = idx % H;
    const long long tok = tok0 + i;
    float v = 0.f;
    if (i < ntok && is_live(p.live, tok)) {
      v = to_float(dr2[tok * H + c]);
      if (p.drop.on) v = round_to<T>(v * p.drop.keep_scale(lane2, tok, H, c));
    }
    dh2_s[i * ld + c] = from_float<E>(v);
    if (i < ntok) {
      dh2[tok * H + c] = from_float<T>(v);
      u[tok * H + c] = is_live(p.live, tok) ? from_float<T>(to_float(u_s[i * ld + c])) : from_float<T>(0.f);
    }
  }
}

// f32: SIMT, kTMF tokens a block ------------------------------------------------

template <int NC>
constexpr size_t input_smem_bytes() {
  constexpr int H = NC * 64, w = 2 * kKT1 * kFC > kKT2 * H ? 2 * kKT1 * kFC : kKT2 * H;
  return sizeof(float) * (size_t)(2 * kTMF * H + kTMF * kFC + w);
}

template <int NC>
__global__ void __launch_bounds__(kThreads, 1) tail_bwd_input_kernel(InputArgs p) {
  constexpr int H = NC * 64, RM = kTMF / 4;  // rows of each SIMT thread (ty = tid / 64)
  const float* __restrict__ w1 = static_cast<const float*>(p.w1);
  const float* __restrict__ w1t = static_cast<const float*>(p.w1t);
  const float* __restrict__ w2t = static_cast<const float*>(p.w2t);
  float* __restrict__ dh1 = static_cast<float*>(p.dh1);
  float* __restrict__ h1d = static_cast<float*>(p.h1d);

  extern __shared__ float smem[];
  float* u_s = smem;                // [kTMF][H]: u, later du
  float* dh2_s = u_s + kTMF * H;    // [kTMF][H]: dh2, later the warps' column sums
  float* h_s = dh2_s + kTMF * H;    // [kTMF][kFC]: dh1 of one chunk
  float* w_s = h_s + kTMF * kFC;    // W1 and W2^T slices, or a W1^T slice
  static_assert(kWarps * 2 == kTMF, "the column sums of ln1_backward fill dh2_s");

  const int tid = threadIdx.x, tx = tid & 63, ty = tid >> 6;
  const long long tok0 = (long long)blockIdx.x * kTMF;
  const int ntok = (int)min((long long)kTMF, p.tokens - tok0);
  if (!tokens_have_live(p.live, tok0, ntok)) {
    zero_input_block<float, H>(p, tok0, ntok);
    return;
  }
  layer_norm1<float, float, H, true>(static_cast<const float*>(p.x),
                                     static_cast<const float*>(p.a), p.n1s, p.n1b, p.eps, p.drop,
                                     u_s, H, tok0, ntok, kTMF);
  __syncthreads();
  stage_dh2<float, float, H>(p, u_s, dh2_s, H, tok0, ntok, kTMF);

  float acc[RM][NC];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[r][j] = 0.f;
  __syncthreads();

  const uint32_t lane_mid = p.drop.lane(kTagMidDrop);
  for (int c0 = 0; c0 < p.ff; c0 += kFC) {
    float zacc[RM][kFC / 64], dacc[RM][kFC / 64];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int j = 0; j < kFC / 64; ++j) zacc[r][j] = dacc[r][j] = 0.f;
    for (int k0 = 0; k0 < H; k0 += kKT1) {
      for (int i = tid; i < kKT1 * kFC; i += kThreads) {
        const int kk = i / kFC, c = i % kFC;
        w_s[i] = w1[(long long)(k0 + kk) * p.ff + c0 + c];
        w_s[kKT1 * kFC + i] = w2t[(long long)(k0 + kk) * p.ff + c0 + c];
      }
      __syncthreads();
      tile_fma<RM, kFC / 64>(zacc, u_s + k0, H, ty * RM, w_s, kFC, tx, kKT1);
      tile_fma<RM, kFC / 64>(dacc, dh2_s + k0, H, ty * RM, w_s + kKT1 * kFC, kFC, tx, kKT1);
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kFC / 64; ++j) {
      const int c = tx + 64 * j;
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const int i = ty * RM + r;
        const long long tok = tok0 + i;
        float2 hg = hidden_grads<float>(p, zacc[r][j], dacc[r][j], lane_mid, tok, c0 + c);
        if (i >= ntok || !is_live(p.live, tok)) hg = make_float2(0.f, 0.f);
        h_s[i * kFC + c] = hg.x;
        if (i < ntok) {
          dh1[tok * p.ff + c0 + c] = hg.x;
          h1d[tok * p.ff + c0 + c] = hg.y;
        }
      }
    }
    __syncthreads();
    if (tid < kFC) {  // db1: the chunk's column sums of dh1 over the block's tokens
      float sum = 0.f;
      for (int i = 0; i < kTMF; ++i) sum += h_s[i * kFC + tid];
      p.partial_b1[(long long)blockIdx.x * p.ff + c0 + tid] = sum;
    }
    for (int k0 = 0; k0 < kFC; k0 += kKT2) {
      for (int i = tid; i < kKT2 * H; i += kThreads) {
        w_s[i] = w1t[(long long)(c0 + k0) * H + i];
      }
      __syncthreads();
      tile_fma<RM, NC>(acc, h_s + k0, kFC, ty * RM, w_s, H, tx, kKT2);
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) u_s[(ty * RM + r) * H + tx + 64 * j] = acc[r][j];
  __syncthreads();
  ln1_backward<float, H>(p, u_s, dh2_s, tok0, ntok);
}

// bf16: tensor cores, kTM tokens a block ----------------------------------------

// The du product streams [kKS2, H] slices of W1^T; from H = 960 (NC = 15)
// a ring of two keeps the block inside the 227 KB of shared memory
// (H = 896: 228,096 bytes with three; H = 960: 242,432 with three, 211,456
// with two).
template <int NC>
__host__ __device__ constexpr int du_stages() {
  return NC >= 15 ? 2 : kStages;
}

template <int NC>
__host__ __device__ constexpr int input_stage_elems() {
  constexpr int s1 = stage_elems<kKS1, kFC>(), s2 = stage_elems<kKS2, NC * 64, du_stages<NC>()>();
  return s1 > s2 ? s1 : s2;
}

template <int NC>
constexpr size_t input_tc_smem_bytes() {
  constexpr int H = NC * 64;
  return sizeof(bf16) * ((size_t)2 * kTM * (H + kPad) + 2 * kTM * (kFC + kPad) +
                         input_stage_elems<NC>()) +
         sizeof(float) * kWarps * 256;
}

template <int NC>
__global__ void __launch_bounds__(kThreads, 1) tail_bwd_input_tc_kernel(InputArgs p) {
  using Tile = WarpTile<NC>;
  constexpr int H = NC * 64, LDU = H + kPad, LDH = kFC + kPad;
  static_assert(sizeof(float) * kTM * H <= sizeof(bf16) * 2 * kTM * LDU, "du fits over u_s, dh2_s");
  static_assert(sizeof(float) * kWarps * 2 * H <= sizeof(bf16) * input_stage_elems<NC>(),
                "the column sums fit in the ring");
  const bf16* __restrict__ w1 = static_cast<const bf16*>(p.w1);
  const bf16* __restrict__ w1t = static_cast<const bf16*>(p.w1t);
  const bf16* __restrict__ w2t = static_cast<const bf16*>(p.w2t);
  bf16* __restrict__ dh1 = static_cast<bf16*>(p.dh1);
  bf16* __restrict__ h1d = static_cast<bf16*>(p.h1d);

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* u_s = reinterpret_cast<bf16*>(smem_raw);  // [kTM][LDU]: u
  bf16* dh2_s = u_s + kTM * LDU;                  // [kTM][LDU]: cd(dh2)
  bf16* h_s = dh2_s + kTM * LDU;                  // [kTM][LDH]: cd(dh1) of one chunk
  bf16* g_s = h_s + kTM * LDH;                    // [kTM][LDH]: h1d of one chunk
  bf16* stages = g_s + kTM * LDH;                 // ring of W1 / W2^T / W1^T slices
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* scratch = reinterpret_cast<float*>(stages + input_stage_elems<NC>()) + warp * 256;

  const long long tok0 = (long long)blockIdx.x * kTM;
  const int ntok = (int)min((long long)kTM, p.tokens - tok0);
  if (!tokens_have_live(p.live, tok0, ntok)) {
    zero_input_block<bf16, H>(p, tok0, ntok);
    return;
  }
  layer_norm1<bf16, bf16, H, true>(static_cast<const bf16*>(p.x), static_cast<const bf16*>(p.a),
                                   p.n1s, p.n1b, p.eps, p.drop, u_s, LDU, tok0, ntok, kTM);
  __syncthreads();
  stage_dh2<bf16, bf16, H>(p, u_s, dh2_s, LDU, tok0, ntok, kTM);

  const int rf0 = Tile::row0(warp), cf0 = Tile::col0(warp);
  FragC acc[Tile::kRF][Tile::kCF];
  zero(acc);
  __syncthreads();

  const uint32_t lane_mid = p.drop.lane(kTagMidDrop);
  for (int c0 = 0; c0 < p.ff; c0 += kFC) {
    // z1 - b1 and dh2 W2^T of the chunk: this warp's column fragment, both
    // row fragments, each element of the two in the same lane.
    FragC zacc[2][1], dacc[2][1];
    zero(zacc);
    zero(dacc);
    gemm_streamed<2, 1, kKS1>(zacc, u_s, LDU, BCols<1, kFC>{{w1 + c0}, p.ff}, H, stages, warp);
    gemm_streamed<2, 1, kKS1>(dacc, dh2_s, LDU, BCols<1, kFC>{{w2t + c0}, p.ff}, H, stages, warp);
    float colsum = 0.f;  // this lane's rows of dh1's column warp * 16 + lane % 16
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float zv[8];
      wmma::store_matrix_sync(scratch, zacc[r][0], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e) zv[e] = scratch[lane + 32 * e];
      __syncwarp();
      wmma::store_matrix_sync(scratch, dacc[r][0], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int idx = lane + 32 * e, row = r * 16 + idx / 16, c = warp * 16 + idx % 16;
        const long long tok = tok0 + row;
        float2 hg = hidden_grads<bf16>(p, zv[e], scratch[idx], lane_mid, tok, c0 + c);
        if (row >= ntok || !is_live(p.live, tok)) hg = make_float2(0.f, 0.f);
        colsum += hg.x;
        h_s[row * LDH + c] = from_float<bf16>(hg.x);
        g_s[row * LDH + c] = from_float<bf16>(hg.y);
      }
      __syncwarp();
    }
    colsum += __shfl_xor_sync(0xffffffffu, colsum, 16);
    if (lane < 16) p.partial_b1[(long long)blockIdx.x * p.ff + c0 + warp * 16 + lane] = colsum;
    // du += cd(dh1) @ W1^T[c0 : c0 + kFC, :]; gemm_streamed synchronises the
    // block before it reads h_s and after.
    gemm_streamed<Tile::kRF, Tile::kCF, kKS2, du_stages<NC>()>(
        acc, h_s + rf0 * 16 * LDH, LDH, BCols<1, H>{{w1t + (long long)c0 * H}, H}, kFC, stages,
        cf0);
    for (int idx = tid; idx < ntok * (kFC / 8); idx += kThreads) {  // 16-byte rows of the chunk
      const int i = idx / (kFC / 8), c = (idx % (kFC / 8)) * 8;
      const long long g = (tok0 + i) * p.ff + c0 + c;
      *reinterpret_cast<uint4*>(dh1 + g) = *reinterpret_cast<const uint4*>(h_s + i * LDH + c);
      *reinterpret_cast<uint4*>(h1d + g) = *reinterpret_cast<const uint4*>(g_s + i * LDH + c);
    }
  }

  // du = the accumulator, over u_s and dh2_s (both free now); then LN1.
  float* du_s = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int r = 0; r < Tile::kRF; ++r)
#pragma unroll
    for (int j = 0; j < Tile::kCF; ++j)
      wmma::store_matrix_sync(du_s + (rf0 + r) * 16 * H + (cf0 + j) * 16, acc[r][j], H,
                              wmma::mem_row_major);
  __syncthreads();
  ln1_backward<bf16, H>(p, du_s, reinterpret_cast<float*>(stages), tok0, ntok);
}

template <int NC, bool kTensorCores>
int launch_input(const InputArgs& a, int rows_per_block, cudaStream_t s) {
  if (rows_per_block != (kTensorCores ? kTM : kTMF)) return -1;
  auto kernel = kTensorCores ? tail_bwd_input_tc_kernel<NC> : tail_bwd_input_kernel<NC>;
  const size_t smem = kTensorCores ? input_tc_smem_bytes<NC>() : input_smem_bytes<NC>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (a.tokens + rows_per_block - 1) / rows_per_block;
  if (grid > 0) kernel<<<(int)grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool kTensorCores>
int dispatch_input(int nc, const InputArgs& a, int rows_per_block, cudaStream_t s) {
  switch (nc) {
#define STLT_CASE(n) \
    case n: return launch_input<n, kTensorCores>(a, rows_per_block, s);
    STLT_NC_CASES(STLT_CASE)
#undef STLT_CASE
    default: return -1;
  }
}

// --- weight: dW1 = u^T cd(dh1), dW2 = h1d^T dh2 -------------------------------

struct WeightArgs {
  const void* u;    // [tokens, H]
  const void* dh1;  // [tokens, FF]
  const void* h1d;  // [tokens, FF]
  const void* dh2;  // [tokens, H]
  float* partial;   // [splits][2][H * FF]: dW1 [H, FF], then dW2 [FF, H]
  long long tokens;  // a multiple of kKW (the scratch rows past the last token are zeros)
  long long chunk;   // tokens per split, a multiple of kKW
  int hidden;
  int ff;
};

// The output tile of block (blockIdx.x, split blockIdx.y): tiles of dW1
// (64 x 128 over [H, FF]) first, then of dW2 (128 x 64 over [FF, H]).
struct WeightTile {
  const void* A;  // [tokens, M], read as A^T
  const void* B;  // [tokens, N]
  int lda, ldb, m0, n0;
  bool first;     // a dW1 tile
  float* out;     // the tile's first element in the split's partial
  long long k_begin, k_end;
};

__device__ __forceinline__ WeightTile weight_tile(const WeightArgs& p) {
  const int H = p.hidden, FF = p.ff, tiles1 = (H / 64) * (FF / 128);
  WeightTile t;
  float* part = p.partial + (long long)blockIdx.y * 2 * H * FF;
  int b = blockIdx.x;
  t.first = b < tiles1;
  if (t.first) {
    t.m0 = (b / (FF / 128)) * 64;
    t.n0 = (b % (FF / 128)) * 128;
    t.A = p.u, t.lda = H, t.B = p.dh1, t.ldb = FF;
    t.out = part + (long long)t.m0 * FF + t.n0;
  } else {
    b -= tiles1;
    t.m0 = (b / (H / 64)) * 128;
    t.n0 = (b % (H / 64)) * 64;
    t.A = p.h1d, t.lda = FF, t.B = p.dh2, t.ldb = H;
    t.out = part + (long long)H * FF + (long long)t.m0 * H + t.n0;
  }
  t.k_begin = blockIdx.y * p.chunk;
  t.k_end = min(p.tokens, t.k_begin + p.chunk);
  return t;
}

// f32: each thread (ty, tx) of a 16 x 16 grid owns rows ty + 16 r and
// columns tx + 16 c of the TM x TN tile.
template <int TM, int TN>
__device__ void weight_tile_simt(const WeightTile& t, int ldo, float* a_s, float* b_s) {
  constexpr int RM = TM / 16, RN = TN / 16;
  const float* __restrict__ A = static_cast<const float*>(t.A);
  const float* __restrict__ B = static_cast<const float*>(t.B);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[RM][RN] = {};
  for (long long k0 = t.k_begin; k0 < t.k_end; k0 += kKW) {
    for (int i = tid; i < kKW * TM; i += kThreads) {
      a_s[i] = A[(k0 + i / TM) * t.lda + t.m0 + i % TM];
    }
    for (int i = tid; i < kKW * TN; i += kThreads) {
      b_s[i] = B[(k0 + i / TN) * t.ldb + t.n0 + i % TN];
    }
    __syncthreads();
    for (int k = 0; k < kKW; ++k) {
      float av[RM], bv[RN];
#pragma unroll
      for (int r = 0; r < RM; ++r) av[r] = a_s[k * TM + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < RN; ++c) bv[c] = b_s[k * TN + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < RN; ++c) t.out[(long long)(ty + 16 * r) * ldo + tx + 16 * c] = acc[r][c];
}

__global__ void __launch_bounds__(kThreads) tail_bwd_weight_kernel(WeightArgs p) {
  __shared__ float a_s[kKW * 128], b_s[kKW * 128];
  const WeightTile t = weight_tile(p);
  if (t.first) {
    weight_tile_simt<64, 128>(t, p.ff, a_s, b_s);
  } else {
    weight_tile_simt<128, 64>(t, p.hidden, a_s, b_s);
  }
}

// bf16: WMMA with A^T read col-major from the staged token rows; warp w owns
// a 32 x 32 patch (2 x 2 fragments). Token steps are double-buffered with
// cp.async.
template <int TM, int TN>
__device__ void weight_tile_tc(const WeightTile& t, int ldo, bf16* a_st, bf16* b_st) {
  using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
  constexpr int LDA = TM + kPad, LDB = TN + kPad, WN = TN / 32;
  static_assert((TM / 32) * WN == kWarps, "one 32 x 32 patch per warp");
  const bf16* __restrict__ A = static_cast<const bf16*>(t.A);
  const bf16* __restrict__ B = static_cast<const bf16*>(t.B);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = (warp / WN) * 32, wn = (warp % WN) * 32;
  auto load = [&](int stage, long long k0) {
    bf16* as = a_st + stage * kKW * LDA;
    bf16* bs = b_st + stage * kKW * LDB;
    for (int c = tid; c < kKW * TM / 8; c += kThreads) {
      const int row = c / (TM / 8), col = (c % (TM / 8)) * 8;
      cp_async16(as + row * LDA + col, A + (k0 + row) * t.lda + t.m0 + col);
    }
    for (int c = tid; c < kKW * TN / 8; c += kThreads) {
      const int row = c / (TN / 8), col = (c % (TN / 8)) * 8;
      cp_async16(bs + row * LDB + col, B + (k0 + row) * t.ldb + t.n0 + col);
    }
  };
  FragC acc[2][2];
  zero(acc);
  const long long nsteps = (t.k_end - t.k_begin) / kKW;
  if (nsteps > 0) load(0, t.k_begin);
  cp_async_commit();
  for (long long s = 0; s < nsteps; ++s) {
    if (s + 1 < nsteps) load((int)((s + 1) & 1), t.k_begin + (s + 1) * kKW);
    cp_async_commit();
    cp_async_wait<1>();  // step s has landed
    __syncthreads();
    const bf16* as = a_st + (s & 1) * kKW * LDA;
    const bf16* bs = b_st + (s & 1) * kKW * LDB;
#pragma unroll
    for (int kk = 0; kk < kKW; kk += 16) {
      FragAT fa[2];
      FragB fb[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) wmma::load_matrix_sync(fa[r], as + kk * LDA + wm + r * 16, LDA);
#pragma unroll
      for (int c = 0; c < 2; ++c) wmma::load_matrix_sync(fb[c], bs + kk * LDB + wn + c * 16, LDB);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) wmma::mma_sync(acc[r][c], fa[r], fb[c], acc[r][c]);
    }
    __syncthreads();  // the stage is consumed before step s + 2 lands in it
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      wmma::store_matrix_sync(t.out + (long long)(wm + r * 16) * ldo + wn + c * 16, acc[r][c], ldo,
                              wmma::mem_row_major);
}

__global__ void __launch_bounds__(kThreads) tail_bwd_weight_tc_kernel(WeightArgs p) {
  __shared__ __align__(128) bf16 a_st[2 * kKW * (128 + kPad)];
  __shared__ __align__(128) bf16 b_st[2 * kKW * (128 + kPad)];
  const WeightTile t = weight_tile(p);
  if (t.first) {
    weight_tile_tc<64, 128>(t, p.ff, a_st, b_st);
  } else {
    weight_tile_tc<128, 64>(t, p.hidden, a_st, b_st);
  }
}

}  // namespace

// Each entry point returns 0, a cudaError_t from a launch, -1 for a shape it
// does not take (H not a multiple of 64 up to 1024, FF not a multiple of
// 128, a block or split size it was not built for) or -2 for an unknown
// dtype code (0 = float32, 1 = bfloat16). Activations are in the compute
// dtype, vectors and sums in f32; live is one byte per token or null;
// dropout/seed/thresh/dropout_scale as in stlt_fused_layer_tail.

// Row: dr2 and the partials of dn2s, dn2b, db2 ([blocks][3][H], block b
// owning tokens [b * chunk, (b + 1) * chunk)), then their sums into out [3][H].
extern "C" int stlt_tail_train_bwd_row(
    const void* r2, const void* g, const void* n2s, const void* live, void* dr2, float* partial,
    float* out, long long tokens, int hidden, float eps, int dropout, unsigned int seed,
    unsigned int thresh, float dropout_scale, int blocks, long long chunk, int dtype,
    void* stream) {
  if (hidden % 64 != 0 || blocks < 1 || chunk * blocks < tokens) return -1;
  RowArgs a{r2, g, static_cast<const float*>(n2s), static_cast<const uint8_t*>(live), dr2,
            partial, tokens, chunk, eps, TailDropout{dropout, seed, thresh, dropout_scale}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0) {
    err = dispatch_row<float>(hidden / 64, a, blocks, s);
  } else if (dtype == 1) {
    err = dispatch_row<bf16>(hidden / 64, a, blocks, s);
  } else {
    return -2;
  }
  if (err != 0) return err;
  return reduce_parts(partial, blocks, 3LL * hidden, out, s);
}

// Input: dx, dattn, the scratch u, dh2 [tokens, H] and dh1, h1d [tokens, FF]
// for the weight entry point, its db1 partials [blocks][FF], and dn1s, dn1b
// (partials [blocks][2][H], summed into out [2][H]). rows_per_block is 32 in
// bf16 and 16 in f32; blocks = ceil(tokens / rows_per_block).
extern "C" int stlt_tail_train_bwd_input(
    const void* x, const void* a, const void* dr2, const void* n1s, const void* n1b,
    const void* w1, const void* b1, const void* w1t, const void* w2t, const void* live, void* dx,
    void* dattn, void* u, void* dh2, void* dh1, void* h1d, float* partial_ln, float* partial_b1,
    float* out, long long tokens, int hidden, int ff, float eps, int act, int dropout,
    unsigned int seed, unsigned int thresh, float dropout_scale, int rows_per_block, int dtype,
    void* stream) {
  if (hidden % 64 != 0 || ff % kFC != 0 || act < 0 || act > 2) return -1;
  InputArgs p{x, a, dr2, static_cast<const float*>(n1s), static_cast<const float*>(n1b), w1,
              static_cast<const float*>(b1), w1t, w2t, static_cast<const uint8_t*>(live), dx,
              dattn, u, dh2, dh1, h1d, partial_ln, partial_b1, tokens, ff, eps, act,
              TailDropout{dropout, seed, thresh, dropout_scale}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0) {
    err = dispatch_input<false>(hidden / 64, p, rows_per_block, s);
  } else if (dtype == 1) {
    err = dispatch_input<true>(hidden / 64, p, rows_per_block, s);
  } else {
    return -2;
  }
  if (err != 0) return err;
  const int blocks = (int)((tokens + rows_per_block - 1) / rows_per_block);
  return reduce_parts(partial_ln, blocks, 2LL * hidden, out, s);
}

// Weight: dW1 [H, FF] and dW2 [FF, H] from the input entry point's scratch
// (rows padded to `tokens`, a multiple of 32, with zeros), split over
// `splits` token chunks of `chunk` tokens (a multiple of 32) into partial
// [splits][2][H * FF], then summed in split order into out_w (dW1, then
// dW2); db1 [FF] from the input entry point's b1_parts partials.
extern "C" int stlt_tail_train_bwd_weight(
    const void* u, const void* dh1, const void* h1d, const void* dh2, const float* partial_b1,
    int b1_parts, float* partial, float* out_w, float* db1, long long tokens, long long chunk,
    int splits, int hidden, int ff, int dtype, void* stream) {
  if (hidden % 64 != 0 || ff % 128 != 0 || tokens % kKW != 0 || chunk % kKW != 0 ||
      splits < 1 || chunk * splits < tokens) {
    return -1;
  }
  if (dtype != 0 && dtype != 1) return -2;
  WeightArgs p{u, dh1, h1d, dh2, partial, tokens, chunk, hidden, ff};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(2 * (hidden / 64) * (ff / 128), splits);
  if (dtype == 1) {
    tail_bwd_weight_tc_kernel<<<grid, kThreads, 0, s>>>(p);
  } else {
    tail_bwd_weight_kernel<<<grid, kThreads, 0, s>>>(p);
  }
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  err = reduce_parts(partial, splits, 2LL * hidden * ff, out_w, s);
  if (err != 0) return err;
  return reduce_parts(partial_b1, b1_parts, ff, db1, s);
}
