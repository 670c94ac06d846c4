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
//         u = LN1(x + drop(a)) recomputed; dh2 = cd(dr2 keep2);
//         z1 = u W1 + b1 (f32), dh1 = (dh2 W2^T) keepm act'(z1) with act'
//         taken on the f32 z1; du = dr2 + cd(dh1) W1^T (f32);
//         dr1 = ln_bwd(du, xhat1, n1s); dx = cd(dr1), dattn = cd(dr1 keep1);
//         dn1s = sum du xhat1, dn1b = sum du
// weight (_tail_train_bwd_weight_kernel :459)
//         dW1 = u^T cd(dh1), db1 = sum dh1 (the f32 dh1), dW2 = h1d^T dh2
//         with h1d = cd(act_cd(cd(z1)) keepm), the forward's dropped hidden
//
// The keep bits are the forward's (common.cuh::TailDropout), hashed at each
// token's global index. The cotangent of a dead token (live flag 0) counts
// as zero, as JAX masks g on entry: its dr2, dx and dattn are exact zeros and
// it adds nothing to any sum. The weights come in the model's storage: W1 as
// linear1.weight [FF, H], W2^T as linear2.weight [H, FF].
//
// Design. The TPU kernels carry their sums over tokens across a sequential
// grid, and the weight kernel recomputes z1 and dh1 in VMEM beside [H, chunk]
// f32 accumulators. On this card blocks run in parallel in no order and a
// block holds at most 227 KB, far less than those accumulators at H = 768,
// so every sum over tokens is a split reduction without atomics: each block
// writes the partial sum of its own tokens (or tile, or token split) and
// reduce_parts_kernel adds the partials in order, so two runs give the same
// bits. The row entry point is one warp per token, in 264 blocks or fewer of
// contiguous tokens.
//
// bf16: Hopper's tensor cores through wgmma on TMA-fed tiles
// (tail_gemm.cuh). Bound on this card: five GEMMs of 2*tokens*H*FF flops
// (three in row 13, two in row 14) over ~10 x 2*tokens*H bytes of
// activations, far above the ~295 flop/byte ridge, so the tensor cores bound
// both entry points. The WMMA kernels this replaces (32-token blocks that
// streamed W1, W2^T and W1^T through cp.async once a block, ~14 MB of
// weights each, and 17 token splits of f32 partials) ran at 62 and 130
// TFLOP/s. wgmma's 64-row tile makes a [64, H] f32 accumulator too large to
// keep du beside the hidden side, so the chain splits at its rounding points
// (u, dh2, cd(dh1) and h1d are bf16 in the contract; du stays f32), over the
// live tokens packed in order, as the forward does:
//
//   row 13 (launch_input_tc): the scan packing the live tokens; a prologue
//     row kernel (packed u and dh2, zeros in the packed rows up to the next
//     k step, the dead tokens' dx and dattn zeros); GEMM A, z1 = u W1 and
//     dh1d = dh2 W2^T into two accumulators of one [128, 64] tile, whose
//     epilogue writes cd(dh1), h1d and the tile's db1 column sums; GEMM B,
//     du_s = cd(dh1) W1^T in f32; an LN1-backward row kernel (dx, dattn at
//     each token's own row, the dn1s / dn1b partials);
//   row 14 (launch_weight_tc): GEMM C, dW1 = u^T cd(dh1) and dW2 = h1d^T dh2
//     with the packed rows as depth (both operands MN-major), in [128, 128]
//     output tiles over a few token splits chosen from the token count alone,
//     then the ordered sums.
//
// Each weight is read where it lies, K-major or MN-major (imm-trans-b), so
// the wrapper copies none. Dead tokens are packed out, so the GEMMs do only
// live work; a tile or split past the live rows computes nothing and still
// writes its zeros.
//
// f32: SIMT on the f32 pipes, so f32 stays true f32. input: one block per
// 16 tokens, the FF chunks of 128 looped inside it (z1 and dh2 W2^T, then
// du accumulated in registers); it writes u, dh2, cd(dh1) and h1d to
// scratch for weight: dW1 and dW2 tiled 64 x 128 / 128 x 64 over the
// output and split over token chunks.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"
#include "layer_tail.cuh"
#include "tail_gemm.cuh"

namespace {

using namespace stlt;
using namespace stlt::tail;

constexpr int kFC = 128;   // FF chunk of the f32 input kernel
constexpr int kKT1 = 16;   // k-slice of W1 / W2^T staged per SIMT step
constexpr int kKT2 = 8;    // k-slice of W1^T staged per SIMT step
constexpr int kLDW1 = kFC + 1;  // row stride of the staged W1 slice (its columns are written k-wise)
constexpr int kTMF = 16;   // tokens of one f32 input block
constexpr int kKW = 32;    // tokens per step of the f32 weight products

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
    const uint32_t rc2 = p.drop.on ? p.drop.row_counter(tok, H) : 0u;
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
      mine[2 * H + c] += p.drop.on ? d * p.drop.keep_at(lane2, rc2, c) : d;
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
  const void* w1;  // W1 stored [FF, H] (linear1.weight)
  const float* b1;
  const void* w2;  // W2^T stored [H, FF] (linear2.weight)
  const uint8_t* live;
  void* dx;
  void* dattn;
  void* u;    // scratch [tokens, H]: u (cd)
  void* dh2;  // scratch [tokens, H]: cd(dr2 keep2)
  void* dh1;  // scratch [tokens, FF]: cd(dh1)
  void* h1d;  // scratch [tokens, FF]: the dropped hidden
  float* du;  // bf16: scratch [tokens, H], cd(dh1) W1^T (f32)
  int* rows;  // bf16 with live flags: [tokens] packed rows' tokens, then their count
  float* partial_ln;  // [blocks][2][H]: dn1s, dn1b
  float* partial_b1;  // f32: [blocks][FF]; bf16: [ceil(tokens / kBM)][FF]
  long long tokens;
  int ff;
  float eps;
  int act;
  TailDropout drop;
};

// dh1 and the dropped hidden of one (token, FF column f) from z = z1 (f32,
// b1 added) and dacc = dh2 W2^T (f32): dh1 = dacc keepm act'(z1), h1d =
// cd(act_cd(cd(z1)) keepm). rc_mid: the token's row_counter over FF features.
template <typename T>
__device__ __forceinline__ float2 hidden_grads(float z, float dacc, int act, const TailDropout& drop,
                                               uint32_t lane_mid, uint32_t rc_mid, int f) {
  float h1 = activation<T>(round_to<T>(z), act);
  if (drop.on) {
    const float k = drop.keep_at(lane_mid, rc_mid, f);
    dacc *= k;
    h1 = round_to<T>(h1 * k);
  }
  return make_float2(dacc * activation_grad(z, act), h1);
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
    const uint32_t rc1 = p.drop.on ? p.drop.row_counter(tok, H) : 0u;
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
      xv[j] = residual1<T>(x, a, tok * H + c, p.drop, lane1, rc1, c);
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
          from_float<T>(p.drop.on ? d * p.drop.keep_at(lane1, rc1, c) : d);
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
      if (p.drop.on) v = round_to<T>(v * p.drop.keep_at(lane2, p.drop.row_counter(tok, H), c));
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
  constexpr int H = NC * 64, w1 = kKT1 * (kLDW1 + kFC), w = w1 > kKT2 * H ? w1 : kKT2 * H;
  return sizeof(float) * (size_t)(2 * kTMF * H + kTMF * kFC + w);
}

template <int NC>
__global__ void __launch_bounds__(kThreads, 1) tail_bwd_input_kernel(InputArgs p) {
  constexpr int H = NC * 64, RM = kTMF / 4;  // rows of each SIMT thread (ty = tid / 64)
  const float* __restrict__ w1 = static_cast<const float*>(p.w1);  // [FF, H]
  const float* __restrict__ w2t = static_cast<const float*>(p.w2);  // [H, FF]
  float* __restrict__ dh1 = static_cast<float*>(p.dh1);
  float* __restrict__ h1d = static_cast<float*>(p.h1d);

  extern __shared__ float smem[];
  float* u_s = smem;                // [kTMF][H]: u, later du
  float* dh2_s = u_s + kTMF * H;    // [kTMF][H]: dh2, later the warps' column sums
  float* h_s = dh2_s + kTMF * H;    // [kTMF][kFC]: dh1 of one chunk
  float* w_s = h_s + kTMF * kFC;    // W1 [kKT1][kLDW1] and W2^T slices, or a W1^T slice
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
  uint32_t rc_mid[RM];  // the row counters of this thread's tokens, FF features wide
#pragma unroll
  for (int r = 0; r < RM; ++r) rc_mid[r] = p.drop.on ? p.drop.row_counter(tok0 + ty * RM + r, p.ff) : 0u;
  for (int c0 = 0; c0 < p.ff; c0 += kFC) {
    float zacc[RM][kFC / 64], dacc[RM][kFC / 64];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int j = 0; j < kFC / 64; ++j) zacc[r][j] = dacc[r][j] = 0.f;
    for (int k0 = 0; k0 < H; k0 += kKT1) {
      for (int i = tid; i < kKT1 * kFC; i += kThreads) {
        const int kk = i / kFC, c = i % kFC;
        w_s[kKT1 * kLDW1 + i] = w2t[(long long)(k0 + kk) * p.ff + c0 + c];
        const int f = i / kKT1, k = i % kKT1;  // W1 column c0 + f: kKT1 contiguous k of its row
        w_s[k * kLDW1 + f] = w1[(long long)(c0 + f) * H + k0 + k];
      }
      __syncthreads();
      tile_fma<RM, kFC / 64>(zacc, u_s + k0, H, ty * RM, w_s, kLDW1, tx, kKT1);
      tile_fma<RM, kFC / 64>(dacc, dh2_s + k0, H, ty * RM, w_s + kKT1 * kLDW1, kFC, tx, kKT1);
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kFC / 64; ++j) {
      const int c = tx + 64 * j;
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const int i = ty * RM + r;
        const long long tok = tok0 + i;
        float2 hg = hidden_grads<float>(zacc[r][j] + p.b1[c0 + c], dacc[r][j], p.act, p.drop, lane_mid,
                                        rc_mid[r], c0 + c);
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
        w_s[i] = w1[(long long)(c0 + k0) * H + i];
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

template <int NC>
int launch_input_f32(const InputArgs& a, cudaStream_t s) {
  const size_t smem = input_smem_bytes<NC>();
  cudaError_t err = cudaFuncSetAttribute(tail_bwd_input_kernel<NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (a.tokens + kTMF - 1) / kTMF;
  if (grid > 0) tail_bwd_input_kernel<NC><<<(int)grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

int dispatch_input_f32(int nc, const InputArgs& a, cudaStream_t s) {
  switch (nc) {
#define STLT_CASE(n) \
    case n: return launch_input_f32<n>(a, s);
    STLT_NC_CASES(STLT_CASE)
#undef STLT_CASE
    default: return -1;
  }
}

// bf16: wgmma GEMMs over the packed live tokens ----------------------------------
//
// Packed row i of the scratch u, dh2, dh1, h1d and du holds token rows[i]
// (rows null: token i); rows at and past *count (count null: every token)
// hold no live token. The prologue and GEMM A write zeros into the packed
// rows from *count up to the next multiple of kBK, the depth GEMM C reads
// (the TMA maps span `tokens` rows and fill zeros only past them).

__device__ __forceinline__ int live_rows(const int* count, int tokens) {
  return count != nullptr ? *count : tokens;
}

struct PrologueArgs {
  const bf16* x;
  const bf16* a;
  const bf16* dr2;
  const float* n1s;
  const float* n1b;
  const uint8_t* live;
  const int* rows;
  const int* count;
  bf16* u;    // packed [tokens, H]
  bf16* dh2;  // packed [tokens, H]
  bf16* dx;
  bf16* dattn;
  int tokens, H;
  float eps;
  TailDropout drop;
};

// One warp a row i: packed row i's u = LN1(x + drop(a)) (tail_gemm.cuh::
// ln1_row, the forward's arithmetic) and dh2 = cd(dr2 keep2), or zeros in
// the packed rows from *count to the next k step; and, if token i is dead,
// its dx and dattn zeros.
__global__ void __launch_bounds__(32 * kRowWarps) tail_bwd_prologue_kernel(PrologueArgs p) {
  const int lane = threadIdx.x & 31, H = p.H;
  const long long i = (long long)blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (i >= p.tokens) return;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int M = live_rows(p.count, p.tokens);
  uint4* urow = reinterpret_cast<uint4*>(p.u + i * H);
  uint4* hrow = reinterpret_cast<uint4*>(p.dh2 + i * H);
  if (i < M) {
    const long long tok = p.rows != nullptr ? p.rows[i] : i;
    ln1_row(p.x, p.a, p.n1s, p.n1b, p.drop, p.eps, true, tok, H, p.u + i * H);
    const uint4* drow = reinterpret_cast<const uint4*>(p.dr2 + tok * H);
    const uint32_t lane2 = p.drop.lane(kTagOutDrop);
    const uint32_t rc2 = p.drop.on ? p.drop.row_counter(tok, H) : 0u;
    for (int vi = lane; vi < H / 8; vi += 32) {
      uint4 v = drow[vi];
      if (p.drop.on) {
        bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          e[j] = from_float<bf16>(to_float(e[j]) * p.drop.keep_at(lane2, rc2, vi * 8 + j));
        }
      }
      hrow[vi] = v;
    }
  } else if (i < round_up(M, kBK)) {
    for (int vi = lane; vi < H / 8; vi += 32) urow[vi] = hrow[vi] = zero;
  }
  if (p.live != nullptr && !p.live[i]) {
    for (int vi = lane; vi < H / 8; vi += 32) {
      reinterpret_cast<uint4*>(p.dx + i * H)[vi] = zero;
      reinterpret_cast<uint4*>(p.dattn + i * H)[vi] = zero;
    }
  }
}

// GEMM A. A block: a [kBM, kHiddenBN] tile of both z1 = u W1 and dh1d = dh2
// W2^T, two m64n64 accumulators a consumer warpgroup, two blocks an SM. One
// ring carries both products' k steps: steps [0, H / kBK) stage u and W1
// (stored [FF, H]: a K-major box of [kHiddenBN n, 64 k]), the next as many
// dh2 and W2^T (stored [H, FF]: MN-major boxes of [64 k, 64 n]).
constexpr int kHiddenBN = 64;
constexpr int kHiddenLDS = kHiddenBN + 8;  // f32 row stride of the parked tiles: conflict-free float2 writes
constexpr size_t kHiddenSmem =
    ring_smem(kBM * kBK, kHiddenBN * kBK, 2 * sizeof(float) * kBM * kHiddenLDS);

struct HiddenArgs {
  int tokens, H, FF;
  const float* b1;
  const int* rows;
  const int* count;
  bf16* dh1;          // packed [tokens, FF]: cd(dh1)
  bf16* h1d;          // packed [tokens, FF]: the dropped hidden
  float* partial_b1;  // [ceil(tokens / kBM)][FF]: the tiles' column sums of the f32 dh1
  int act;
  TailDropout drop;
};

__global__ void __launch_bounds__(kGemmThreads, 2)
    tail_bwd_hidden_kernel(const __grid_constant__ CUtensorMap map_u,
                           const __grid_constant__ CUtensorMap map_dh2,
                           const __grid_constant__ CUtensorMap map_w1,
                           const __grid_constant__ CUtensorMap map_w2, HiddenArgs p) {
  using namespace hopper;
  constexpr int BN = kHiddenBN, LDS = kHiddenLDS;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kBM;
  const int M = live_rows(p.count, p.tokens);
  float* part = p.partial_b1 + (long long)blockIdx.y * p.FF + n0;
  if (m0 >= M) {  // no live row: a zero partial (the ordered sum reads every tile's)
    if (threadIdx.x < BN) part[threadIdx.x] = 0.f;
    return;
  }

  extern __shared__ unsigned char smem_raw[];
  const Ring ring = make_ring(smem_raw, kBM * kBK, BN * kBK);
  const int nk = p.H / kBK;
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      produce(ring, 2 * nk, (kBM + BN) * kBK * sizeof(bf16), [&](int s, int k) {
        if (k < nk) {
          tma_load_2d(ring.a_stage(s), &map_u, &ring.full[s], k * kBK, m0);
          tma_load_2d(ring.b_stage(s), &map_w1, &ring.full[s], k * kBK, n0);
        } else {
          const int kh = (k - nk) * kBK;
          tma_load_2d(ring.a_stage(s), &map_dh2, &ring.full[s], kh, m0);
          for (int j = 0; j < BN / 64; ++j) {
            tma_load_2d(ring.b_stage(s) + j * 64 * kBK, &map_w2, &ring.full[s], n0 + 64 * j, kh);
          }
        }
      });
    }
    return;
  }

  const int w = threadIdx.x / 128, t = threadIdx.x % 128;
  float z[BN / 2], d[BN / 2];
  consume(ring, 2 * nk, [&](int s, int k) {
    const bf16* a = ring.a_stage(s) + w * 64 * kBK;
    const bf16* b = ring.b_stage(s);
    if (k < nk) {
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {  // the first product overwrites
        Wgmma<BN, 0, 0>::mma(z, desc_k(a, kk), desc_k(b, kk), k > 0 || kk > 0);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        Wgmma<BN, 0, 1>::mma(d, desc_k(a, kk), desc_mn(b, kk), k > nk || kk > 0);
      }
    }
  }, z, d);

  // Epilogue. Thread t of a warpgroup holds z1 and dh1d of the same (row,
  // column) pairs; it parks z1 + b1 and dh1d as f32 tiles in the ring, now
  // free. A rolled loop then takes 8 columns of a row per thread: dh1 in
  // f32 (kept in place of z1 for the column sums), cd(dh1) and h1d as
  // 16-byte rows of the packed scratch; rows from *count on write zeros.
  float* zs = reinterpret_cast<float*>(ring.a);  // [kBM][LDS]: z1, then the f32 dh1
  float* ds = zs + kBM * LDS;                    // [kBM][LDS]: dh1d, then the column sums' groups
  named_barrier_sync(1, kConsumers);  // both warpgroups' last wgmmas have read the ring
  {
    const int rl = w * 64 + (t / 32) * 16 + (t % 32) / 4, cl = 2 * (t % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = cl + 8 * j;
      const float2 bias = *reinterpret_cast<const float2*>(p.b1 + n0 + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<float2*>(zs + (rl + 8 * h) * LDS + c) =
            make_float2(z[4 * j + 2 * h] + bias.x, z[4 * j + 2 * h + 1] + bias.y);
        *reinterpret_cast<float2*>(ds + (rl + 8 * h) * LDS + c) =
            make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      }
    }
  }
  named_barrier_sync(1, kConsumers);
  const uint32_t lane_mid = p.drop.lane(kTagMidDrop);
  constexpr int kVecs = BN / 8;  // 16-byte column groups of a tile row
#pragma unroll 1
  for (int i = threadIdx.x; i < kBM * kVecs; i += kConsumers) {
    const int rl = i / kVecs, cl = (i % kVecs) * 8, row = m0 + rl;
    float4* zr = reinterpret_cast<float4*>(zs + rl * LDS + cl);
    uint4 gv = make_uint4(0u, 0u, 0u, 0u), hv = gv;
    float zv[8] = {};
    if (row < M) {
      const int tok = p.rows != nullptr ? p.rows[row] : row;  // the dropout bits' token
      const uint32_t rc_mid = p.drop.on ? p.drop.row_counter(tok, p.FF) : 0u;
      const float4* dr = reinterpret_cast<const float4*>(ds + rl * LDS + cl);
      const float4 z0 = zr[0], z1 = zr[1], d0 = dr[0], d1 = dr[1];
      const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
      zv[0] = z0.x, zv[1] = z0.y, zv[2] = z0.z, zv[3] = z0.w;
      zv[4] = z1.x, zv[5] = z1.y, zv[6] = z1.z, zv[7] = z1.w;
      bf16* ge = reinterpret_cast<bf16*>(&gv);
      bf16* he = reinterpret_cast<bf16*>(&hv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float2 hg = hidden_grads<bf16>(zv[e], dv[e], p.act, p.drop, lane_mid, rc_mid, n0 + cl + e);
        zv[e] = hg.x;
        ge[e] = from_float<bf16>(hg.x);
        he[e] = from_float<bf16>(hg.y);
      }
    }
    zr[0] = make_float4(zv[0], zv[1], zv[2], zv[3]);
    zr[1] = make_float4(zv[4], zv[5], zv[6], zv[7]);
    if (row < p.tokens) {
      const long long off = (long long)row * p.FF + n0 + cl;
      *reinterpret_cast<uint4*>(p.dh1 + off) = gv;
      *reinterpret_cast<uint4*>(p.h1d + off) = hv;
    }
  }
  named_barrier_sync(1, kConsumers);
  // db1: the tile's column sums of the f32 dh1, kGroups row groups a column
  // in row order, then the groups in order.
  constexpr int kGroups = kConsumers / BN, kGroupRows = kBM / kGroups;
  {
    const int c = threadIdx.x % BN, g = threadIdx.x / BN;
    float sum = 0.f;
    for (int r = g * kGroupRows; r < (g + 1) * kGroupRows; ++r) sum += zs[r * LDS + c];
    ds[g * BN + c] = sum;
  }
  named_barrier_sync(1, kConsumers);
  if (threadIdx.x < BN) {
    float sum = 0.f;
    for (int g = 0; g < kGroups; ++g) sum += ds[g * BN + threadIdx.x];
    part[threadIdx.x] = sum;
  }
}

// GEMM B: du_s = cd(dh1) W1^T [tokens, H] in f32. A block: a [kBM, 128]
// tile; A = the packed cd(dh1), K-major; B = W1^T, which W1's storage [FF,
// H] holds as [k, n]: MN-major boxes of [64 k, 64 n], none loaded past H.
// Rows from *count on are not written (the LN1 kernel reads live rows only).
constexpr int kDuBN = 128;
constexpr size_t kDuSmem = ring_smem(kBM * kBK, kDuBN * kBK);

__global__ void __launch_bounds__(kGemmThreads, 2)
    tail_bwd_du_kernel(const __grid_constant__ CUtensorMap map_dh1,
                       const __grid_constant__ CUtensorMap map_w1, int tokens, int H, int FF,
                       const int* count, float* du) {
  using namespace hopper;
  const int n0 = blockIdx.x * kDuBN, m0 = blockIdx.y * kBM;
  const int M = live_rows(count, tokens);
  if (m0 >= M) return;

  extern __shared__ unsigned char smem_raw[];
  const Ring ring = make_ring(smem_raw, kBM * kBK, kDuBN * kBK);
  const int nk = FF / kBK;
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      const int boxes = min(kDuBN, H - n0) / 64;
      produce(ring, nk, (kBM + boxes * 64) * kBK * sizeof(bf16), [&](int s, int k) {
        tma_load_2d(ring.a_stage(s), &map_dh1, &ring.full[s], k * kBK, m0);
        for (int j = 0; j < boxes; ++j) {
          tma_load_2d(ring.b_stage(s) + j * 64 * kBK, &map_w1, &ring.full[s], n0 + 64 * j, k * kBK);
        }
      });
    }
    return;
  }

  const int w = threadIdx.x / 128, t = threadIdx.x % 128;
  float acc[kDuBN / 2];
  consume(ring, nk, [&](int s, int k) {
    const bf16* a = ring.a_stage(s) + w * 64 * kBK;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {  // the first product overwrites
      Wgmma<kDuBN, 0, 1>::mma(acc, desc_k(a, kk), desc_mn(ring.b_stage(s), kk), k > 0 || kk > 0);
    }
  }, acc);
  const int rl = m0 + w * 64 + (t / 32) * 16 + (t % 32) / 4, cl = n0 + 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < kDuBN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rl + 8 * h, c = cl + 8 * j;
      if (r < M && c < H) {
        *reinterpret_cast<float2*>(du + (long long)r * H + c) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// LN1 backward over the packed rows: block b owns packed rows [b chunk,
// (b + 1) chunk), one warp a row; du = du_s + dr2 (f32), r1 recomputed
// (tail_gemm.cuh::residual_row), dr1 = ln_bwd(du, xhat1, n1s), dx = cd(dr1)
// and dattn = cd(dr1 keep1) at the token's own row. Each lane adds its
// columns' du xhat1 and du into its warp's slice of shared memory (kept out
// of registers, so that two blocks fit an SM); the block adds the warps'
// slices in warp order into its partial [2][H].
struct Ln1BwdArgs {
  const bf16* x;
  const bf16* a;
  const bf16* dr2;
  const float* n1s;
  const float* du;
  const int* rows;
  const int* count;
  bf16* dx;
  bf16* dattn;
  float* partial;  // [blocks][2][H]: dn1s, dn1b
  int tokens, H;
  long long chunk;
  float eps;
  TailDropout drop;
};

__host__ __device__ constexpr size_t ln1_bwd_smem(int H) { return sizeof(float) * kWarps * 2 * H; }

__global__ void __launch_bounds__(kThreads, 2) tail_bwd_ln1_kernel(Ln1BwdArgs p) {
  extern __shared__ float red[];  // [kWarps][2][H]: each warp's sums of du xhat1, then of du
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, H = p.H;
  const long long r0 = blockIdx.x * p.chunk;
  const long long r1 = min((long long)live_rows(p.count, p.tokens), r0 + p.chunk);
  const uint32_t lane1 = p.drop.lane(kTagAttnDrop);
  float* mine = red + warp * 2 * H;
  for (int c = lane; c < 2 * H; c += 32) mine[c] = 0.f;
  __syncwarp();  // the lanes add into words other lanes zeroed
  for (long long i = r0 + warp; i < r1; i += kWarps) {
    const long long tok = p.rows != nullptr ? p.rows[i] : i;
    const uint32_t rc1 = p.drop.on ? p.drop.row_counter(tok, H) : 0u;
    float v[kRowVecs][8], dv[kRowVecs][8];
    const float2 st = residual_row(p.x, p.a, p.drop, p.eps, tok, H, v);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int q = 0; q < kRowVecs; ++q) {
      const int vi = lane + 32 * q;
      if (vi * 8 >= H) continue;  // (no break: the loop unrolls, the arrays take constant indices)
      const float4* drow = reinterpret_cast<const float4*>(p.du + i * H + vi * 8);
      const float4 d0 = drow[0], d1 = drow[1];
      dv[q][0] = d0.x, dv[q][1] = d0.y, dv[q][2] = d0.z, dv[q][3] = d0.w;
      dv[q][4] = d1.x, dv[q][5] = d1.y, dv[q][6] = d1.z, dv[q][7] = d1.w;
      const uint4 gv = reinterpret_cast<const uint4*>(p.dr2 + tok * H)[vi];
      const bf16* ge = reinterpret_cast<const bf16*>(&gv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[q][e] = (v[q][e] - st.x) * st.y;  // xhat1
        dv[q][e] += to_float(ge[e]);
        const float dxhat = dv[q][e] * p.n1s[vi * 8 + e];
        m1 += dxhat;
        m2 += dxhat * v[q][e];
      }
    }
    m1 = warp_sum(m1) / H;
    m2 = warp_sum(m2) / H;
#pragma unroll
    for (int q = 0; q < kRowVecs; ++q) {
      const int vi = lane + 32 * q;
      if (vi * 8 >= H) continue;
      uint4 xo, ao;
      bf16* xe = reinterpret_cast<bf16*>(&xo);
      bf16* ae = reinterpret_cast<bf16*>(&ao);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = vi * 8 + e;
        const float d = st.y * (dv[q][e] * p.n1s[c] - m1 - v[q][e] * m2);
        xe[e] = from_float<bf16>(d);
        ae[e] = from_float<bf16>(p.drop.on ? d * p.drop.keep_at(lane1, rc1, c) : d);
        mine[e * (H / 8) + vi] += dv[q][e] * v[q][e];  // column c at e H / 8 + c / 8: lanes on
        mine[H + e * (H / 8) + vi] += dv[q][e];        // neighbouring words, no bank conflict
      }
      reinterpret_cast<uint4*>(p.dx + tok * H)[vi] = xo;
      reinterpret_cast<uint4*>(p.dattn + tok * H)[vi] = ao;
    }
  }
  __syncthreads();
  float* out = p.partial + blockIdx.x * 2LL * H;
  for (int c = threadIdx.x; c < 2 * H; c += kThreads) {
    const int at = (c / H) * H + (c % 8) * (H / 8) + (c % H) / 8;
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += red[w * 2 * H + at];
    out[c] = sum;
  }
}

// Sets a kernel's dynamic shared memory once a process (it costs host time
// at every small stage).
template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes, bool& done) {
  if (done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  done = err == cudaSuccess;
  return (int)err;
}

// Row 13 in bf16 (the launches of the note at the top), ln_blocks blocks of
// the LN1 kernel.
int launch_input_tc(const InputArgs& p, int H, int ln_blocks, cudaStream_t s) {
  const int tokens = (int)p.tokens, FF = p.ff;
  if (tokens < 1 || p.tokens > (1LL << 30) || H > 1024 || p.du == nullptr || ln_blocks < 1 ||
      (p.live != nullptr && p.rows == nullptr) || (tokens + kBM - 1) / kBM > 65535) {
    return -1;
  }
  const int* rows = nullptr;
  const int* count = nullptr;
  if (p.live != nullptr) {
    tail_live_rows_kernel<<<1, kScanThreads, 0, s>>>(p.live, tokens, p.rows, p.rows + tokens);
    rows = p.rows;
    count = p.rows + tokens;
  }
  bf16* u = static_cast<bf16*>(p.u);
  bf16* dh2 = static_cast<bf16*>(p.dh2);
  bf16* dh1 = static_cast<bf16*>(p.dh1);
  bf16* h1d = static_cast<bf16*>(p.h1d);
  CUtensorMap map_u, map_dh2, map_w1k, map_w2, map_dh1, map_w1;
  int err = hopper::make_map(&map_u, u, tokens, H, kBM);
  if (!err) err = hopper::make_map(&map_dh2, dh2, tokens, H, kBM);
  if (!err) err = hopper::make_map(&map_w1k, p.w1, FF, H, kHiddenBN);  // [FF, H]: K-major B of GEMM A
  if (!err) err = hopper::make_map(&map_w2, p.w2, H, FF, kBK);         // [H, FF]: MN-major B of GEMM A
  if (!err) err = hopper::make_map(&map_dh1, dh1, tokens, FF, kBM);
  if (!err) err = hopper::make_map(&map_w1, p.w1, FF, H, kBK);         // [FF, H]: MN-major B of GEMM B
  if (err) return err;

  const PrologueArgs pa{static_cast<const bf16*>(p.x), static_cast<const bf16*>(p.a),
                        static_cast<const bf16*>(p.dr2), p.n1s, p.n1b, p.live, rows, count, u, dh2,
                        static_cast<bf16*>(p.dx), static_cast<bf16*>(p.dattn), tokens, H, p.eps, p.drop};
  tail_bwd_prologue_kernel<<<(tokens + kRowWarps - 1) / kRowWarps, 32 * kRowWarps, 0, s>>>(pa);
  if ((err = (int)cudaGetLastError())) return err;

  static bool hidden_set = false, du_set = false, ln1_set = false;
  if ((err = set_smem(tail_bwd_hidden_kernel, kHiddenSmem, hidden_set))) return err;
  if ((err = set_smem(tail_bwd_du_kernel, kDuSmem, du_set))) return err;
  if ((err = set_smem(tail_bwd_ln1_kernel, ln1_bwd_smem(1024), ln1_set))) return err;
  const int mtiles = (tokens + kBM - 1) / kBM;
  const HiddenArgs ha{tokens, H, FF, p.b1, rows, count, dh1, h1d, p.partial_b1, p.act, p.drop};
  tail_bwd_hidden_kernel<<<dim3(FF / kHiddenBN, mtiles), kGemmThreads, kHiddenSmem, s>>>(
      map_u, map_dh2, map_w1k, map_w2, ha);
  if ((err = (int)cudaGetLastError())) return err;
  tail_bwd_du_kernel<<<dim3((H + kDuBN - 1) / kDuBN, mtiles), kGemmThreads, kDuSmem, s>>>(
      map_dh1, map_w1, tokens, H, FF, count, p.du);
  if ((err = (int)cudaGetLastError())) return err;

  const Ln1BwdArgs la{static_cast<const bf16*>(p.x), static_cast<const bf16*>(p.a),
                      static_cast<const bf16*>(p.dr2), p.n1s, p.du, rows, count,
                      static_cast<bf16*>(p.dx), static_cast<bf16*>(p.dattn), p.partial_ln, tokens, H,
                      (p.tokens + ln_blocks - 1) / ln_blocks, p.eps, p.drop};
  tail_bwd_ln1_kernel<<<ln_blocks, kThreads, ln1_bwd_smem(H), s>>>(la);
  return (int)cudaGetLastError();
}

// --- weight: dW1 = u^T cd(dh1), dW2 = h1d^T dh2 -------------------------------

struct WeightArgs {
  const void* u;    // [tokens, H]
  const void* dh1;  // [tokens, FF]
  const void* h1d;  // [tokens, FF]
  const void* dh2;  // [tokens, H]
  float* partial;   // [splits][2][H * FF]: dW1 [H, FF], then dW2 [FF, H]
  long long tokens;  // f32: a multiple of kKW (the scratch rows past the last token zeros); bf16: the scratch's rows
  long long chunk;   // tokens per split, a multiple of kKW (f32) or kBK (bf16)
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

// GEMM C (row 14): dW1 = u^T cd(dh1) [H, FF] and dW2 = h1d^T dh2 [FF, H]
// with the packed rows as depth. Block (x, y): output tile x of [128, 128]
// (dW1's tiles, then dW2's) over packed rows [y chunk, (y + 1) chunk) up to
// the live rows rounded up to kBK, into split y's partial; a tile whose range
// holds no live row writes zeros. Both operands are token rows, so both are
// read MN-major: A^T from [64 k, 64 m] boxes (imm-trans-a), B from [64 k,
// 64 n] boxes; no box past H is loaded.
constexpr int kWeightBT = 128;  // rows and columns of an output tile
constexpr size_t kWeightSmem = ring_smem(kWeightBT * kBK, kWeightBT * kBK);

struct WeightGemmArgs {
  int tokens, H, FF;
  long long chunk;  // packed rows a split, a multiple of kBK
  const int* count;
  float* partial;   // [splits][2][H * FF]: dW1 [H, FF], then dW2 [FF, H]
};

__global__ void __launch_bounds__(kGemmThreads, 2)
    tail_bwd_weight_gemm_kernel(const __grid_constant__ CUtensorMap map_u,
                                const __grid_constant__ CUtensorMap map_dh1,
                                const __grid_constant__ CUtensorMap map_h1d,
                                const __grid_constant__ CUtensorMap map_dh2, WeightGemmArgs p) {
  using namespace hopper;
  constexpr int BT = kWeightBT;
  const int H = p.H, FF = p.FF, htiles = (H + BT - 1) / BT, ftiles = FF / BT;
  int b = blockIdx.x, rows_out, cols_out, m0, n0;
  const CUtensorMap *map_a, *map_b;
  float* out = p.partial + (long long)blockIdx.y * 2 * H * FF;
  if (b < htiles * ftiles) {  // dW1 [H, FF]
    rows_out = H, cols_out = FF, m0 = (b / ftiles) * BT, n0 = (b % ftiles) * BT;
    map_a = &map_u, map_b = &map_dh1;
  } else {  // dW2 [FF, H]
    b -= htiles * ftiles;
    rows_out = FF, cols_out = H, m0 = (b / htiles) * BT, n0 = (b % htiles) * BT;
    map_a = &map_h1d, map_b = &map_dh2;
    out += (long long)H * FF;
  }
  const long long depth = round_up(live_rows(p.count, p.tokens), kBK);
  const long long k0 = blockIdx.y * p.chunk;
  const long long k1 = min(k0 + p.chunk, depth);
  const int nk = k1 > k0 ? (int)((k1 - k0) / kBK) : 0;

  extern __shared__ unsigned char smem_raw[];
  const Ring ring = make_ring(smem_raw, BT * kBK, BT * kBK);
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      const int abox = min(BT, rows_out - m0) / 64, bbox = min(BT, cols_out - n0) / 64;
      produce(ring, nk, (abox + bbox) * 64 * kBK * sizeof(bf16), [&](int s, int k) {
        const int kr = (int)(k0 + k * kBK);
        for (int j = 0; j < abox; ++j) {
          tma_load_2d(ring.a_stage(s) + j * 64 * kBK, map_a, &ring.full[s], m0 + 64 * j, kr);
        }
        for (int j = 0; j < bbox; ++j) {
          tma_load_2d(ring.b_stage(s) + j * 64 * kBK, map_b, &ring.full[s], n0 + 64 * j, kr);
        }
      });
    }
    return;
  }

  const int w = threadIdx.x / 128, t = threadIdx.x % 128;
  float acc[BT / 2];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) acc[i] = 0.f;
  consume(ring, nk, [&](int s, int) {
    const bf16* a = ring.a_stage(s) + w * 64 * kBK;  // this warpgroup's 64 rows: one [64 k, 64 m] box
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      Wgmma<BT, 1, 1>::mma(acc, desc_mn(a, kk), desc_mn(ring.b_stage(s), kk), 1);
    }
  }, acc);
  const int rl = m0 + w * 64 + (t / 32) * 16 + (t % 32) / 4, cl = n0 + 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rl + 8 * h, c = cl + 8 * j;
      if (r < rows_out && c < cols_out) {
        *reinterpret_cast<float2*>(out + (long long)r * cols_out + c) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// Row 14 in bf16 over row 13's packed scratch: GEMM C into `partial`.
int launch_weight_tc(const WeightArgs& p, const int* count, int splits, cudaStream_t s) {
  const int tokens = (int)p.tokens, H = p.hidden, FF = p.ff;
  if (tokens < 1 || p.tokens > (1LL << 30) || H > 1024 || p.chunk % kBK != 0 ||
      p.chunk * splits < p.tokens) {
    return -1;
  }
  CUtensorMap map_u, map_dh1, map_h1d, map_dh2;
  int err = hopper::make_map(&map_u, p.u, tokens, H, kBK);
  if (!err) err = hopper::make_map(&map_dh1, p.dh1, tokens, FF, kBK);
  if (!err) err = hopper::make_map(&map_h1d, p.h1d, tokens, FF, kBK);
  if (!err) err = hopper::make_map(&map_dh2, p.dh2, tokens, H, kBK);
  if (err) return err;
  static bool smem_set = false;
  if ((err = set_smem(tail_bwd_weight_gemm_kernel, kWeightSmem, smem_set))) return err;
  const int tiles = 2 * ((H + kWeightBT - 1) / kWeightBT) * (FF / kWeightBT);
  const WeightGemmArgs wa{tokens, H, FF, p.chunk, count, p.partial};
  tail_bwd_weight_gemm_kernel<<<dim3(tiles, splits), kGemmThreads, kWeightSmem, s>>>(
      map_u, map_dh1, map_h1d, map_dh2, wa);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point returns 0, a cudaError_t from a launch, -1 for a shape it
// does not take (H not a multiple of 64 up to 1024, FF not a multiple of
// 128, a block or split count it was not built for), -2 for an unknown
// dtype code (0 = float32, 1 = bfloat16) or -3 if a TMA map cannot be
// encoded. Activations are in the compute dtype, vectors and sums in f32;
// live is one byte per token (16-byte aligned in bf16) or null;
// dropout/seed/thresh/dropout_scale and the token map (token_base,
// token_period, token_stride, token_magic) as in stlt_fused_layer_tail.

// Row: dr2 and the partials of dn2s, dn2b, db2 ([blocks][3][H], block b
// owning tokens [b * chunk, (b + 1) * chunk)), then their sums into out [3][H].
extern "C" int stlt_tail_train_bwd_row(
    const void* r2, const void* g, const void* n2s, const void* live, void* dr2, float* partial,
    float* out, long long tokens, int hidden, float eps, int dropout, unsigned int seed,
    unsigned int thresh, float dropout_scale, long long token_base, unsigned int token_period,
    unsigned int token_stride, unsigned int token_magic, int blocks, long long chunk, int dtype,
    void* stream) {
  if (hidden % 64 != 0 || blocks < 1 || chunk * blocks < tokens) return -1;
  RowArgs a{r2, g, static_cast<const float*>(n2s), static_cast<const uint8_t*>(live), dr2,
            partial, tokens, chunk, eps,
            TailDropout{dropout, seed, thresh, dropout_scale,
                        RowMap{static_cast<uint32_t>(token_base), token_period, token_stride,
                               token_magic}}};
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
// for the weight entry point, its db1 partials and dn1s, dn1b (partials
// [blocks][2][H], summed into out [2][H]). w1 is W1 stored [FF, H], w2 W2^T
// stored [H, FF]. f32: the scratch rows are the tokens' own (rows past
// `tokens` untouched), blocks = ceil(tokens / 16), partial_b1 [blocks][FF];
// du and rows null. bf16: the scratch rows are packed (see launch_input_tc),
// du is an f32 [tokens, H] scratch, rows [tokens + 1] int32 (the packed
// rows' tokens and their count; needed with live flags), blocks any
// positive count of LN1 blocks, partial_b1 [ceil(tokens / 128)][FF].
extern "C" int stlt_tail_train_bwd_input(
    const void* x, const void* a, const void* dr2, const void* n1s, const void* n1b,
    const void* w1, const void* b1, const void* w2, const void* live, void* dx, void* dattn,
    void* u, void* dh2, void* dh1, void* h1d, float* du, int* rows, float* partial_ln,
    float* partial_b1, float* out, long long tokens, int hidden, int ff, float eps, int act,
    int dropout, unsigned int seed, unsigned int thresh, float dropout_scale, long long token_base,
    unsigned int token_period, unsigned int token_stride, unsigned int token_magic, int blocks,
    int dtype, void* stream) {
  if (hidden % 64 != 0 || hidden < 64 || hidden > 64 * kMaxNC || ff % kFC != 0 || act < 0 ||
      act > 2) {
    return -1;
  }
  InputArgs p{x, a, dr2, static_cast<const float*>(n1s), static_cast<const float*>(n1b), w1,
              static_cast<const float*>(b1), w2, static_cast<const uint8_t*>(live), dx, dattn, u,
              dh2, dh1, h1d, du, rows, partial_ln, partial_b1, tokens, ff, eps, act,
              TailDropout{dropout, seed, thresh, dropout_scale,
                          RowMap{static_cast<uint32_t>(token_base), token_period, token_stride,
                                 token_magic}}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0) {
    if (blocks != (tokens + kTMF - 1) / kTMF) return -1;
    err = dispatch_input_f32(hidden / 64, p, s);
  } else if (dtype == 1) {
    err = launch_input_tc(p, hidden, blocks, s);
  } else {
    return -2;
  }
  if (err != 0) return err;
  return reduce_parts(partial_ln, blocks, 2LL * hidden, out, s);
}

// Weight: dW1 [H, FF] and dW2 [FF, H] from the input entry point's scratch,
// split over `splits` token chunks of `chunk` tokens into partial
// [splits][2][H * FF], then summed in split order into out_w (dW1, then
// dW2); db1 [FF] from the input entry point's b1_parts partials. f32:
// `tokens` and `chunk` are multiples of 32 (the scratch rows past the last
// token zeros), count null. bf16: `tokens` is the scratch's row count and
// chunk a multiple of 64; count is the input entry point's live-row count
// (rows + tokens there), or null when every token is live.
extern "C" int stlt_tail_train_bwd_weight(
    const void* u, const void* dh1, const void* h1d, const void* dh2, const int* count,
    const float* partial_b1, int b1_parts, float* partial, float* out_w, float* db1,
    long long tokens, long long chunk, int splits, int hidden, int ff, int dtype, void* stream) {
  if (hidden % 64 != 0 || hidden < 64 || hidden > 64 * kMaxNC || ff % 128 != 0 || splits < 1 ||
      chunk * splits < tokens) {
    return -1;
  }
  WeightArgs p{u, dh1, h1d, dh2, partial, tokens, chunk, hidden, ff};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0) {
    if (tokens % kKW != 0 || chunk % kKW != 0 || count != nullptr) return -1;
    tail_bwd_weight_kernel<<<dim3(2 * (hidden / 64) * (ff / 128), splits), kThreads, 0, s>>>(p);
    err = (int)cudaGetLastError();
  } else if (dtype == 1) {
    err = launch_weight_tc(p, count, splits, s);
  } else {
    return -2;
  }
  if (err != 0) return err;
  err = reduce_parts(partial, splits, 2LL * hidden * ff, out_w, s);
  if (err != 0) return err;
  return reduce_parts(partial_b1, b1_parts, ff, db1, s);
}
