// Layer tail of a post-LN encoder layer in one kernel: for each token,
//
//   u = LN1(x + a)                                   (residual in the compute dtype)
//   y = LN2(u + act(u @ W1 + b1) @ W2 + b2)          (f32 biases and LN params)
//
// Eval: replaces the TPU kernel stlt_tpu/ops/fused_encoder.py::_fused_tail_kernel
// (launched by fused_layer_tail). Rounding points follow its contract: u, the
// hidden h1 (before and after the activation, which runs op for op in the
// compute dtype as jax.nn.gelu does), h2 and the residual r2 round to the
// compute dtype; LayerNorm is flax's (f32 stats, fast variance clipped at 0).
// The TPU token flattening into rows of 8 and its VMEM pickers do not carry
// over: tokens are flat here and the block masks its own ragged edge.
//
// Train (kTrain): replaces stlt_tpu/ops/fused_tail_train.py::
// _tail_train_fwd_kernel (launched by _tail_train_fwd). The same chain with
// the three hashed dropout sites of that kernel, each rounded to the compute
// dtype: on a before x + a, on act(h1) per FF column, on h2 before u + h2
// (common.cuh::TailDropout, the bits of ops/dropout.py::keep_rows). It also
// writes r2 = u + h2, the residual its backward starts from, and zeros y and
// r2 of every dead token (JAX zeroes them after its block-granular kernel).
//
// Design. One block owns 32 tokens. It computes u once into shared memory,
// then loops over FF chunks of 128: h1 for the chunk goes to shared memory
// and is multiplied straight into an f32 [32, H] accumulator held in
// registers, so the 4H-wide hidden never reaches device memory. The last
// step adds b2, the residual and LN2 and writes the outputs. Tokens whose
// live flag is 0 write exact zeros; a block with no live token skips all
// compute. The bf16 kernel multiplies on the tensor cores (WMMA, f32 sums)
// and streams W1 and W2 through a ring of shared-memory slices with cp.async
// (the whole layer's 9.4 MB of bf16 weights at H = 768 stay in the 50 MB
// L2); the f32 kernel multiplies on the SIMT pipes, so f32 stays true f32.
//
// Bound on this card: two GEMMs of 2*tokens*H*4H flops over ~3 x 2*tokens*H
// bytes of activations (4 with r2), far above the ~295 flop/byte ridge, so
// the tensor cores bound it. What holds the bf16 kernel back from that bound
// is the weight traffic from L2: every 32-token block reads all of W1 and W2
// once.
#include <cstdint>

#include "common.cuh"
#include "layer_tail.cuh"

namespace {

using namespace stlt;
using bf16 = __nv_bfloat16;

constexpr int kFC = 128;  // FF chunk: two 64-column groups per SIMT thread, 8 fragments of 16
constexpr int kKT1 = 16;  // k-slice of W1 (over H) staged per SIMT step
constexpr int kKT2 = 8;   // k-slice of W2 (over the chunk) staged per SIMT step
constexpr int kKS1 = 64;  // rows of W1 per streamed slice (tensor cores)
constexpr int kKS2 = 16;  // rows of W2 per streamed slice (tensor cores)
static_assert(kFC / 16 == kWarps, "one h1 column fragment per warp");

struct TailArgs {
  const void* x;
  const void* a;
  const float* n1s;
  const float* n1b;
  const void* w1;
  const float* b1;
  const void* w2;
  const float* b2;
  const float* n2s;
  const float* n2b;
  const uint8_t* live;
  void* out;
  void* r2;  // train: the residual u + h2; null in eval
  int tokens;
  int ff;
  float eps;
  int act;
  TailDropout drop;  // train: the three dropout sites; off in eval
};

// y = LN2(r2) of the block's residual tile r_s, one warp per token, and in
// train r2 itself; dead tokens write zeros.
template <typename T, typename E, int H, bool kTrain>
__device__ __forceinline__ void layer_norm2_out(const TailArgs& p, const E* r_s, int ld,
                                                long long tok0, int ntok) {
  T* __restrict__ out = static_cast<T*>(p.out);
  T* __restrict__ r2 = static_cast<T*>(p.r2);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < ntok; i += kWarps) {
    const E* row = r_s + i * ld;
    T* orow = out + (tok0 + i) * H;
    T* rrow = kTrain ? r2 + (tok0 + i) * H : nullptr;
    if (p.live != nullptr && !p.live[tok0 + i]) {
      for (int c = lane; c < H; c += 32) {
        orow[c] = from_float<T>(0.f);
        if (kTrain) rrow[c] = from_float<T>(0.f);
      }
      continue;
    }
    const float2 st = row_stats<H>(row, lane, p.eps);
    for (int c = lane; c < H; c += 32) {
      const float v = to_float(row[c]);
      orow[c] = from_float<T>(kTrain ? (v - st.x) * st.y * p.n2s[c] + p.n2b[c]
                                     : (v - st.x) * (st.y * p.n2s[c]) + p.n2b[c]);
      if (kTrain) rrow[c] = from_float<T>(v);
    }
  }
}

// Zeros for every output row of a block with no live token.
template <typename T, int H, bool kTrain>
__device__ __forceinline__ void zero_block(const TailArgs& p, long long tok0, int ntok) {
  T* out = static_cast<T*>(p.out) + tok0 * H;
  T* r2 = kTrain ? static_cast<T*>(p.r2) + tok0 * H : nullptr;
  for (int i = threadIdx.x; i < ntok * H; i += kThreads) {
    out[i] = from_float<T>(0.f);
    if (kTrain) r2[i] = from_float<T>(0.f);
  }
}

// --- f32: SIMT ----------------------------------------------------------------

template <int NC>
constexpr size_t tail_smem_bytes() {
  constexpr int H = NC * 64;
  return sizeof(float) * (size_t)(kTM * H + kTM * kFC + kKT1 * kFC + kKT2 * H);
}

template <int NC, bool kTrain>
__device__ __forceinline__ void fused_tail_body(const TailArgs& p) {
  constexpr int H = NC * 64;
  const float* __restrict__ w1 = static_cast<const float*>(p.w1);
  const float* __restrict__ w2 = static_cast<const float*>(p.w2);

  extern __shared__ float smem[];
  float* u_s = smem;                // [kTM][H]: u, later the residual r2
  float* h_s = u_s + kTM * H;       // [kTM][kFC]
  float* w1_s = h_s + kTM * kFC;    // [kKT1][kFC]
  float* w2_s = w1_s + kKT1 * kFC;  // [kKT2][H]

  const int tid = threadIdx.x, tx = tid & 63, ty = tid >> 6;
  const long long tok0 = (long long)blockIdx.x * kTM;
  const int ntok = (int)min((long long)kTM, p.tokens - tok0);
  if (!tokens_have_live(p.live, tok0, ntok)) {
    zero_block<float, H, kTrain>(p, tok0, ntok);
    return;
  }
  const bool drop = kTrain && p.drop.on;
  layer_norm1<float, float, H, kTrain>(static_cast<const float*>(p.x),
                                       static_cast<const float*>(p.a), p.n1s, p.n1b, p.eps,
                                       p.drop, u_s, H, tok0, ntok, kTM);

  float acc[kRM][NC];
#pragma unroll
  for (int r = 0; r < kRM; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[r][j] = 0.f;
  __syncthreads();

  const uint32_t lane_mid = p.drop.lane(kTagMidDrop);
  for (int c0 = 0; c0 < p.ff; c0 += kFC) {
    float hacc[kRM][kFC / 64];
#pragma unroll
    for (int r = 0; r < kRM; ++r)
#pragma unroll
      for (int j = 0; j < kFC / 64; ++j) hacc[r][j] = 0.f;
    for (int k0 = 0; k0 < H; k0 += kKT1) {
      for (int i = tid; i < kKT1 * kFC; i += kThreads) {
        const int kk = i / kFC, c = i % kFC;
        w1_s[i] = w1[(long long)(k0 + kk) * p.ff + c0 + c];
      }
      __syncthreads();
      tile_fma<kRM, kFC / 64>(hacc, u_s + k0, H, ty * kRM, w1_s, kFC, tx, kKT1);
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kFC / 64; ++j) {
      const int c = tx + 64 * j;
      const float b = p.b1[c0 + c];
#pragma unroll
      for (int r = 0; r < kRM; ++r) {
        float h = activation<float>(hacc[r][j] + b, p.act);
        if (drop) h *= p.drop.keep_scale(lane_mid, tok0 + ty * kRM + r, p.ff, c0 + c);
        h_s[(ty * kRM + r) * kFC + c] = h;
      }
    }
    __syncthreads();
    for (int k0 = 0; k0 < kFC; k0 += kKT2) {
      for (int i = tid; i < kKT2 * H; i += kThreads) {
        w2_s[i] = w2[(long long)(c0 + k0) * H + i];
      }
      __syncthreads();
      tile_fma<kRM, NC>(acc, h_s + k0, kFC, ty * kRM, w2_s, H, tx, kKT2);
      __syncthreads();
    }
  }

  // r2 = u + drop(acc + b2), in place of u (each thread its own elements).
  const uint32_t lane_out = p.drop.lane(kTagOutDrop);
#pragma unroll
  for (int r = 0; r < kRM; ++r) {
    const int i = ty * kRM + r;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = tx + 64 * j;
      float h2 = acc[r][j] + p.b2[c];
      if (drop) h2 *= p.drop.keep_scale(lane_out, tok0 + i, H, c);
      u_s[i * H + c] += h2;
    }
  }
  __syncthreads();
  layer_norm2_out<float, float, H, kTrain>(p, u_s, H, tok0, ntok);
}

// --- bf16: tensor cores -------------------------------------------------------

template <int NC>
__host__ __device__ constexpr int tail_stage_elems() {
  constexpr int s1 = stage_elems<kKS1, kFC>(), s2 = stage_elems<kKS2, NC * 64>();
  return s1 > s2 ? s1 : s2;
}

template <int NC>
constexpr size_t tail_tc_smem_bytes() {
  constexpr int H = NC * 64;
  return sizeof(bf16) * ((size_t)kTM * ((H + kPad) + (kFC + kPad)) + tail_stage_elems<NC>()) +
         sizeof(float) * kWarps * 256;
}

template <int NC, bool kTrain>
__device__ __forceinline__ void fused_tail_tc_body(const TailArgs& p) {
  using Tile = WarpTile<NC>;
  constexpr int H = NC * 64, LDU = H + kPad, LDH = kFC + kPad;
  const bf16* __restrict__ w1 = static_cast<const bf16*>(p.w1);
  const bf16* __restrict__ w2 = static_cast<const bf16*>(p.w2);

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* u_s = reinterpret_cast<bf16*>(smem_raw);  // [kTM][LDU]: u, later the residual r2
  bf16* h_s = u_s + kTM * LDU;                    // [kTM][LDH]: act(h1) of one FF chunk
  bf16* stages = h_s + kTM * LDH;                 // ring of W1 / W2 slices
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* scratch = reinterpret_cast<float*>(stages + tail_stage_elems<NC>()) + warp * 256;

  const long long tok0 = (long long)blockIdx.x * kTM;
  const int ntok = (int)min((long long)kTM, p.tokens - tok0);
  if (!tokens_have_live(p.live, tok0, ntok)) {
    zero_block<bf16, H, kTrain>(p, tok0, ntok);
    return;
  }
  const bool drop = kTrain && p.drop.on;
  layer_norm1<bf16, bf16, H, kTrain>(static_cast<const bf16*>(p.x), static_cast<const bf16*>(p.a),
                                     p.n1s, p.n1b, p.eps, p.drop, u_s, LDU, tok0, ntok, kTM);

  const int rf0 = Tile::row0(warp), cf0 = Tile::col0(warp);
  FragC acc[Tile::kRF][Tile::kCF];
  zero(acc);
  __syncthreads();

  const uint32_t lane_mid = p.drop.lane(kTagMidDrop);
  for (int c0 = 0; c0 < p.ff; c0 += kFC) {
    // h1 of the chunk: this warp's column fragment, both row fragments.
    FragC hacc[2][1];
    zero(hacc);
    const BCols<1, kFC> w1_chunk{{w1 + c0}, p.ff};
    gemm_streamed<2, 1, kKS1>(hacc, u_s, LDU, w1_chunk, H, stages, warp);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      for_each_element(hacc[r][0], scratch, lane, [&](int i, int j, float v) {
        const int c = warp * 16 + j;
        const float h1 = round_to<bf16>(v + p.b1[c0 + c]);
        float a1 = activation<bf16>(h1, p.act);
        if (drop) {
          a1 = round_to<bf16>(a1 * p.drop.keep_scale(lane_mid, tok0 + r * 16 + i, p.ff, c0 + c));
        }
        h_s[(r * 16 + i) * LDH + c] = from_float<bf16>(a1);
      });
    }
    // acc += act(h1) @ W2[c0 : c0 + kFC, :]; gemm_streamed synchronises the
    // block before it reads h_s and again before the next chunk rewrites it.
    const BCols<1, H> w2_chunk{{w2 + (long long)c0 * H}, H};
    gemm_streamed<Tile::kRF, Tile::kCF, kKS2>(acc, h_s + rf0 * 16 * LDH, LDH, w2_chunk, kFC,
                                              stages, cf0);
  }

  // r2 = u + drop(round(acc + b2)), in place of u (each warp its own fragments).
  const uint32_t lane_out = p.drop.lane(kTagOutDrop);
#pragma unroll
  for (int r = 0; r < Tile::kRF; ++r) {
#pragma unroll
    for (int j = 0; j < Tile::kCF; ++j) {
      for_each_element(acc[r][j], scratch, lane, [&](int i, int jj, float v) {
        const int row = (rf0 + r) * 16 + i, c = (cf0 + j) * 16 + jj;
        float h2 = round_to<bf16>(v + p.b2[c]);
        if (drop) h2 = round_to<bf16>(h2 * p.drop.keep_scale(lane_out, tok0 + row, H, c));
        u_s[row * LDU + c] = from_float<bf16>(to_float(u_s[row * LDU + c]) + h2);
      });
    }
  }
  __syncthreads();
  layer_norm2_out<bf16, bf16, H, kTrain>(p, u_s, LDU, tok0, ntok);
}

// The eval and the train kernels, under their own names.
template <int NC>
__global__ void __launch_bounds__(kThreads, 1) fused_tail_kernel(TailArgs p) {
  fused_tail_body<NC, false>(p);
}
template <int NC>
__global__ void __launch_bounds__(kThreads, 1) fused_tail_train_kernel(TailArgs p) {
  fused_tail_body<NC, true>(p);
}
template <int NC>
__global__ void __launch_bounds__(kThreads, 1) fused_tail_tc_kernel(TailArgs p) {
  fused_tail_tc_body<NC, false>(p);
}
template <int NC>
__global__ void __launch_bounds__(kThreads, 1) fused_tail_train_tc_kernel(TailArgs p) {
  fused_tail_tc_body<NC, true>(p);
}

template <int NC, bool kTensorCores, bool kTrain>
int launch(const TailArgs& a, cudaStream_t stream) {
  auto kernel = kTensorCores ? (kTrain ? fused_tail_train_tc_kernel<NC> : fused_tail_tc_kernel<NC>)
                             : (kTrain ? fused_tail_train_kernel<NC> : fused_tail_kernel<NC>);
  const size_t smem = kTensorCores ? tail_tc_smem_bytes<NC>() : tail_smem_bytes<NC>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (a.tokens + kTM - 1) / kTM;
  if (grid > 0) kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kTensorCores, bool kTrain>
int dispatch(int nc, const TailArgs& a, cudaStream_t s) {
  switch (nc) {
#define STLT_CASE(n) \
    case n: return launch<n, kTensorCores, kTrain>(a, s);
    STLT_NC_CASES(STLT_CASE)
#undef STLT_CASE
    default: return -1;
  }
}

}  // namespace

// Returns 0, a cudaError_t from the launch, -1 for a shape the kernel does not
// take (H not a multiple of 64 up to 1024, FF not a multiple of 128) or -2
// for an unknown dtype code (0 = float32, 1 = bfloat16). act: 0 relu,
// 1 exact-erf GELU, 2 tanh GELU. A non-null r2 selects the train kernel,
// which writes r2 and applies the dropout sites when `dropout` is 1 (keep
// bits from seed and thresh, survivors scaled by dropout_scale); eval passes
// a null r2 and dropout 0.
extern "C" int stlt_fused_layer_tail(
    const void* x, const void* a, const void* n1s, const void* n1b, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* n2s, const void* n2b,
    const void* live, void* out, void* r2, int tokens, int hidden, int ff, float eps, int act,
    int dropout, unsigned int seed, unsigned int thresh, float dropout_scale, int dtype,
    void* stream) {
  if (hidden % 64 != 0 || ff % kFC != 0 || act < 0 || act > 2) return -1;
  if (dropout && r2 == nullptr) return -1;
  TailArgs t{x, a, static_cast<const float*>(n1s), static_cast<const float*>(n1b), w1,
             static_cast<const float*>(b1), w2, static_cast<const float*>(b2),
             static_cast<const float*>(n2s), static_cast<const float*>(n2b),
             static_cast<const uint8_t*>(live), out, r2, tokens, ff, eps, act,
             TailDropout{dropout, seed, thresh, dropout_scale}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool train = r2 != nullptr;
  if (dtype == 0) {
    return train ? dispatch<false, true>(hidden / 64, t, s) : dispatch<false, false>(hidden / 64, t, s);
  }
  if (dtype == 1) {
    return train ? dispatch<true, true>(hidden / 64, t, s) : dispatch<true, false>(hidden / 64, t, s);
  }
  return -2;
}
