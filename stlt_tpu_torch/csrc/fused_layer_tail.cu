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
// Design, f32 (fused_tail_body): one block owns 32 tokens. It computes u
// once into shared memory, then loops over FF chunks of 128: h1 for the chunk
// goes to shared memory and is multiplied straight into an f32 [32, H]
// accumulator held in registers, so the 4H-wide hidden never reaches device
// memory. The last step adds b2, the residual and LN2 and writes the
// outputs. It multiplies on the SIMT pipes, so f32 stays true f32.
//
// Design, bf16 (launch_tc): Hopper's tensor cores are fed by wgmma from
// TMA-loaded shared memory, and wgmma's 64-row tile makes a [64, H] f32
// accumulator of 192 KB at H = 768, three quarters of the register file, so
// the chain is split at its rounding points instead: a scan packs the live
// tokens in order; LN1 as a row kernel writes their u; two GEMM kernels
// (tail_gemm_kernel: a [128, 128] tile a block, two blocks an SM, a producer
// warp keeping TMA loads of u or h1 and of the weight in a 3-stage
// ring behind mbarriers, two consumer warpgroups of m64n128k16 wgmmas, then
// the bias, activation, dropout and residual epilogue) write h1 and r2; LN2
// as a row kernel writes y. u and h1 pass through device memory as bf16 (a
// scratch from the wrapper): 2 x tokens x FF x 2 bytes of extra traffic,
// which the weights read once per 128-token tile (not once per 32 tokens)
// and the tensor-core rate repay. Dead tokens are packed out, so the GEMMs
// do only live work, and write exact zeros; a tile past the live tokens
// computes nothing. Every output has one owner and the sums run in a fixed
// order, so two launches give the same bits.
//
// The model axis (--model_parallel M, stlt_fused_layer_tail_partial): a
// model rank holds FF / M hidden units (W1 [FF/M, H], W2 [H, FF/M] as
// stored). u and GEMM 1 run over the whole K = H, so h1 is one process's
// bits for those units; GEMM 2 runs K = FF / M and writes the f32 partial
// h1 W2 [tokens, H] with no b2 and no u (tail_gemm_kernel's out32), LN2
// not run. Every token is computed (no scan: u stays at the tokens' own
// rows, where the epilogue reads it), the dead ones too. f32's
// fused_tail_kernel writes its accumulator and u (held in shared memory
// only) out instead of LN2. The model ranks sum the partials in f32, then
// tail_sum_kernel (stlt_fused_layer_tail_sum), a row kernel, takes s, b2
// and u: h2 = round(s + b2), r2 = round(u + h2), y = LN2(r2), dead tokens
// zeros.
//
// The weights come in the model's storage: W1 as linear1.weight [FF, H], W2
// as linear2.weight [H, FF] (both [N, K]), read where they lie (K-major), so
// the wrappers copy none.
//
// Bound on this card: two GEMMs of 2*tokens*H*4H flops over ~3 x 2*tokens*H
// bytes of activations (4 with r2), far above the ~295 flop/byte ridge, so
// the tensor cores bound it.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"
#include "layer_tail.cuh"
#include "tail_gemm.cuh"

namespace {

using namespace stlt;
using namespace stlt::tail;

constexpr int kFC = 128;  // FF chunk: two 64-column groups per SIMT thread
constexpr int kKT1 = 16;  // k-slice of W1 (over H) staged per SIMT step
constexpr int kKT2 = 8;   // k-slice of W2 (over the chunk) staged per SIMT step
constexpr int kLDW1 = kFC + 1;  // row stride of the staged W1 slice (its columns are written k-wise)

struct TailArgs {
  const void* x;
  const void* a;
  const float* n1s;
  const float* n1b;
  const void* w1;  // W1 stored [FF, H] (linear1.weight)
  const float* b1;
  const void* w2;  // W2 stored [H, FF] (linear2.weight)
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
  void* u_out;  // the partial mode: u [tokens, H] (f32: here; bf16: the scratch's head); else null
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
  return sizeof(float) * (size_t)(kTM * H + kTM * kFC + kKT1 * kLDW1 + kKT2 * (H + 1));
}

template <int NC, bool kTrain>
__device__ __forceinline__ void fused_tail_body(const TailArgs& p) {
  constexpr int H = NC * 64, LDW2 = H + 1;  // the staged W2 slice's columns are written k-wise too
  const float* __restrict__ w1 = static_cast<const float*>(p.w1);  // [FF, H]
  const float* __restrict__ w2 = static_cast<const float*>(p.w2);  // [H, FF]

  extern __shared__ float smem[];
  float* u_s = smem;                 // [kTM][H]: u, later the residual r2
  float* h_s = u_s + kTM * H;        // [kTM][kFC]
  float* w1_s = h_s + kTM * kFC;     // [kKT1][kLDW1]
  float* w2_s = w1_s + kKT1 * kLDW1; // [kKT2][LDW2]

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
  uint32_t rc_mid[kRM];  // the row counters of this thread's tokens, FF and H features wide
  uint32_t rc_out[kRM];
#pragma unroll
  for (int r = 0; r < kRM; ++r) {
    rc_mid[r] = drop ? p.drop.row_counter(tok0 + ty * kRM + r, p.ff) : 0u;
    rc_out[r] = drop ? p.drop.row_counter(tok0 + ty * kRM + r, H) : 0u;
  }
  for (int c0 = 0; c0 < p.ff; c0 += kFC) {
    float hacc[kRM][kFC / 64];
#pragma unroll
    for (int r = 0; r < kRM; ++r)
#pragma unroll
      for (int j = 0; j < kFC / 64; ++j) hacc[r][j] = 0.f;
    for (int k0 = 0; k0 < H; k0 += kKT1) {
      for (int i = tid; i < kKT1 * kFC; i += kThreads) {
        const int f = i / kKT1, k = i % kKT1;  // row c0 + f of W1's storage: kKT1 contiguous k
        w1_s[k * kLDW1 + f] = w1[(long long)(c0 + f) * H + k0 + k];
      }
      __syncthreads();
      tile_fma<kRM, kFC / 64>(hacc, u_s + k0, H, ty * kRM, w1_s, kLDW1, tx, kKT1);
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kFC / 64; ++j) {
      const int c = tx + 64 * j;
      const float b = p.b1[c0 + c];
#pragma unroll
      for (int r = 0; r < kRM; ++r) {
        float h = activation<float>(hacc[r][j] + b, p.act);
        if (drop) h *= p.drop.keep_at(lane_mid, rc_mid[r], c0 + c);
        h_s[(ty * kRM + r) * kFC + c] = h;
      }
    }
    __syncthreads();
    for (int k0 = 0; k0 < kFC; k0 += kKT2) {
      for (int i = tid; i < kKT2 * H; i += kThreads) {
        const int c = i / kKT2, k = i % kKT2;  // row c of W2's storage: kKT2 contiguous k
        w2_s[k * LDW2 + c] = w2[(long long)c * p.ff + c0 + k0 + k];
      }
      __syncthreads();
      tile_fma<kRM, NC>(acc, h_s + k0, kFC, ty * kRM, w2_s, LDW2, tx, kKT2);
      __syncthreads();
    }
  }

  if (!kTrain && p.u_out != nullptr) {  // the partial: acc (no b2) and u, no LN2
    float* s = static_cast<float*>(p.out);
#pragma unroll
    for (int r = 0; r < kRM; ++r) {
      const int i = ty * kRM + r;
      if (i >= ntok) continue;
#pragma unroll
      for (int j = 0; j < NC; ++j) s[(tok0 + i) * H + tx + 64 * j] = acc[r][j];
    }
    float* uo = static_cast<float*>(p.u_out) + tok0 * H;
    for (int i = tid; i < ntok * H; i += kThreads) uo[i] = u_s[i];
    return;
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
      if (drop) h2 *= p.drop.keep_at(lane_out, rc_out[r], c);
      u_s[i * H + c] += h2;
    }
  }
  __syncthreads();
  layer_norm2_out<float, float, H, kTrain>(p, u_s, H, tok0, ntok);
}

// --- bf16: wgmma on TMA-fed tiles ---------------------------------------------
//
// Launches on the stream (launch_tc): with live flags, a scan packing the
// live tokens in order; a row kernel u = LN1(x + drop(a)) into the scratch;
// GEMM 1, h1 = drop(act(round(u W1 + b1))) into the scratch; GEMM 2, r2 =
// round(u + drop(round(h1 W2 + b2))) into r2 (eval: into out); a row kernel
// y = LN2(r2) into out, dead tokens zeros there and in r2. u, h1 and r2 are
// rounding points of the contract, so the split loses nothing to the fused
// form.

// A GEMM block: a [128, 128] output tile, two blocks an SM, so that one
// block's epilogue (the activation and dropout run on the SIMT pipes) hides
// under the other's products. Measured on the H100 against one block an SM
// with 256-wide tiles (a 4-stage ring, the producer warpgroup handing its
// registers to the consumers): 1.06 against 1.49 ms for GEMM 1 of a
// 65,792-token stage (PERF.md §6).
constexpr int kBN = 128;  // columns of a tile
constexpr int kStageA = kBM * kBK, kStageB = kBN * kBK;
constexpr size_t kGemmSmem = ring_smem(kStageA, kStageB);
static_assert(kBM * (kBN + 8) * (int)sizeof(bf16) <= kRingStages * (kStageA + kStageB) * (int)sizeof(bf16),
              "the epilogue parks its bf16 tile in the ring");
static_assert(2 * (kGemmSmem + 1024) <= 228 * 1024, "two blocks an SM");

// C[M, N] = A[M, K] B[K, N] of one GEMM over the live tokens and its
// epilogue. Row i of A is token rows[i] (rows null: token i); rows at and
// past *count (count null: M) carry nothing.
struct GemmArgs {
  int M, N, K;
  int second;         // 0: GEMM 1 (b1, activation, mid dropout); 1: GEMM 2 (b2, out dropout, + u)
  const float* bias;  // [N] f32
  const bf16* u;      // GEMM 2: the residual, [M, N] in A's rows
  bf16* out;          // GEMM 1: h1 in A's rows; GEMM 2: r2 at the tokens' own rows
  const int* rows;
  const int* count;
  int act;
  TailDropout drop;
  float* out32;  // GEMM 2 of the partial mode: the f32 sums at row (no b2, no u), in place of out
};

// One output tile [kBM, kBN] per block. The producer warp's first thread
// keeps TMA loads of A ([kBM, 64]) and B (a box of [kBN n, 64 k] from the
// weight's [N, K] storage; rows past N land as zeros) in flight through the
// ring, each stage with a `full`
// barrier (the loads' bytes) and an `empty` one (both consumers done with
// it). Consumer warpgroups 0 and 1 each own 64 rows: per stage four
// m64n128k16 wgmmas, then they free the stage. A's rows are the live
// tokens packed in order (tail_live_rows_kernel), so a tile at or past the
// live count holds no live token and returns at once.
__global__ void __launch_bounds__(kGemmThreads, 2)
    tail_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b, GemmArgs p) {
  using namespace hopper;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int M = p.count != nullptr ? *p.count : p.M;
  if (m0 >= M) return;

  extern __shared__ unsigned char smem_raw[];
  const Ring ring = make_ring(smem_raw, kStageA, kStageB);
  const int nk = p.K / kBK;
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      produce(ring, nk, (kBM + kBN) * kBK * sizeof(bf16), [&](int s, int k) {
        tma_load_2d(ring.a_stage(s), &map_a, &ring.full[s], k * kBK, m0);
        tma_load_2d(ring.b_stage(s), &map_b, &ring.full[s], k * kBK, n0);
      });
    }
    return;
  }

  const int w = threadIdx.x / 128, t = threadIdx.x % 128;
  float acc[kBN / 2];
  consume(ring, nk, [&](int s, int k) {
    const bf16* a = ring.a_stage(s) + w * 64 * kBK;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {  // the first product overwrites
      Wgmma<kBN, 0, 0>::mma(acc, desc_k(a, kk), desc_k(ring.b_stage(s), kk), k > 0 || kk > 0);
    }
  }, acc);

  if (p.out32 != nullptr) {  // the model axis's f32 partial, from the fragment
    const int rl = m0 + w * 64 + (t / 32) * 16 + (t % 32) / 4, cl = n0 + 2 * (t % 4);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rl + 8 * h, c = cl + 8 * j;
        if (r < M && c < p.N) {
          *reinterpret_cast<float2*>(p.out32 + (long long)r * p.N + c) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    }
    return;
  }

  // Epilogue. Both GEMMs' chains start with round(acc + bias): the
  // fragment (thread t holds rows r and r + 8, columns c and c + 1 of every
  // 8-column group) adds the bias and parks that bf16 tile in the ring, now
  // free, once both consumer warpgroups are done with it. Then a rolled loop
  // takes 8 columns of a row per thread: the rest of the chain, 16-byte
  // loads of u and stores of the output, neighbouring threads on
  // neighbouring columns. (Run on the fragment, unrolled over 128 elements
  // a thread, the same epilogue measured 2.7 times slower: PERF.md §6.)
  constexpr int LDS = kBN + 8;  // bf16 row stride of the parked tile: conflict-free fragment writes
  bf16* tile = ring.a;
  named_barrier_sync(1, kConsumers);  // both warpgroups' last wgmmas have read the ring
  {
    const int rl = w * 64 + (t / 32) * 16 + (t % 32) / 4, cl = 2 * (t % 4);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int c = n0 + cl + 8 * j;
      const float2 bias = c < p.N ? *reinterpret_cast<const float2*>(p.bias + c) : make_float2(0.f, 0.f);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<__nv_bfloat162*>(tile + (rl + 8 * h) * LDS + cl + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h] + bias.x, acc[4 * j + 2 * h + 1] + bias.y);
      }
    }
  }
  named_barrier_sync(1, kConsumers);
  const bool drop = p.drop.on;
  const uint32_t lane = p.drop.lane(p.second ? kTagOutDrop : kTagMidDrop);
  constexpr int kVecs = kBN / 8;  // 16-byte column groups of a tile row
#pragma unroll 1
  for (int i = threadIdx.x; i < kBM * kVecs; i += kConsumers) {
    const int rl = i / kVecs, cl = (i % kVecs) * 8;
    const int row = m0 + rl, c = n0 + cl;
    if (row >= M || c >= p.N) continue;
    const int tok = p.rows != nullptr ? p.rows[row] : row;  // the dropout bits' token
    const uint32_t rc = drop ? p.drop.row_counter(tok, p.N) : 0u;
    const uint4 hv = *reinterpret_cast<const uint4*>(tile + rl * LDS + cl);
    const bf16* he = reinterpret_cast<const bf16*>(&hv);
    const long long off = (long long)row * p.N + c;
    uint4 ov;
    bf16* oe = reinterpret_cast<bf16*>(&ov);
    if (!p.second) {  // h1 = drop(act(round(acc + b1)))
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float v = activation<bf16>(to_float(he[e]), p.act);
        if (drop) v = round_to<bf16>(v * p.drop.keep_at(lane, rc, c + e));
        oe[e] = from_float<bf16>(v);
      }
      *reinterpret_cast<uint4*>(p.out + off) = ov;
    } else {  // r2 = u + drop(round(acc + b2))
      const uint4 uv = *reinterpret_cast<const uint4*>(p.u + off);
      const bf16* ue = reinterpret_cast<const bf16*>(&uv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float h2 = to_float(he[e]);
        if (drop) h2 = round_to<bf16>(h2 * p.drop.keep_at(lane, rc, c + e));
        oe[e] = from_float<bf16>(to_float(ue[e]) + h2);
      }
      *reinterpret_cast<uint4*>(p.out + (long long)tok * p.N + c) = ov;
    }
  }
}

// u = LN1(x + drop(a)) of the live tokens, packed (row i token rows[i]), one
// a warp (tail_gemm.cuh::ln1_row).
__global__ void __launch_bounds__(32 * kRowWarps)
    tail_ln1_kernel(TailArgs p, int H, bf16* u, const int* rows, const int* count) {
  const long long row = (long long)blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= (count != nullptr ? *count : p.tokens)) return;
  const long long tok = rows != nullptr ? rows[row] : row;
  ln1_row(static_cast<const bf16*>(p.x), static_cast<const bf16*>(p.a), p.n1s, p.n1b, p.drop, p.eps,
          p.r2 != nullptr, tok, H, u + row * H);
}

// y = LN2(r2), one token a warp (layer_norm2_out's arithmetic); dead tokens
// write zeros to y and, in train, to r2. Eval reads r2 from out (GEMM 2
// wrote it at the token's own row) and overwrites it (each warp holds its
// whole row first).
__global__ void __launch_bounds__(32 * kRowWarps) tail_ln2_kernel(TailArgs p, int H) {
  const int lane = threadIdx.x & 31;
  const long long tok = (long long)blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (tok >= p.tokens) return;
  const bool train = p.r2 != nullptr;
  uint4* yrow = reinterpret_cast<uint4*>(static_cast<bf16*>(p.out) + tok * H);
  uint4* rrow = reinterpret_cast<uint4*>(static_cast<bf16*>(train ? p.r2 : p.out) + tok * H);
  if (p.live != nullptr && !p.live[tok]) {
    for (int i = lane; i < H / 8; i += 32) {
      yrow[i] = make_uint4(0u, 0u, 0u, 0u);
      if (train) rrow[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  float v[kRowVecs][8];
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kRowVecs; ++i) {
    const int vi = lane + 32 * i;
    if (vi * 8 >= H) continue;  // (no break: the loop unrolls, v takes constant indices)
    const uint4 rv = rrow[vi];
    const bf16* re = reinterpret_cast<const bf16*>(&rv);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[i][e] = to_float(re[e]);
      s += v[i][e];
      s2 = fmaf(v[i][e], v[i][e], s2);
    }
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mu = s / H, rstd = rsqrtf(fmaxf(0.f, s2 / H - mu * mu) + p.eps);
#pragma unroll
  for (int i = 0; i < kRowVecs; ++i) {
    const int vi = lane + 32 * i;
    if (vi * 8 >= H) continue;  // (no break: the loop unrolls, v takes constant indices)
    uint4 ov;
    bf16* oe = reinterpret_cast<bf16*>(&ov);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = vi * 8 + e;
      const float d = v[i][e] - mu;
      oe[e] = from_float<bf16>(train ? d * rstd * p.n2s[c] + p.n2b[c] : d * (rstd * p.n2s[c]) + p.n2b[c]);
    }
    yrow[vi] = ov;
  }
}

// The partial mode's epilogue, one token a warp: h2 = round(s + b2),
// r2 = round(u + h2), y = LN2(r2) (tail_ln2_kernel's eval arithmetic) in T;
// dead tokens write zeros.
template <typename T>
__global__ void __launch_bounds__(32 * kRowWarps)
    tail_sum_kernel(const float* s, const T* u, const float* b2, const float* n2s, const float* n2b,
                    const uint8_t* live, T* out, long long tokens, int H, float eps) {
  const int lane = threadIdx.x & 31;
  const long long tok = (long long)blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (tok >= tokens) return;
  T* yrow = out + tok * H;
  if (live != nullptr && !live[tok]) {
    for (int c = lane; c < H; c += 32) yrow[c] = from_float<T>(0.f);
    return;
  }
  const float* srow = s + tok * H;
  const T* urow = u + tok * H;
  float v[kRowVecs * 8];
  float sum = 0.f, sum2 = 0.f;
#pragma unroll
  for (int i = 0; i < kRowVecs * 8; ++i) {
    const int c = lane + 32 * i;
    if (c >= H) continue;  // (no break: the loop unrolls, v takes constant indices)
    const float h2 = round_to<T>(srow[c] + b2[c]);
    v[i] = round_to<T>(to_float(urow[c]) + h2);
    sum += v[i];
    sum2 = fmaf(v[i], v[i], sum2);
  }
  sum = warp_sum(sum);
  sum2 = warp_sum(sum2);
  const float mu = sum / H, rstd = rsqrtf(fmaxf(0.f, sum2 / H - mu * mu) + eps);
#pragma unroll
  for (int i = 0; i < kRowVecs * 8; ++i) {
    const int c = lane + 32 * i;
    if (c >= H) continue;
    yrow[c] = from_float<T>((v[i] - mu) * (rstd * n2s[c]) + n2b[c]);
  }
}

int launch_gemm(const CUtensorMap& map_a, const CUtensorMap& map_b, const GemmArgs& g,
                cudaStream_t stream) {
  static bool attribute_set = false;  // once a process: it costs host time at every small stage
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        tail_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kGemmSmem);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  const dim3 grid((g.N + kBN - 1) / kBN, (g.M + kBM - 1) / kBM);
  if (grid.y > 65535) return -1;
  tail_gemm_kernel<<<grid, kGemmThreads, kGemmSmem, stream>>>(map_a, map_b, g);
  return (int)cudaGetLastError();
}

// The bf16 tail. `scratch` holds u [tokens, H] and h1 [tokens, FF] in bf16
// (their live rows packed), then the packed rows' tokens [tokens] and their
// count (int32); r2 goes to p.r2 (train) or out (eval).
int launch_tc(const TailArgs& p, int H, void* scratch, cudaStream_t stream) {
  if (p.tokens == 0) return 0;
  if (scratch == nullptr || H > 1024) return -1;
  const bool partial = p.u_out != nullptr;
  bf16* u = static_cast<bf16*>(scratch);
  bf16* h1 = u + (size_t)p.tokens * H;
  int* rows = reinterpret_cast<int*>(h1 + (size_t)p.tokens * p.ff);
  int* count = rows + p.tokens;
  if (p.live == nullptr || partial) {
    rows = count = nullptr;  // every token live (or, partial, computed): row i is token i
  } else {
    tail_live_rows_kernel<<<1, kScanThreads, 0, stream>>>(p.live, p.tokens, rows, count);
  }
  bf16* r2 = static_cast<bf16*>(p.r2 != nullptr ? p.r2 : p.out);
  CUtensorMap map_u, map_w1, map_h1, map_w2;
  int err = hopper::make_map(&map_u, u, p.tokens, H, kBM);
  if (!err) err = hopper::make_map(&map_w1, p.w1, p.ff, H, kBN);  // [FF, H]: K-major B of GEMM 1
  if (!err) err = hopper::make_map(&map_h1, h1, p.tokens, p.ff, kBM);
  if (!err) err = hopper::make_map(&map_w2, p.w2, H, p.ff, kBN);  // [H, FF]: K-major B of GEMM 2
  if (err) return err;
  const int row_blocks = (p.tokens + kRowWarps - 1) / kRowWarps;
  tail_ln1_kernel<<<row_blocks, 32 * kRowWarps, 0, stream>>>(p, H, u, rows, count);
  if ((err = (int)cudaGetLastError())) return err;
  const GemmArgs g1{p.tokens, p.ff, H, 0, p.b1, nullptr, h1, rows, count, p.act, p.drop, nullptr};
  if ((err = launch_gemm(map_u, map_w1, g1, stream))) return err;
  const GemmArgs g2{p.tokens, H, p.ff, 1, p.b2, u, r2, rows, count, p.act, p.drop,
                    partial ? static_cast<float*>(p.out) : nullptr};
  if ((err = launch_gemm(map_h1, map_w2, g2, stream))) return err;
  if (partial) return 0;
  tail_ln2_kernel<<<row_blocks, 32 * kRowWarps, 0, stream>>>(p, H);
  return (int)cudaGetLastError();
}

// The f32 eval and train kernels, under their own names.
template <int NC>
__global__ void __launch_bounds__(kThreads, 1) fused_tail_kernel(TailArgs p) {
  fused_tail_body<NC, false>(p);
}
template <int NC>
__global__ void __launch_bounds__(kThreads, 1) fused_tail_train_kernel(TailArgs p) {
  fused_tail_body<NC, true>(p);
}

template <int NC, bool kTrain>
int launch(const TailArgs& a, cudaStream_t stream) {
  auto kernel = kTrain ? fused_tail_train_kernel<NC> : fused_tail_kernel<NC>;
  const size_t smem = tail_smem_bytes<NC>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (a.tokens + kTM - 1) / kTM;
  if (grid > 0) kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kTrain>
int dispatch(int nc, const TailArgs& a, cudaStream_t s) {
  switch (nc) {
#define STLT_CASE(n) \
    case n: return launch<n, kTrain>(a, s);
    STLT_NC_CASES(STLT_CASE)
#undef STLT_CASE
    default: return -1;
  }
}

}  // namespace

// Returns 0, a cudaError_t from a launch, -1 for a shape the kernels do not
// take (H not a multiple of 64 up to 1024, FF not a multiple of 128, no
// scratch in bf16), -2 for an unknown dtype code (0 = float32, 1 = bfloat16)
// or -3 if a TMA map cannot be encoded. act: 0 relu, 1 exact-erf GELU,
// 2 tanh GELU. A non-null r2 selects the train variant, which writes r2 and
// applies the dropout sites when `dropout` is 1 (keep bits from seed and
// thresh at the global tokens of the map (token_base, token_period,
// token_stride, token_magic: common.cuh RowMap); survivors scaled by
// dropout_scale); eval passes a null r2 and
// dropout 0. w1 is W1 stored [FF, H] and w2 W2 stored [H, FF] (the models'
// linear.weight). bf16 needs `scratch`, 16-byte aligned: (H + FF) bf16 and
// one int32 per token and one int32 more (launch_tc); f32 takes none.
extern "C" int stlt_fused_layer_tail(
    const void* x, const void* a, const void* n1s, const void* n1b, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* n2s, const void* n2b,
    const void* live, void* out, void* r2, void* scratch, int tokens, int hidden, int ff,
    float eps, int act, int dropout, unsigned int seed, unsigned int thresh, float dropout_scale,
    long long token_base, unsigned int token_period, unsigned int token_stride,
    unsigned int token_magic, int dtype, void* stream) {
  if (hidden % 64 != 0 || hidden < 64 || hidden > 64 * kMaxNC || ff % kFC != 0 || act < 0 ||
      act > 2) {
    return -1;
  }
  if (dropout && r2 == nullptr) return -1;
  TailArgs t{x, a, static_cast<const float*>(n1s), static_cast<const float*>(n1b), w1,
             static_cast<const float*>(b1), w2, static_cast<const float*>(b2),
             static_cast<const float*>(n2s), static_cast<const float*>(n2b),
             static_cast<const uint8_t*>(live), out, r2, tokens, ff, eps, act,
             TailDropout{dropout, seed, thresh, dropout_scale,
                         RowMap{static_cast<uint32_t>(token_base), token_period, token_stride,
                                token_magic}},
             nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool train = r2 != nullptr;
  if (dtype == 0) return train ? dispatch<true>(hidden / 64, t, s) : dispatch<false>(hidden / 64, t, s);
  if (dtype == 1) return launch_tc(t, hidden, scratch, s);
  return -2;
}

// The model axis's partial mode (eval): w1 [FF/M, H] and w2 [H, FF/M] as
// stored (ff = FF / M, a multiple of 128), b1 [ff]; writes the f32 partial
// h1 W2 [tokens, hidden] (no b2, no u) into `out` and leaves u for
// stlt_fused_layer_tail_sum in `scratch`: bf16, the full mode's scratch
// (u at its head, every token at its own row); f32, a [tokens, hidden] f32
// buffer. Returns as stlt_fused_layer_tail.
extern "C" int stlt_fused_layer_tail_partial(
    const void* x, const void* a, const void* n1s, const void* n1b, const void* w1, const void* b1,
    const void* w2, const void* live, void* out, void* scratch, int tokens, int hidden, int ff, float eps,
    int act, int dtype, void* stream) {
  if (hidden % 64 != 0 || hidden < 64 || hidden > 64 * kMaxNC || ff % kFC != 0 || ff < kFC || act < 0 ||
      act > 2 || scratch == nullptr) {
    return -1;
  }
  TailArgs t{x, a, static_cast<const float*>(n1s), static_cast<const float*>(n1b), w1,
             static_cast<const float*>(b1), w2, nullptr, nullptr, nullptr,
             static_cast<const uint8_t*>(live), out, nullptr, tokens, ff, eps, act, TailDropout{}, scratch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<false>(hidden / 64, t, s);
  if (dtype == 1) return launch_tc(t, hidden, scratch, s);
  return -2;
}

// The partial mode's sum epilogue: y [tokens, hidden] in the dtype's type
// from the summed f32 partials s, u (the partial launch's scratch), b2 and
// LN2's f32 parameters; dead tokens (live flags, when given) zeros.
extern "C" int stlt_fused_layer_tail_sum(const void* s, const void* u, const void* b2, const void* n2s,
                                         const void* n2b, const void* live, void* out, int tokens, int hidden,
                                         float eps, int dtype, void* stream) {
  if (hidden % 64 != 0 || hidden < 64 || hidden > 1024 || tokens < 0) return -1;
  if (tokens == 0) return 0;
  const unsigned blocks = (unsigned)((tokens + kRowWarps - 1) / kRowWarps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sf = static_cast<const float*>(s);
  const float *b2f = static_cast<const float*>(b2), *n2sf = static_cast<const float*>(n2s),
              *n2bf = static_cast<const float*>(n2b);
  const uint8_t* lv = static_cast<const uint8_t*>(live);
  if (dtype == 0) {
    tail_sum_kernel<float><<<blocks, 32 * kRowWarps, 0, st>>>(sf, static_cast<const float*>(u), b2f, n2sf, n2bf,
                                                              lv, static_cast<float*>(out), tokens, hidden, eps);
  } else if (dtype == 1) {
    tail_sum_kernel<bf16><<<blocks, 32 * kRowWarps, 0, st>>>(sf, static_cast<const bf16*>(u), b2f, n2sf, n2bf,
                                                             lv, static_cast<bf16*>(out), tokens, hidden, eps);
  } else {
    return -2;
  }
  return (int)cudaGetLastError();
}
