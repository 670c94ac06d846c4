// The bf16 short-attention sublayers on Hopper, split at their contract's
// rounding points: the self-attention of fused_proj_attention.cu (rows 1
// and 3) and the cross-attention of fused_cross_attention.cu (row 5); the
// scan, the projection GEMM (gemm_tile) and its f32-output sibling
// (gemm_f32_tile) also serve the self-attention's train backward
// (fused_proj_attention_bwd.cu, row 4).
//
//   qkv (or q, kv) = round(A W^T + b)    projection GEMMs (gemm_body)
//   o_h = round(softmax(q_h k_h^T * scale + bias) v_h)   short attention (attn_body)
//   y   = round(o W_o^T + b_o)           out-projection GEMM, scattered back
//
// The contract rounds q/k/v after their f32 bias add and the heads' output
// before the out-projection, so both pass through device memory in bf16 and
// lose nothing. Each .cu defines its own __global__ kernels around these
// bodies (the profiler then tells the two sublayers apart) and builds into
// a library of its own.
//
// - A GEMM (gemm_body) is tail_gemm.cuh's warp-specialised mainloop: a
//   [128, 128] output tile a block, two blocks an SM, a producer warp
//   keeping TMA loads of A ([128 rows, 64 k]) and B (the weight as the
//   model stores it, [N, K]: read in place, K-major) in a 3-stage ring,
//   two consumer warpgroups of m64n128k16 wgmmas. The epilogue adds the
//   bias (the compute dtype's, widened) to the f32 sums, rounds, parks the
//   bf16 tile in the ring and stores it in 16-byte vectors: at A's row, or
//   (scatter) at the packed row's own token. Rows at and past the live count
//   carry nothing, and a tile wholly past it returns at once. Columns past N
//   (3H = 960 at H = 320) land as zeros from TMA and are not stored.
// - The attention (attn_body) takes one packed row and a group of heads a
//   block of 128 threads; each thread owns one (head, query) pair: its q
//   in registers, k and v of the group's heads in shared memory (bf16,
//   rows padded by 16 bytes), f32 logits over the real S keys into its own
//   row of a shared tile, the bias read per original row through its
//   strides, a max-subtracted softmax normalised first, with dropout each
//   probability times keep * 1/(1-rate), the keep bit hashed at the
//   ORIGINAL row (as the backward and the plain version hash it), then P V
//   in f32 sums over s in order, rounded to bf16. At the main-path T = 8
//   and 17 this is under 2 % of the flops, so the SIMT pipes in f32 follow
//   the contract exactly at little cost. A block past the live count owns a
//   dead row instead and writes its output rows as exact zeros.
// - The live rows are packed in order by tail_gemm.cuh's scan (dead rows
//   after them) and gathered (gather_body) into a dense bf16 A for TMA.
//
// - The model axis (--model_parallel M, rows 1 and 5): a model rank holds
//   N / M heads, q/k/v widths Hq = H / M. Its projection GEMMs write [tokens,
//   3Hq] (or q [tokens, Hq], kv [tokens, 2Hq]) over the whole K = H, so their
//   bits are one process's for those columns; the attention runs on its
//   heads; the out GEMM runs K = Hq and writes the f32 partial o_m Wo_m
//   (GemmArgs::out32: no bias, no rounding, at the tokens' own rows). The
//   model ranks sum the partials in f32 outside the kernels, then a row
//   kernel of each .cu on sum_bias_body writes round(s + bo), dead rows
//   exact zeros.
//
// Every output has one owner and every sum a fixed order, so two launches
// give the same bits.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"
#include "tail_gemm.cuh"

namespace stlt {
namespace sublayer {

using bf16 = __nv_bfloat16;
using tail::kBK;
using tail::kBM;
using tail::kConsumers;
using tail::kGemmThreads;
using tail::kRowWarps;
using tail::kScanThreads;

// --- projection GEMMs -------------------------------------------------------------

constexpr int kBN = 128;  // columns of a tile
constexpr int kStageA = kBM * kBK, kStageB = kBN * kBK;
constexpr size_t kGemmSmem = tail::ring_smem(kStageA, kStageB);
constexpr int kLDS = kBN + 8;  // bf16 row stride of the parked tile: conflict-free fragment writes
static_assert(kBM * kLDS * (int)sizeof(bf16) <= tail::kRingStages * kStageA * (int)sizeof(bf16),
              "the epilogue parks its bf16 tile over the ring's A stages");
static_assert(2 * (kGemmSmem + 1024) <= 228 * 1024, "two blocks an SM");

// C[M, N] = round(A[M, K] B[N, K]^T + bias). A's row i is packed row i / seq
// of `seq` tokens; with `count`, A holds (*count) * seq rows (M an upper
// bound), else M. An out GEMM (`scatter`) writes row i at token rows[i /
// seq] * seq + i % seq of the output (rows null: token i); a projection
// GEMM writes it at row i.
struct GemmArgs {
  int M, N, K;
  const bf16* bias;  // [N], the compute dtype
  bf16* out;
  const int* rows;
  const int* count;
  int seq;
  int scatter;
  float* out32;  // non-null: write the f32 sums there instead (no bias, no rounding)
};

// The output tile at columns n0 and rows m0 (gemm_body: the block's own).
__device__ __forceinline__ void gemm_tile(const CUtensorMap& map_a, const CUtensorMap& map_b,
                                          const GemmArgs& p, int n0, int m0) {
  using namespace hopper;
  using namespace tail;
  const int M = p.count != nullptr ? *p.count * p.seq : p.M;
  if (m0 >= M) return;

  extern __shared__ unsigned char gemm_smem[];
  const Ring ring = make_ring(gemm_smem, kStageA, kStageB);
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
        if (r >= M || c >= p.N) continue;
        long long dst = r;
        if (p.scatter && p.rows != nullptr) dst = (long long)p.rows[r / p.seq] * p.seq + r % p.seq;
        *reinterpret_cast<float2*>(p.out32 + dst * p.N + c) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    return;
  }

  // round(acc + bias) from the fragment (thread t holds rows r and r + 8,
  // columns c and c + 1 of every 8-column group) into the ring, free once
  // both warpgroups are past their last wgmma; then 16-byte stores, a row's
  // 8 columns a thread.
  bf16* tile = ring.a;
  named_barrier_sync(1, kConsumers);
  {
    const int rl = w * 64 + (t / 32) * 16 + (t % 32) / 4, cl = 2 * (t % 4);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int c = n0 + cl + 8 * j;
      const float2 b = c < p.N ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.bias + c))
                               : make_float2(0.f, 0.f);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<__nv_bfloat162*>(tile + (rl + 8 * h) * kLDS + cl + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h] + b.x, acc[4 * j + 2 * h + 1] + b.y);
      }
    }
  }
  named_barrier_sync(1, kConsumers);
  constexpr int kVecs = kBN / 8;  // 16-byte column groups of a tile row
#pragma unroll 1
  for (int i = threadIdx.x; i < kBM * kVecs; i += kConsumers) {
    const int rl = i / kVecs, cl = (i % kVecs) * 8;
    const int row = m0 + rl, c = n0 + cl;
    if (row >= M || c >= p.N) continue;
    long long dst = row;
    if (p.scatter && p.rows != nullptr) dst = (long long)p.rows[row / p.seq] * p.seq + row % p.seq;
    *reinterpret_cast<uint4*>(p.out + dst * p.N + c) = *reinterpret_cast<const uint4*>(tile + rl * kLDS + cl);
  }
}

__device__ __forceinline__ void gemm_body(const CUtensorMap& map_a, const CUtensorMap& map_b,
                                          const GemmArgs& p) {
  gemm_tile(map_a, map_b, p, blockIdx.x * kBN, blockIdx.y * kBM);
}

// C[M, N] = A[M, K] B[K, N] in f32, no bias and no rounding: the f32-output
// GEMM beside gemm_body's bf16 one (the train backward's do = g Wo^T, which
// the contract keeps in f32). A as in gemm_body; B a weight stored [K, N]
// (the model's out_proj.weight [H_out, H_in] read as Wo^T, in place), read
// MN-major (imm-trans-b) from [64 k, 64 n] boxes, none loaded past N (a
// multiple of 64). Rows from M (*count * seq with count) on are not written.
struct GemmF32Args {
  int M, N, K;
  float* out;
  const int* count;
  int seq;
};

__device__ __forceinline__ void gemm_f32_tile(const CUtensorMap& map_a, const CUtensorMap& map_b,
                                              const GemmF32Args& p, int n0, int m0) {
  using namespace hopper;
  using namespace tail;
  const int M = p.count != nullptr ? *p.count * p.seq : p.M;
  if (m0 >= M) return;

  extern __shared__ unsigned char gemm_smem[];
  const Ring ring = make_ring(gemm_smem, kStageA, kStageB);
  const int nk = p.K / kBK;
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      const int boxes = min(kBN, p.N - n0) / 64;
      produce(ring, nk, (kBM + boxes * 64) * kBK * sizeof(bf16), [&](int s, int k) {
        tma_load_2d(ring.a_stage(s), &map_a, &ring.full[s], k * kBK, m0);
        for (int j = 0; j < boxes; ++j) {
          tma_load_2d(ring.b_stage(s) + j * 64 * kBK, &map_b, &ring.full[s], n0 + 64 * j, k * kBK);
        }
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
      Wgmma<kBN, 0, 1>::mma(acc, desc_k(a, kk), desc_mn(ring.b_stage(s), kk), k > 0 || kk > 0);
    }
  }, acc);
  const int rl = m0 + w * 64 + (t / 32) * 16 + (t % 32) / 4, cl = n0 + 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rl + 8 * h, c = cl + 8 * j;
      if (r < M && c < p.N) {
        *reinterpret_cast<float2*>(p.out + (long long)r * p.N + c) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// Grid and launch of a GEMM kernel (the kernel's dynamic shared memory
// attribute set once a process: it costs host time at every small stage).
template <typename Kernel>
int launch_gemm(Kernel kernel, bool& attribute_set, const CUtensorMap& map_a, const CUtensorMap& map_b,
                const GemmArgs& g, cudaStream_t stream) {
  if (!attribute_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kGemmSmem);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  const dim3 grid((g.N + kBN - 1) / kBN, (g.M + kBM - 1) / kBM);
  if (grid.y > 65535) return -1;
  if (g.M > 0) kernel<<<grid, kGemmThreads, kGemmSmem, stream>>>(map_a, map_b, g);
  return (int)cudaGetLastError();
}

// --- packing ------------------------------------------------------------------

// Packed token i (< *count * seq) of x [rows * seq, H] into xp: token
// rows[i / seq] * seq + i % seq, one a warp in 16-byte vectors.
__device__ __forceinline__ void gather_body(const bf16* x, bf16* xp, const int* rows, const int* count,
                                            int seq, int H) {
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (i >= (long long)*count * seq) return;
  const long long tok = (long long)rows[i / seq] * seq + i % seq;
  const uint4* src = reinterpret_cast<const uint4*>(x + tok * H);
  uint4* dst = reinterpret_cast<uint4*>(xp + i * H);
  for (int c = lane; c < H / 8; c += 32) dst[c] = src[c];
}

// --- short attention ----------------------------------------------------------

constexpr int kAttnThreads = 128;
constexpr size_t kAttnSmemMax = 110 * 1024;  // two blocks an SM at the widest shapes

// Row b's tokens: queries q + (b * T + t) * ldq, keys and values k, v +
// (b * S + s) * ldkv, head h at column h * D of each; the output o + (b * T
// + t) * H + h * D. b is a packed row; rows[b] is its original row (rows
// null: b), which the bias and the keep bits are indexed by. With rows, the
// blocks from *count on own the dead rows rows[b] and write their T x H
// output rows of `out` as zeros (out null: nothing, the partial mode's
// caller zeroes them). H is the heads' width N D, o's row stride.
struct AttnArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  long long ldq, ldkv;
  bf16* o;
  const float* bias;
  long long bias_row_stride;
  long long bias_q_stride;
  const int* rows;
  const int* count;
  bf16* out;
  int B, T, S, H, N;
  int hb;  // heads a block
  float scale;
  RowDropout drop;
};

// Row stride (floats) of the logits tile: odd, so a warp's rows spread over
// the banks.
__host__ __device__ inline int attn_ldp(int S) { return (S + 1) | 1; }

template <int D>
__host__ __device__ inline size_t attn_smem_bytes(int hb, int S) {
  return (size_t)2 * hb * S * (D + 8) * sizeof(bf16) + (size_t)kAttnThreads * attn_ldp(S) * sizeof(float);
}

// Heads a block: (head, query) pairs to fill its threads once, within the
// shared memory of two blocks an SM.
template <int D>
inline int attn_heads(int T, int S, int N) {
  int hb = kAttnThreads / T;
  hb = hb < 1 ? 1 : (hb > N ? N : hb);
  while (hb > 1 && attn_smem_bytes<D>(hb, S) > kAttnSmemMax) --hb;
  return hb;
}

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 v = __bfloat1622float2(h[j]);
    f[2 * j] = v.x;
    f[2 * j + 1] = v.y;
  }
}

template <int D, bool kDrop>
__device__ __forceinline__ void attn_body(const AttnArgs& p) {
  constexpr int LDK = D + 8;              // bf16 row stride of the k and v tiles
  constexpr int kQC = D < 64 ? D : 64;    // query columns held in registers at once
  constexpr int kVecs = D / 8;
  const int tid = threadIdx.x, b = blockIdx.x;
  const int live_rows = p.count != nullptr ? *p.count : p.B;
  if (b >= live_rows) {
    if (blockIdx.y == 0 && p.out != nullptr) {
      uint4* o = reinterpret_cast<uint4*>(p.out + (long long)p.rows[b] * p.T * p.H);
      for (int i = tid; i < p.T * p.H / 8; i += kAttnThreads) o[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  const int orig = p.rows != nullptr ? p.rows[b] : b;
  const int T = p.T, S = p.S;
  const int h0 = blockIdx.y * p.hb, nh = min(p.hb, p.N - h0);

  extern __shared__ __align__(16) unsigned char attn_smem[];
  bf16* k_s = reinterpret_cast<bf16*>(attn_smem);  // [nh][S][LDK]
  bf16* v_s = k_s + p.hb * S * LDK;               // [nh][S][LDK]
  float* p_s = reinterpret_cast<float*>(v_s + p.hb * S * LDK);  // [kAttnThreads][LDP]
  const int LDP = attn_ldp(S);

  // k and v of the group's heads (a token's heads are contiguous columns),
  // every 16-byte copy in flight at once.
  const int per_tok = nh * kVecs;
  for (int i = tid; i < 2 * S * per_tok; i += kAttnThreads) {
    const int part = i / (S * per_tok), rest = i % (S * per_tok);
    const int s = rest / per_tok, hl = (rest % per_tok) / kVecs, c = rest % kVecs;
    const bf16* src = (part ? p.v : p.k) + ((long long)b * S + s) * p.ldkv + (long long)(h0 + hl) * D + c * 8;
    cp_async16((part ? v_s : k_s) + (hl * S + s) * LDK + c * 8, src);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  for (int i = tid; i < nh * T; i += kAttnThreads) {
    const int hl = i / T, t = i % T, h = h0 + hl;
    const bf16* qrow = p.q + ((long long)b * T + t) * p.ldq + (long long)h * D;
    const bf16* kh = k_s + hl * S * LDK;
    float* pr = p_s + tid * LDP;
    // Logits q . k_s, summed over d in order, kQC query columns at a time.
#pragma unroll 1
    for (int d0 = 0; d0 < D; d0 += kQC) {
      float qv[kQC];
#pragma unroll
      for (int c = 0; c < kQC; c += 8) unpack8(*reinterpret_cast<const uint4*>(qrow + d0 + c), qv + c);
#pragma unroll 2
      for (int s = 0; s < S; ++s) {
        float acc = d0 == 0 ? 0.f : pr[s];
        const bf16* ks = kh + s * LDK + d0;
#pragma unroll
        for (int c = 0; c < kQC; c += 8) {
          float kf[8];
          unpack8(*reinterpret_cast<const uint4*>(ks + c), kf);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc = fmaf(qv[c + e], kf[e], acc);
        }
        pr[s] = acc;
      }
    }
    const float* brow = p.bias + (long long)orig * p.bias_row_stride + (long long)t * p.bias_q_stride;
    float m = -INFINITY;
    for (int s = 0; s < S; ++s) {
      const float l = pr[s] * p.scale + brow[s];
      pr[s] = l;
      m = fmaxf(m, l);
    }
    float sum = 0.f;
    for (int s = 0; s < S; ++s) {
      const float e = expf(pr[s] - m);
      pr[s] = e;
      sum += e;
    }
    const uint32_t dl = kDrop ? p.drop.row_lane(orig, h) : 0u;
    for (int s = 0; s < S; ++s) {
      float pv = pr[s] / sum;
      if (kDrop) pv *= p.drop.keep_at(dl, t, s, S);
      pr[s] = pv;
    }
    // o = P V in 32-column chunks, rounded to bf16.
    const bf16* vh = v_s + hl * S * LDK;
    bf16* orow = p.o + ((long long)b * T + t) * p.H + (long long)h * D;
#pragma unroll 1
    for (int d0 = 0; d0 < D; d0 += 32) {
      float acc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.f;
#pragma unroll 2
      for (int s = 0; s < S; ++s) {
        const float ps = pr[s];
        const bf16* vs = vh + s * LDK + d0;
#pragma unroll
        for (int c = 0; c < 32; c += 8) {
          float vf[8];
          unpack8(*reinterpret_cast<const uint4*>(vs + c), vf);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[c + e] = fmaf(ps, vf[e], acc[c + e]);
        }
      }
#pragma unroll
      for (int c = 0; c < 32; c += 8) {
        uint4 u;
        __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
        for (int j = 0; j < 4; ++j) h2[j] = __floats2bfloat162_rn(acc[c + 2 * j], acc[c + 2 * j + 1]);
        *reinterpret_cast<uint4*>(orow + d0 + c) = u;
      }
    }
  }
}

// Grid and launch of an attention kernel; the shared-memory attribute is set
// once, to the most any shape asks.
template <int D, typename Kernel>
int launch_attn(Kernel kernel, bool& attribute_set, const AttnArgs& a, cudaStream_t stream) {
  if (!attribute_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kAttnSmemMax);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  const size_t smem = attn_smem_bytes<D>(a.hb, a.S);
  if (smem > kAttnSmemMax) return -1;
  const dim3 grid(a.B, (a.N + a.hb - 1) / a.hb);
  if (a.B > 0) kernel<<<grid, kAttnThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// --- the model axis's sum epilogue -------------------------------------------

// out = round(s + bo) over [rows * seq, H] (s the model ranks' summed f32
// partials, bo [H] in the compute dtype T, widened as the out GEMM widens
// it), one element a thread; a row whose rows_live flag is 0 writes zeros.
template <typename T>
__device__ __forceinline__ void sum_bias_body(const float* s, const T* bo, const uint8_t* rows_live, T* out,
                                              long long n, int seq, int H) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long tok = i / H;
  const bool live = rows_live == nullptr || rows_live[tok / seq];
  out[i] = from_float<T>(live ? s[i] + to_float(bo[i % H]) : 0.f);
}

constexpr int kSumThreads = 256;

// Launch of a row's sum kernel (rows 1 and 5, each .cu its own under its
// own name): dtype 0 float32, 1 bfloat16.
template <typename KF, typename KB>
int launch_sum(KF kernel_f32, KB kernel_bf16, const void* s, const void* bo, const void* rows_live,
               void* out, int rows, int seq, int H, int dtype, cudaStream_t stream) {
  if (rows < 0 || seq < 1 || H < 1) return -1;
  const long long n = (long long)rows * seq * H;
  if (n == 0) return 0;
  const long long blocks = (n + kSumThreads - 1) / kSumThreads;
  if (blocks > 0x7fffffffLL) return -1;
  const float* sf = static_cast<const float*>(s);
  const uint8_t* live = static_cast<const uint8_t*>(rows_live);
  if (dtype == 0) {
    kernel_f32<<<(unsigned)blocks, kSumThreads, 0, stream>>>(sf, static_cast<const float*>(bo), live,
                                                            static_cast<float*>(out), n, seq, H);
  } else if (dtype == 1) {
    kernel_bf16<<<(unsigned)blocks, kSumThreads, 0, stream>>>(sf, static_cast<const bf16*>(bo), live,
                                                             static_cast<bf16*>(out), n, seq, H);
  } else {
    return -2;
  }
  return (int)cudaGetLastError();
}

}  // namespace sublayer
}  // namespace stlt
