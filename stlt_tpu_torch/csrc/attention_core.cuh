// The attention core of the long-clip path: for projected q [B, T, N, D] and
// k, v [B, S, N, D], head dim D in {32, 64, 128} (read through their strides,
// so the q/k/v thirds of one [B, T, 3H] projection need no transpose copy),
//
//   out[b, t, n] = sum_s drop(softmax_s(q[b, t, n] . k[b, s, n] * scale + bias[b, n, t, s])) v[b, s, n]
//
// with f32 logits, softmax and PV sums and the output rounded once to the
// storage type. Two modes share the kernel (attention_kernel<E, D, kLengths, kDrop>):
//
// - bias (flash_attention.cu, the TPU kernel _fused_attn_kernel; and
//   blockwise_attention.cu without lengths, the dense-bias mode of the TPU
//   kernel _blockwise_attn_kernel): an additive f32 bias read through its
//   (b, n, t) strides, s contiguous; broadcast dims have stride 0, so the
//   head-invariant [B, 1, T, S] bias is read per head, never copied. With
//   `causal` (the blockwise entry point only) the caller declares the bias
//   causal, and key chunks above the last query's diagonal are never loaded,
//   as _causal_live skips them; every query row is computed;
// - lengths (blockwise_attention.cu, the TPU kernel _blockwise_attn_kernel in
//   its lengths mode): key s of clip b is live iff s < lengths[b] (and s <= t
//   when causal); the mask is generated here and no [B, 1, T, S] array
//   exists. Key chunks at or past the clip's length, or above the last
//   query's diagonal, are never loaded; query rows t >= lengths[b] are written
//   as zeros with lse 0, and a query tile with no live row skips all compute.
//   Its ring-offset form (the TPU kernel with off_base, one call per ring
//   step of stlt_tpu/ops/ring.py) places the block in the whole sequence:
//   local query t is global row0 + t and local key s global col0 + s, so key
//   s is live iff s < S, col0 + s < lengths[b] (and col0 + s <= row0 + t when
//   causal), and rows with row0 + t >= lengths[b] are the dead ones. Row0 =
//   col0 = 0 is the plain lengths mode. The dropout bits keep hashing the
//   local (t, s), as the TPU kernel does (the ring varies the seed per chunk).
//
// A live row can have no live key in the held chunk (rank 0's rows against
// chunk 1 under causal). The TPU kernel forces its first key block live, so
// such a row gets a finite output and an lse near -1e30 that the ring's
// cross-chunk merge wipes out; here such a row is written as zeros with lse
// -1e30 (the online softmax shifts by 0 while its running max is still
// -inf, so no inf - inf arises), never NaN and never lse 0.
//
// Both modes write lse[b, n, t] = m + log(l) when given an lse pointer (the
// blockwise entry point always; the short one in training), which the
// backward kernels (attention_bwd_core.cuh) read.
//
// Dropout (kDrop, the TPU kernels' prng branch): PyTorch drops the
// normalised probabilities and scales survivors by 1/(1 - rate). In the
// online softmax that is: the running sum l takes the undropped exp, only the
// PV accumulation takes keep * scale, and lse is dropout-free. The keep bit of
// (b, n, t, s) is common.cuh's Dropout::keep_scale over the unpadded key
// count S, the bits of stlt_tpu/ops/flash.py::_keep_block; in mask mode (the
// TPU kernels' dropout_mask operand, MaskedDropout below) it is the caller's
// uint8 mask at mask + b mb + n mn + t mt + s, with mn = 0 for a
// head-broadcast [B, 1, T, S] mask; a ring step passes the chunk's column
// view, so s is the chunk-local key there as it is for the hashed bits.
//
// Both bodies take the online softmax over key chunks of 64, which equals
// normalising before PV up to rounding. The TPU kernels' blocking does not
// carry over: a whole [T, S] f32 tile per row (the short TPU kernel) does not
// fit 227 KB beside K and V at 512 keys. The body is chosen by the storage
// type and the head dim at launch, as the backward's are
// (attention_bwd_core.cuh):
//
// bf16 at D = 64 and 128 (tc::attention_fwd_kernel<D, kLengths, kBias,
// kDrop>, every model's heads but those of H = 256 with 8 heads): Hopper's
// tensor cores through wgmma on tiles that TMA lands, on the building blocks
// it shares with the backward (attention_tc.cuh). One block per (head,
// 64-query tile, clip); one consumer warpgroup owns the 64 queries and one
// producer warp feeds it:
//
// - TMA loads q once and K and V in chunks of 64 keys through a two-stage
//   ring behind full and empty mbarriers, as 4-D tensors (D, N, rows, B) read
//   through their strides: a ring step's column view needs no copy, and a
//   clip's last tile (257 = 4 * 64 + 1, 513 = 8 * 64 + 1) reads zeros past
//   its rows, never the next clip's, whose NaN or inf would survive a masked
//   0 * inf. Chunks past the key range are never loaded;
// - with a bias (kBias, a template argument) the producer copies each [64
//   query x 64 key] f32 bias tile with 4-byte cp.async onto the stage's
//   barrier: rows of 1,028 or 2,052 bytes and stride-0 broadcast dims, which
//   TMA cannot map. The lengths mode and a call without a bias take no bias
//   stage, so more blocks fit an SM;
// - S = Q K^T by D / 16 m64n64k16 wgmmas from shared memory. On the
//   accumulator fragment each thread holds 16 logits of each of two rows:
//   x = s * scale + bias, the kernel's own masks at -inf (a key the bias
//   pads stays finite, -1e9: such rows stay uniform over their keys, as in
//   JAX), the row max over its 16 values and then across the fragment's
//   four threads of the row (two shuffles), the rescale of l and of the O
//   accumulator by exp2((m_old - m) log2 e), p = exp2((x - m) log2 e). The
//   max stays in the logits' scale: lse = m + log(l) must match the
//   backward's own z = s * scale + bias (p = exp(z - lse)), which a max
//   taken in the exp2 domain and scaled back would miss by ~1e2 at -1e9;
// - l takes the undropped p; P times its keep scale is split into bf16 hi
//   and lo parts in the A-fragment words of an RS wgmma, O += P V by two RS
//   wgmmas a 16-key step into one accumulator, V read MN-major. No product
//   makes a shared-memory round trip;
// - the epilogue sums l across the quad, writes O / l and lse = m + log(l).
//
// Shared memory: the barriers, q, two stages of K and V and, with a bias,
// two [64][64] f32 tiles whose columns are swizzled by row (the fragment's
// float2 reads are conflict free without padded rows). D = 64: 75,776 bytes
// with a bias, 43,008 without, three blocks an SM either way (the launch
// bound caps the registers at 136 a thread); D = 128: 116,736 (one block)
// and 83,968 (two).
//
// f32, and bf16 at D = 32 (attention_kernel<E, D, kLengths, kDrop>, the
// staged body): one block of four warps owns 64 queries of one (clip, head);
// each warp owns 16 of them. K and V double-buffered in shared memory by
// cp.async; per query the running max m, the running sum l (each lane its
// own part) and the f32 output accumulator in registers; lane j holds keys j
// and j + 32 of each chunk and output columns j + 32 i (i < D / 32). Shared
// memory (q, two K and two V stages of 64 rows, the per-warp scratch): f32
// 62,464 / 103,424 / 185,344 bytes at D = 32 / 64 / 128, bf16 60,416 at
// D = 32. In bf16 it multiplies on the tensor cores (WMMA, f32 sums) through a
// per-warp shared scratch, the probabilities split hi + lo as above; in f32
// both products run on the SIMT pipes in true f32.
//
// q k^T from bf16 operands is exact products summed in f32, as the TPU
// kernel's f32 dot of bf16 values; the hi + lo split keeps 16 significant
// bits of each f32 probability, so the PV product keeps f32-grade
// probabilities.
//
// Bound on this card: at the long-clip shapes (B = 64, T = 257; B = 32,
// T = 513 causal; 513 x 513 dense at B = 16) the work is ~4-13 GFLOP
// against ~50-120 MB of q, k, v, out, lse and the bias, below the H100's
// ~295 flop/byte ridge in bf16: device memory bounds it (~0.02-0.035 ms).
// The wgmma body spends what it does beside the products on the SIMT side:
// an exp2 per (query, key) pair, a hash per pair with dropout, the bias
// tile's copy by one warp (the 12 heads of one query tile are neighbouring
// blocks, so a head-invariant bias comes from L2), the hi + lo split that
// doubles the PV products; and the warpgroup does not overlap one chunk's
// softmax with another's products (the SM's other blocks do). T = 257 pads to
// 5 query tiles and 5 key chunks.
#pragma once

#include <cstdint>
#include <type_traits>

#include "attention_tc.cuh"
#include "common.cuh"

namespace stlt {
namespace attn {

constexpr int kBQ = 64;       // queries of one block
constexpr int kBK = 64;       // keys of one chunk
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = kBQ / kWarps;  // queries of one warp
constexpr int kLDP = kBK + 8;        // bf16 probability rows (32 B aligned for WMMA)
constexpr float kNegInf = -1e30f;    // the lse of a row with no live key (_NEG_INF)

static_assert(kRows == 16 && kBK == 64, "one WMMA row fragment per warp; lanes own keys j, j + 32");

// Shared-memory row length of q/k/v tiles of head dim D: D + 4 floats
// (16-byte rows, float4 reads of 8 lanes on 8 rows hit distinct banks) or
// D + 8 bf16 (rows whose 16-row steps stay 32-byte aligned for WMMA).
template <typename E, int D>
struct Tile;
template <int D>
struct Tile<float, D> {
  static constexpr int LD = D + 4;
};
template <int D>
struct Tile<__nv_bfloat16, D> {
  static constexpr int LD = D + 8;
};

// The head dims the kernels are instantiated for.
#define STLT_HEAD_DIMS(F) F(32) F(64) F(128)

// The probability dropout of the attention kernels: common.cuh's hashed
// bits, or in mask mode the caller's keep bits read through their (b, n, t)
// element strides, s contiguous (stlt_tpu/ops/flash.py:1055-1057, read at
// :618-620, :966-968, :1001-1003, :1187-1189 and :1258-1260). Either way a
// kept element weighs `scale` = 1/(1 - rate). The mode is the kernels'
// template argument kDrop, so no element tests which one it is: none (the
// keep bits are never formed), hashed from the seed, or the mask; launch
// picks the instantiation from `on` and the mask pointer (drop_mode).
constexpr int kDropNone = 0, kDropHash = 1, kDropMask = 2;

struct MaskedDropout : Dropout {
  const uint8_t* mask;
  long long mb, mn, mt;
  template <int kDrop>
  __device__ __forceinline__ float keep_scale(uint32_t b, uint32_t n, uint32_t num_heads, uint32_t t,
                                              uint32_t s, uint32_t s_total) const {
    if (kDrop == kDropMask) return mask[b * mb + n * mn + t * mt + s] ? scale : 0.f;
    return Dropout::keep_scale(b, n, num_heads, t, s, s_total);
  }
};

inline int drop_mode(const MaskedDropout& d) {
  return !d.on ? kDropNone : (d.mask != nullptr ? kDropMask : kDropHash);
}

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  long long qb, qt, qn, kb, kt, kn, vb, vt, vn;  // element strides of b, t (s), n
  const float* bias;                              // bias mode; nullptr adds 0
  long long bb, bn, bt;                           // bias strides of b, n, t (0 = broadcast)
  const int* lengths;                             // lengths mode: [B] live keys
  int causal;
  int row0, col0;  // lengths mode: global index of local query 0 and key 0 (a ring step)
  void* out;   // [B, T, N, D] contiguous, storage type
  float* lse;  // [B, N, T] or nullptr (bias mode in eval)
  int B, T, S, N;
  float scale;
  MaskedDropout drop;  // probability dropout (kDrop instantiations)
};

// The body and template arguments of this library's last forward launch that
// the runtime accepted (host side): {wgmma body, D, kLengths, bias stage,
// kDrop}. A harness reads it to check which device kernel a call ran.
inline int* last_fwd_launch() {
  static int rec[5] = {-1, 0, 0, 0, 0};
  return rec;
}

inline int record_fwd_launch(int wgmma, int D, bool lengths, bool bias, int drop) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) {
    int* rec = last_fwd_launch();
    rec[0] = wgmma, rec[1] = D, rec[2] = lengths, rec[3] = bias, rec[4] = drop;
  }
  return (int)err;
}

template <typename E, int D>
constexpr size_t smem_bytes() {
  constexpr int LD = Tile<E, D>::LD;
  size_t bytes = sizeof(E) * (size_t)(kBQ + 4 * kBK) * LD  // q, two K and two V stages
                 + sizeof(float) * (size_t)kWarps * kRows * kBK;  // per-warp scratch
  if (sizeof(E) == 2) bytes += 2 * sizeof(E) * (size_t)kWarps * kRows * kLDP;  // p hi, lo
  return bytes;
}

__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xff800000u); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// 16-byte cp.async that writes zeros (reading nothing) when !valid.
__device__ __forceinline__ void cp_async16_zfill(void* smem_dst, const void* gmem_src, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem_src), "r"(n));
}

// Rows r0 .. r0 + 63 of one (clip, head) into a [64][LD] tile; rows at or
// past `limit` are zeros.
template <int D, typename E>
__device__ __forceinline__ void load_tile(E* dst, const E* base, long long row_stride, int r0,
                                          int limit) {
  constexpr int kVec = 16 / sizeof(E), kPerRow = D / kVec, LD = Tile<E, D>::LD;
  for (int c = threadIdx.x; c < kBK * kPerRow; c += kThreads) {
    const int i = c / kPerRow, col = (c % kPerRow) * kVec;
    const bool valid = r0 + i < limit;
    cp_async16_zfill(dst + i * LD + col, base + (valid ? (long long)(r0 + i) * row_stride : 0) + col,
                     valid);
  }
}

// s[r][j] = q[row r of the warp] . k[key lane + 32 j] over the chunk.
template <int D>
__device__ __forceinline__ void chunk_logits(float (&s)[kRows][2], const float* qw, const float* kc,
                                             float*, int lane) {
  constexpr int LD = Tile<float, D>::LD;
#pragma unroll
  for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 ka = *reinterpret_cast<const float4*>(kc + lane * LD + d);
    const float4 kb = *reinterpret_cast<const float4*>(kc + (lane + 32) * LD + d);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 q = *reinterpret_cast<const float4*>(qw + r * LD + d);
      s[r][0] = fmaf(q.w, ka.w, fmaf(q.z, ka.z, fmaf(q.y, ka.y, fmaf(q.x, ka.x, s[r][0]))));
      s[r][1] = fmaf(q.w, kb.w, fmaf(q.z, kb.z, fmaf(q.y, kb.y, fmaf(q.x, kb.x, s[r][1]))));
    }
  }
}

template <int D>
__device__ __forceinline__ void chunk_logits(float (&s)[kRows][2], const __nv_bfloat16* qw,
                                             const __nv_bfloat16* kc, float* sc, int lane) {
  constexpr int LD = Tile<__nv_bfloat16, D>::LD;
  using FragKt = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
  FragA qa[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wmma::load_matrix_sync(qa[kk], qw + kk * 16, LD);
#pragma unroll
  for (int j = 0; j < kBK / 16; ++j) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragKt kt;  // k^T: element (d, key) at kc[key * LD + d]
      wmma::load_matrix_sync(kt, kc + j * 16 * LD + kk * 16, LD);
      wmma::mma_sync(acc, qa[kk], kt, acc);
    }
    wmma::store_matrix_sync(sc + j * 16, acc, kBK, wmma::mem_row_major);
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    s[r][0] = sc[r * kBK + lane];
    s[r][1] = sc[r * kBK + lane + 32];
  }
  __syncwarp();
}

// o[r][j] += sum_s p[r][s] v[s][lane + 32 j] over the chunk (p in s), for
// the D / 32 output columns of the lane.
template <int D>
__device__ __forceinline__ void chunk_pv(float (&o)[kRows][D / 32], const float (&p)[kRows][2],
                                         const float* vc, float* sc, __nv_bfloat16*, int lane) {
  constexpr int LD = Tile<float, D>::LD, kO = D / 32;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    sc[r * kBK + lane] = p[r][0];
    sc[r * kBK + lane + 32] = p[r][1];
  }
  __syncwarp();
#pragma unroll 2
  for (int s4 = 0; s4 < kBK; s4 += 4) {
    float va[kO][4];
#pragma unroll
    for (int j = 0; j < kO; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) va[j][i] = vc[(s4 + i) * LD + lane + 32 * j];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 pr = *reinterpret_cast<const float4*>(sc + r * kBK + s4);
#pragma unroll
      for (int j = 0; j < kO; ++j) {
        o[r][j] = fmaf(pr.w, va[j][3], fmaf(pr.z, va[j][2], fmaf(pr.y, va[j][1], fmaf(pr.x, va[j][0], o[r][j]))));
      }
    }
  }
  __syncwarp();
}

// The bf16 form: the products land in the warp's [kRows][kBK] f32 scratch,
// 64 output columns (four fragments) at a time.
template <int D>
__device__ __forceinline__ void chunk_pv(float (&o)[kRows][D / 32], const float (&p)[kRows][2],
                                         const __nv_bfloat16* vc, float* sc, __nv_bfloat16* ph,
                                         int lane) {
  constexpr int LD = Tile<__nv_bfloat16, D>::LD, kO = D / 32;
  constexpr int kGroup = D < kBK ? D : kBK;  // output columns per pass through the scratch
  __nv_bfloat16* pl = ph + kRows * kLDP;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const __nv_bfloat16 hi = __float2bfloat16_rn(p[r][j]);
      ph[r * kLDP + lane + 32 * j] = hi;
      pl[r * kLDP + lane + 32 * j] = __float2bfloat16_rn(p[r][j] - __bfloat162float(hi));
    }
  }
  __syncwarp();
#pragma unroll
  for (int g0 = 0; g0 < D; g0 += kGroup) {
#pragma unroll
    for (int j = 0; j < kGroup / 16; ++j) {
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        FragA ah, al;
        FragB vf;
        wmma::load_matrix_sync(ah, ph + kk * 16, kLDP);
        wmma::load_matrix_sync(al, pl + kk * 16, kLDP);
        wmma::load_matrix_sync(vf, vc + kk * 16 * LD + g0 + j * 16, LD);
        wmma::mma_sync(acc, ah, vf, acc);
        wmma::mma_sync(acc, al, vf, acc);
      }
      wmma::store_matrix_sync(sc + j * 16, acc, kBK, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int j = 0; j < kO; ++j) {
        // this lane's output column lane + 32 j, in the pass iff 32 j is
        if (32 * j >= g0 && 32 * j < g0 + kGroup) o[r][j] += sc[r * kBK + lane + 32 * j - g0];
      }
    }
    __syncwarp();
  }
}

template <typename E, int D, bool kLengths, int kDrop>
__global__ void __launch_bounds__(kThreads) attention_kernel(AttnArgs p) {
  constexpr int LD = Tile<E, D>::LD, kO = D / 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  E* q_s = reinterpret_cast<E*>(smem_raw);  // [kBQ][LD]
  E* k_s = q_s + kBQ * LD;                  // two stages of [kBK][LD]
  E* v_s = k_s + 2 * kBK * LD;              // two stages of [kBK][LD]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* sc = reinterpret_cast<float*>(v_s + 2 * kBK * LD) + warp * kRows * kBK;
  __nv_bfloat16* ph = reinterpret_cast<__nv_bfloat16*>(
                          reinterpret_cast<float*>(v_s + 2 * kBK * LD) + kWarps * kRows * kBK) +
                      warp * 2 * kRows * kLDP;

  // Heads vary fastest over the grid, so the blocks of one query tile that
  // read the same head-invariant bias tile run side by side.
  const int n = blockIdx.x, q0 = blockIdx.y * kBQ, b = blockIdx.z;
  const int T = p.T, S = p.S, N = p.N;
  E* __restrict__ out = static_cast<E*>(p.out);
  int len = S, kend = S;  // keys >= kend carry no weight for any query of the tile
  if (!kLengths && p.causal) kend = min(S, min(q0 + kBQ, T));
  if (kLengths) {
    len = p.lengths[b];
    kend = min(S, len - p.col0);
    // causal: global key col0 + s <= row0 + (last query of the tile)
    if (p.causal) kend = min(kend, p.row0 + min(q0 + kBQ, T) - p.col0);
    kend = max(kend, 0);
    if (p.row0 + q0 >= len) {  // no live query in the tile
      const int rows = min(kBQ, T - q0);
      for (int i = threadIdx.x; i < rows * D; i += kThreads) {
        const int t = q0 + i / D;
        out[(((long long)b * T + t) * N + n) * D + i % D] = from_float<E>(0.f);
        if (i % D == 0) p.lse[((long long)b * N + n) * T + t] = 0.f;
      }
      return;
    }
  }

  const E* qg = static_cast<const E*>(p.q) + b * p.qb + n * p.qn;
  const E* kg = static_cast<const E*>(p.k) + b * p.kb + n * p.kn;
  const E* vg = static_cast<const E*>(p.v) + b * p.vb + n * p.vn;
  const float* bias = nullptr;
  if (!kLengths && p.bias != nullptr) bias = p.bias + b * p.bb + n * p.bn;
  const int nchunks = (kend + kBK - 1) / kBK;
  load_tile<D>(q_s, qg, p.qt, q0, T);
  load_tile<D>(k_s, kg, p.kt, 0, kend);
  load_tile<D>(v_s, vg, p.vt, 0, kend);
  cp_async_commit();

  const int row0 = q0 + warp * kRows;  // this warp's first query
  float m[kRows], l[kRows], o[kRows][kO], s[kRows][2];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = neg_inf();
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kO; ++j) o[r][j] = 0.f;
  }
  // Bias mode: this lane's bias values of a chunk, loaded one chunk ahead so
  // that their latency hides behind the chunk before.
  float bias_next[kRows][2];
  auto load_bias = [&](int c) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int t = row0 + r, key = c * kBK + lane + 32 * j;
        bias_next[r][j] =
            bias != nullptr && t < T && key < kend ? __ldg(bias + (long long)t * p.bt + key) : 0.f;
      }
    }
  };
  if (!kLengths) load_bias(0);

  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {  // the next chunk lands while this one is computed
      const int nxt = ((c + 1) & 1) * kBK * LD;
      load_tile<D>(k_s + nxt, kg, p.kt, (c + 1) * kBK, kend);
      load_tile<D>(v_s + nxt, vg, p.vt, (c + 1) * kBK, kend);
    }
    cp_async_commit();
    cp_async_wait<1>();  // chunk c (and q) has landed
    __syncthreads();
    const E* kc = k_s + (c & 1) * kBK * LD;
    const E* vc = v_s + (c & 1) * kBK * LD;
    float bias_c[kRows][2];
    if (!kLengths) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) bias_c[r][0] = bias_next[r][0], bias_c[r][1] = bias_next[r][1];
      if (c + 1 < nchunks) load_bias(c + 1);
    }
    chunk_logits<D>(s, q_s + warp * kRows * LD, kc, sc, lane);

    const int s0 = c * kBK;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int t = row0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = s0 + lane + 32 * j;
        float x = s[r][j] * p.scale;
        if (key >= kend || (kLengths && p.causal && p.col0 + key > p.row0 + t)) {
          x = neg_inf();  // weight exactly 0, as exp(-1e30 - m) in the TPU kernel
        } else if (!kLengths) {
          x += bias_c[r][j];  // 0 without a bias or past the last query
        }
        s[r][j] = x;
      }
      // Online softmax. A row with no live key so far keeps m = -inf and
      // shifts by 0 instead, so its terms are exp(-inf) = 0, never NaN.
      const float mx = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float shift = mx == neg_inf() ? 0.f : mx;
      const float corr = expf(m[r] - shift);
      s[r][0] = expf(s[r][0] - shift);
      s[r][1] = expf(s[r][1] - shift);
      l[r] = l[r] * corr + (s[r][0] + s[r][1]);
#pragma unroll
      for (int j = 0; j < kO; ++j) o[r][j] *= corr;
      m[r] = mx;
      if (kDrop != kDropNone) {  // only PV sees the dropped probabilities
#pragma unroll
        for (int j = 0; j < 2; ++j) s[r][j] *= p.drop.keep_scale<kDrop>(b, n, N, t, s0 + lane + 32 * j, S);
      }
    }
    chunk_pv<D>(o, s, vc, sc, ph, lane);
    __syncthreads();  // stage c & 1 is free for chunk c + 2
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = row0 + r;
    if (t >= T) break;  // uniform over the warp
    const float lt = warp_sum(l[r]);
    const bool dead = kLengths && p.row0 + t >= len;
    const bool none = !dead && lt == 0.f;  // a live row with no live key in this block
    E* orow = out + (((long long)b * T + t) * N + n) * D;
#pragma unroll
    for (int j = 0; j < kO; ++j) orow[lane + 32 * j] = from_float<E>(dead || none ? 0.f : o[r][j] / lt);
    if (p.lse != nullptr && lane == 0) {
      p.lse[((long long)b * N + n) * T + t] = dead ? 0.f : (none ? kNegInf : m[r] + logf(lt));
    }
  }
}

// --- bf16 at D = 64 and 128: wgmma on TMA-fed tiles ---------------------------

namespace tc {

template <int D, bool kLengths, bool kBias, int kDrop>
__global__ void __launch_bounds__(kThreads, D == 64 ? 3 : 1)
    attention_fwd_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v, AttnArgs p) {
  static_assert(!(kLengths && kBias), "the lengths mode takes no bias");
  using namespace hopper;
  constexpr int kTile = tile_elems<D>();
  constexpr uint32_t kTileBytes = kTile * sizeof(bf16);
  constexpr int kLd = kBias ? 64 : 0;  // bias tile row (floats, swizzled); no bias stage without a bias
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // Heads vary fastest over the grid, so the blocks of one query tile that
  // read the same head-invariant bias tile run side by side.
  const int n = blockIdx.x, q0 = blockIdx.y * kBQ, b = blockIdx.z;
  const int T = p.T, S = p.S, N = p.N;
  bf16* __restrict__ out = static_cast<bf16*>(p.out);
  int len = S, kend = S;  // keys >= kend carry no weight for any query of the tile
  // Dense bias declared causal: keys above the tile's last diagonal are
  // masked by the bias, so their chunks are never loaded (_causal_live).
  if (!kLengths && p.causal) kend = min(min(q0 + kBQ, T), S);
  if (kLengths) {
    len = p.lengths[b];
    kend = min(S, len - p.col0);
    // causal: global key col0 + s <= row0 + (last query of the tile)
    if (p.causal) kend = min(kend, p.row0 + min(q0 + kBQ, T) - p.col0);
    kend = max(kend, 0);
    if (p.row0 + q0 >= len) {  // no live query in the tile: zeros, lse 0
      const int rows = min(kBQ, T - q0);
      zero_rows<D>(out, b, q0, rows, T, N, n);
      for (int i = threadIdx.x; i < rows; i += blockDim.x) p.lse[((long long)b * N + n) * T + q0 + i] = 0.f;
      return;
    }
  }
  const int nchunks = (kend + kBK - 1) / kBK;
  const Smem m = carve<D, 1, kLd>(smem_raw);
  bf16* q_s = m.res;

  if (threadIdx.x >= kConsumers) {  // the producer warp
    const int lane = threadIdx.x - kConsumers;
    if (nchunks == 0) return;
    if (lane == 0) {
      mbar_expect_tx(&m.bars->once, kTileBytes);
      load_tile<D>(q_s, &map_q, &m.bars->once, n, q0, b);
    }
    for (int c = 0; c < nchunks; ++c) {
      const int s = c % kStages;
      if (c >= kStages) mbar_wait(&m.bars->empty[s], (c / kStages - 1) & 1);
      bf16* k_st = m.str + 2 * s * kTile;
      if (lane == 0) {
        mbar_expect_tx(&m.bars->full[s], 2 * kTileBytes);
        load_tile<D>(k_st, &map_k, &m.bars->full[s], n, c * kBK, b);
        load_tile<D>(k_st + kTile, &map_v, &m.bars->full[s], n, c * kBK, b);
      }
      if constexpr (kBias) {
        load_bias_tile<true>(m.bias + s * 64 * kLd, kLd, p.bias + b * p.bb + n * p.bn, p.bt, 1, q0, T,
                             c * kBK, kend, lane);
      }
      cp_async_mbar_arrive(&m.bars->full[s]);
    }
    cp_async_wait_all();
    return;
  }

  const int tid = threadIdx.x, w = tid >> 5, g = (tid & 31) >> 2, tig = tid & 3;
  // Rows 16 w + g and + 8 of the tile: their running max and this thread's
  // part of their running sum (its 16 columns of each chunk).
  int t_h[2];
  float m_h[2], l_h[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    t_h[h] = q0 + 16 * w + g + 8 * h;
    m_h[h] = neg_inf();
    l_h[h] = 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  if (nchunks > 0) mbar_wait(&m.bars->once, 0);
  for (int c = 0; c < nchunks; ++c) {
    const int s = c % kStages;
    mbar_wait(&m.bars->full[s], (c / kStages) & 1);
    const bf16* k_st = m.str + 2 * s * kTile;
    float st[32];
    wgmma_fence();
    ss_logits<D>(st, q_s, k_st);  // q k^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(st);

    const float* bias_st = m.bias + s * 64 * kLd;
    float mx[2] = {m_h[0], m_h[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t_h[h], col = 8 * j + 2 * tig, r = 16 * w + g + 8 * h;
        float2 bb = make_float2(0.f, 0.f);
        if constexpr (kBias) bb = *reinterpret_cast<const float2*>(bias_st + r * kLd + (col ^ bias_swizzle(r)));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * j + 2 * h + e, key = c * kBK + col + e;
          // The kernel's own masks (and rows past T, never stored): weight
          // exactly 0, as exp(-1e30 - m) in the TPU kernel. A key the bias
          // masks stays finite.
          const bool masked = t >= T || key >= kend || (kLengths && p.causal && p.col0 + key > p.row0 + t);
          st[idx] = masked ? neg_inf() : st[idx] * p.scale + (e ? bb.y : bb.x);
          mx[h] = fmaxf(mx[h], st[idx]);
        }
      }
    }
    // The row max across the four threads of the row; a row with no live
    // key so far keeps m = -inf and shifts by 0 instead, so its terms are
    // exp2(-inf) = 0, never NaN. The max stays in the logits' own scale: a
    // bias of -1e9 taken to the exp2 domain first would move lse by ~1e2
    // against the backward's z (p = exp(z - lse)).
    float shift[2], corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      shift[h] = mx[h] == neg_inf() ? 0.f : mx[h];
      corr[h] = exp2f((m_h[h] - shift[h]) * kLog2e);
      m_h[h] = mx[h];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * j + 2 * h + e;
          float pr = exp2f((st[idx] - shift[h]) * kLog2e);
          rsum[h] += pr;  // l takes the undropped probability; only PV sees the keep bits
          if (kDrop != kDropNone && pr != 0.f) {
            pr *= p.drop.keep_scale<kDrop>(b, n, N, t_h[h], c * kBK + 8 * j + 2 * tig + e, S);
          }
          st[idx] = pr;
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_h[h] = l_h[h] * corr[h] + rsum[h];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];  // O's rows rescaled to the new max
    uint32_t ph[16], pl[16];
    split_hi_lo(st, ph, pl);
    wgmma_fence();
    rs_product<D>(acc, ph, pl, k_st + kTile);  // o += p v
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    fence_operands(ph);
    fence_operands(pl);
    if (tid == 0) mbar_arrive(&m.bars->empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_h[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int t = t_h[h];
    if (t >= T) continue;
    const bool dead = kLengths && p.row0 + t >= len;
    const bool none = !dead && l == 0.f;  // a live row with no live key in this block
    store_rows<D>(out, ((long long)b * T + t) * N + n, acc, h, dead || none ? 0.f : 1.f / l, !dead && !none, tig);
    if (p.lse != nullptr && tig == 0) {
      p.lse[((long long)b * N + n) * T + t] = dead ? 0.f : (none ? kNegInf : m_h[h] + logf(l));
    }
  }
}

template <int D, bool kLengths, bool kBias, int kDrop>
int launch_fwd(const AttnArgs& a, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = hopper::make_heads_map(&mq, a.q, a.B, a.T, a.N, D, a.qb, a.qt, a.qn);
  if (!err) err = hopper::make_heads_map(&mk, a.k, a.B, a.S, a.N, D, a.kb, a.kt, a.kn);
  if (!err) err = hopper::make_heads_map(&mv, a.v, a.B, a.S, a.N, D, a.vb, a.vt, a.vn);
  if (err) return err;
  auto kernel = attention_fwd_kernel<D, kLengths, kBias, kDrop>;
  const size_t smem = smem_bytes<D, 1, kBias ? 64 : 0, 0>();
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  // All of the SM's unified memory as shared memory: three D = 64 blocks
  // with a bias stage fit only so.
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.N, (a.T + kBQ - 1) / kBQ, a.B);
  if (grid.y > 65535 || grid.z > 65535) return -1;
  kernel<<<grid, kThreads, smem, stream>>>(mq, mk, mv, a);
  return record_fwd_launch(1, D, kLengths, kBias, kDrop);
}

}  // namespace tc

// bf16 at D = 64 and 128 takes the wgmma body (with a bias stage only when
// there is a bias), everything else the staged one; no runtime fallback.
template <typename E, int D, bool kLengths, int kDrop>
int launch(const AttnArgs& a, cudaStream_t stream) {
  if constexpr (std::is_same<E, __nv_bfloat16>::value && D >= 64) {
    if constexpr (kLengths) {
      return tc::launch_fwd<D, true, false, kDrop>(a, stream);
    } else {
      if (a.bias == nullptr) return tc::launch_fwd<D, false, false, kDrop>(a, stream);
      return tc::launch_fwd<D, false, true, kDrop>(a, stream);
    }
  } else {
    auto kernel = attention_kernel<E, D, kLengths, kDrop>;
    const size_t smem = smem_bytes<E, D>();
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(a.N, (a.T + kBQ - 1) / kBQ, a.B);
    if (grid.y > 65535 || grid.z > 65535) return -1;
    kernel<<<grid, kThreads, smem, stream>>>(a);
    return record_fwd_launch(0, D, kLengths, !kLengths && a.bias != nullptr, kDrop);
  }
}

template <typename E, int D, bool kLengths>
int launch_drop(const AttnArgs& a, cudaStream_t s) {
  switch (drop_mode(a.drop)) {
    case kDropHash: return launch<E, D, kLengths, kDropHash>(a, s);
    case kDropMask: return launch<E, D, kLengths, kDropMask>(a, s);
    default: return launch<E, D, kLengths, kDropNone>(a, s);
  }
}

template <int D, bool kLengths>
int launch_dtype(const AttnArgs& a, int dtype, cudaStream_t s) {
  if (dtype == 0) return launch_drop<float, D, kLengths>(a, s);
  if (dtype == 1) return launch_drop<__nv_bfloat16, D, kLengths>(a, s);
  return -2;
}

// Returns 0, a cudaError_t from the launch, -1 for a shape the kernel does not
// take (D not in {32, 64, 128}, an empty dim, too many query tiles or clips),
// -2 for an unknown dtype code (0 = float32, 1 = bfloat16) or -3 for bf16
// operands at D = 64 or 128 that TMA cannot map (nothing is launched).
template <bool kLengths>
int dispatch(const AttnArgs& a, int D, int dtype, void* stream) {
  if (a.B < 1 || a.T < 1 || a.S < 1 || a.N < 1) return -1;
  if (kLengths && a.lse == nullptr) return -1;
  if (!kLengths && (a.row0 != 0 || a.col0 != 0)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
#define STLT_CASE(d) \
    case d: return launch_dtype<d, kLengths>(a, dtype, s);
    STLT_HEAD_DIMS(STLT_CASE)
#undef STLT_CASE
    default: return -1;
  }
}

}  // namespace attn
}  // namespace stlt
