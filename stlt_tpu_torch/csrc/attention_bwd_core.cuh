// The attention backward of the long-clip path: for the forward of
// attention_core.cuh,
//
//   out = (p o keepc) v,  p = softmax(q k^T * scale + bias),
//
// (keepc: the keep bits times 1/(1 - rate), all ones without dropout) and the
// output cotangent dO, the gradients dq, dk, dv in the FlashAttention-2 form
// of stlt_tpu/ops/flash.py::_blockwise_backward (:842-855):
//
//   p  = exp(z - lse)          from the forward's lse, no softmax recomputed
//   dp = (dO v^T) o keepc
//   dz = p o (dp - dsum)       dsum[t] = rowsum(dO o out), given by the caller
//   dq = dz k * scale,  dk = dz^T q * scale,  dv = (p o keepc)^T dO
//
// with q, k, v and dO taken as they are stored, every product summed in f32
// and the results rounded once to the storage type. Two kernels, each output
// with a single owner, so there are no atomics and two runs give the same
// bits:
//
// - attention_dq_kernel: one block per (clip, head, 64-query tile), the keys
//   streamed in chunks of 64;
// - attention_dkdv_kernel: one block per (clip, head, 64-key chunk), the
//   query tiles streamed.
//
// Both take the two modes of the forward (kLengths): the bias mode (the TPU
// kernel _fused_bwd_kernel, which recomputes the whole softmax where this one
// reads lse: the same function; and, behind the blockwise entry point, the
// dense-bias mode of _blockwise_dq_kernel and _blockwise_dkdv_kernel, where a
// bias declared causal skips the key chunks and query tiles wholly above the
// diagonal, as _causal_live does) and the lengths mode (the same two TPU
// kernels with lengths_bias), where key chunks past the clip's length or
// above the diagonal and dead query tiles are skipped. T and S are free in
// both (33 queries against 513 keys and back in the fusion models).
//
// Ring offsets (the lengths mode's row0, col0: the TPU kernels with off_base
// and valid_cols, one call per step of the ring's backward): local query t
// and key s are global row0 + t and col0 + s, as in the forward
// (attention_core.cuh). The skipped ranges move with them: the dq kernel
// takes keys below kend = clamp(len - col0, 0, S) (and, causal, below
// row0 + (the tile's last query + 1) - col0, which can be <= 0), the dk/dv
// kernel query tiles from max(0, (k0 + col0 - row0) / 64) up to qlim =
// clamp(len - row0, 0, T), which can leave none. A block whose whole work
// is skipped still writes its zeros: the ring adds every step's dq, dk, dv.
// p = exp(z - lse) reads the ring's global lse, which is finite on every
// live row, so a live row with no live key in the held chunk gets p = 0 and
// no NaN. Row0 = col0 = 0 is the plain lengths mode. The dropout bits hash
// the local (t, s), as the forward's do.
//
// Dead rows. The lengths-mode forward writes query rows t >= lengths[b] as
// constants (zeros, lse 0). Their p is taken as 0 and their dO as 0 (the
// rows of a dO tile from the clip's length on are zeros in shared memory
// before any product reads them), so their dq is exactly zero and they add
// nothing to dk and dv: the exact VJP of that forward, whatever the caller
// sends into dead rows. exp(z - 0) of a dead row is never formed, so a large
// logit there cannot make inf * 0 = NaN.
//
// Dropout reads its keep bits as the forward does (attention_core.cuh:
// hashed from the seed, or in mask mode from the caller's uint8 mask; the
// mode a template argument).
//
// Two bodies, chosen by the storage type and the head dim at launch:
//
// bf16 at D = 64 and 128 (every model's heads but those of H = 256 with 8
// heads): Hopper's tensor cores through wgmma on tiles that TMA lands, on the
// building blocks the forward shares (attention_tc.cuh). One consumer
// warpgroup owns the block's 64 rows (keys in dk/dv, queries in dq) and one
// producer warp fills a two-stage ring behind mbarriers:
//
// - TMA loads q, k, v and dO as 4-D tensors (D, N, rows, B) read through
//   their strides, in boxes of 64 rows x 64 d (D = 128 is two boxes), so a
//   ring step's column view (kb != S kt) needs no copy and a clip's last tile
//   reads zeros past its rows (513 = 8 * 64 + 1), never the next clip's,
//   whose NaN or inf would survive a masked 0 * inf;
// - the dk/dv kernel forms S^T = K Q^T and dP^T = V dO^T (keys as M, both
//   operands K-major over D), the dq kernel S = Q K^T and dP = dO V^T: four
//   or eight m64n64k16 wgmmas each from shared memory;
// - the softmax terms are formed on the accumulator fragments, each thread
//   on its own 32 (row, column) pairs, and rounded in place into the A
//   fragments of the output products, which the RS wgmma reads from
//   registers: dV += (P o keepc)^T dO and dK += dZ^T Q (the B operand dO or
//   q as stored, [queries][D], so MN-major), dQ += dZ K (k MN-major). No
//   product makes a shared-memory round trip;
// - P o keepc and dZ are f32; each multiplies as two bf16 parts, hi =
//   bf16(x) and lo = bf16(x - hi), two RS wgmmas into one accumulator, so
//   the output products keep f32-grade probabilities (hi alone reads 2.5e-3
//   to 2.7e-3 against BWD_REL's 1e-3: utils/bwd_tolerance.py, PERF.md §6);
// - the bias is f32 with arbitrary (b, n, t) strides (a row of 513 keys is
//   2,052 bytes; a key-padding bias has t stride 0), which TMA cannot take:
//   the producer copies each [64 query x 64 key] tile with 4-byte cp.async,
//   lanes along the keys, onto the stage's barrier, and the dk/dv kernel
//   reads it transposed from shared memory (rows of 68 floats: conflict
//   free); the dk/dv kernel's lse and dsum of a query tile come the same way.
//
// f32, and bf16 at D = 32 (the staged bodies): four warps of 16 rows each
// run the forward's building blocks: chunk_logits (a [16, 64] tile of row .
// column dots) and chunk_pv (a [16, 64] f32 tile times a [64, D] tile), on
// WMMA in bf16 (with the same hi + lo split) through a per-warp shared
// scratch, on the SIMT pipes in f32, so f32 stays true f32; K and V (or q
// and dO) double-buffered by cp.async, rows past a limit zero-filled.
//
// Bound on this card: 10 D flops per live (query, key, head) pair (five
// products) against q, k, v, dO, lse, dsum read once and dq, dk, dv written
// once. At the long-clip shapes (B = 32, T = 257 or B = 16, T = 513) that is
// ~16-17 GFLOP and ~60-80 MB, ~250 flop/byte: near the bf16 ridge, ~0.02 ms.
// The wgmma body spends what it does on the SIMT side: an exp2 per pair in
// each kernel, a hash per pair with dropout, the bias tile's copy, the hi/lo
// split; the warpgroup does not overlap one tile's softmax terms with
// another's products (the SM's second block does).
#pragma once

#include <type_traits>

#include "attention_core.cuh"

namespace stlt {
namespace attn {

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  long long qb, qt, qn, kb, kt, kn, vb, vt, vn, ob, ot, on;  // element strides of b, t (s), n
  const float* bias;                                          // bias mode; nullptr adds 0
  long long bb, bn, bt;                                       // bias strides of b, n, t
  const int* lengths;                                         // lengths mode: [B] live keys
  int causal;
  int row0, col0;     // lengths mode: global index of local query 0 and key 0 (a ring step)
  const float* lse;   // [B, N, T] from the forward
  const float* dsum;  // [B, N, T], rowsum(dO o out); 0 on dead rows
  void* dq;           // [B, T, N, D] contiguous, storage type
  void* dk;           // [B, S, N, D]
  void* dv;           // [B, S, N, D]
  int B, T, S, N;
  float scale;
  MaskedDropout drop;
};

// The staged bodies' shared memory: two resident [64][LD] tiles and two
// double-buffered ones, the per-warp f32 product scratch, the bf16 hi/lo
// probability tiles, then lse and dsum of the dq kernel's 64 queries. At
// D = 128: 219,648 bytes in f32, inside the 227 KB a block may take.
template <typename E, int D>
constexpr size_t bwd_smem_bytes() {
  constexpr int LD = Tile<E, D>::LD;
  size_t bytes = sizeof(E) * (size_t)(2 * kBQ + 4 * kBK) * LD +
                 sizeof(float) * (size_t)kWarps * kRows * kBK + sizeof(float) * 2 * kBQ;
  if (sizeof(E) == 2) bytes += 2 * sizeof(E) * (size_t)kWarps * kRows * kLDP;
  return bytes;
}

// The per-warp scratch that follows the four tiles of `tiles` elements.
template <typename E>
struct BwdScratch {
  float* sc;          // this warp's [kRows][kBK] f32 tile
  __nv_bfloat16* ph;  // this warp's hi and lo [kRows][kLDP] bf16 tiles
  float* rows;        // [2][kBQ]: lse and dsum of the block's queries
  __device__ BwdScratch(E* tiles_end, int warp) {
    float* sc_all = reinterpret_cast<float*>(tiles_end);
    sc = sc_all + warp * kRows * kBK;
    __nv_bfloat16* ph_all = reinterpret_cast<__nv_bfloat16*>(sc_all + kWarps * kRows * kBK);
    ph = ph_all + warp * 2 * kRows * kLDP;
    rows = reinterpret_cast<float*>(ph_all + (sizeof(E) == 2 ? kWarps * 2 * kRows * kLDP : 0));
  }
};

template <typename E, int D, bool kLengths, int kDrop>
__global__ void __launch_bounds__(kThreads) attention_dq_staged_kernel(BwdArgs p) {
  constexpr int LD = Tile<E, D>::LD, kO = D / 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  E* q_s = reinterpret_cast<E*>(smem_raw);  // [kBQ][LD]
  E* do_s = q_s + kBQ * LD;                 // [kBQ][LD]
  E* k_s = do_s + kBQ * LD;                 // two stages of [kBK][LD]
  E* v_s = k_s + 2 * kBK * LD;              // two stages of [kBK][LD]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const BwdScratch<E> scr(v_s + 2 * kBK * LD, warp);
  float* lse_s = scr.rows;
  float* dsum_s = scr.rows + kBQ;

  const int n = blockIdx.x, q0 = blockIdx.y * kBQ, b = blockIdx.z;
  const int T = p.T, S = p.S, N = p.N;
  E* __restrict__ dq = static_cast<E*>(p.dq);
  int kend = S, qlim = T;  // keys >= kend and queries >= qlim carry nothing
  // Dense bias declared causal: keys above the tile's last diagonal are
  // masked by the bias, so their chunks are never loaded (_causal_live).
  if (!kLengths && p.causal) kend = min(S, min(q0 + kBQ, T));
  if (kLengths) {
    const int len = p.lengths[b];
    kend = min(S, len - p.col0);
    qlim = max(0, min(T, len - p.row0));
    // causal: global key col0 + s <= row0 + (last query of the tile)
    if (p.causal) kend = min(kend, p.row0 + min(q0 + kBQ, T) - p.col0);
    kend = max(kend, 0);
    if (q0 >= qlim) {  // no live query in the tile: dq is zero
      zero_rows<D>(dq, b, q0, min(kBQ, T - q0), T, N, n);
      return;
    }
  }

  const E* qg = static_cast<const E*>(p.q) + b * p.qb + n * p.qn;
  const E* kg = static_cast<const E*>(p.k) + b * p.kb + n * p.kn;
  const E* vg = static_cast<const E*>(p.v) + b * p.vb + n * p.vn;
  const E* dog = static_cast<const E*>(p.dout) + b * p.ob + n * p.on;
  const float* bias = nullptr;
  if (!kLengths && p.bias != nullptr) bias = p.bias + b * p.bb + n * p.bn;
  const int nchunks = (kend + kBK - 1) / kBK;
  load_tile<D>(q_s, qg, p.qt, q0, T);
  load_tile<D>(do_s, dog, p.ot, q0, qlim);  // dead rows' dO lands as zeros
  load_tile<D>(k_s, kg, p.kt, 0, kend);
  load_tile<D>(v_s, vg, p.vt, 0, kend);
  cp_async_commit();
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    const int t = q0 + i;
    const long long idx = ((long long)b * N + n) * T + t;
    lse_s[i] = t < qlim ? p.lse[idx] : 0.f;
    dsum_s[i] = t < qlim ? p.dsum[idx] : 0.f;
  }

  const int row0 = q0 + warp * kRows;  // this warp's first query
  float acc[kRows][kO], s[kRows][2], dp[kRows][2];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kO; ++j) acc[r][j] = 0.f;

  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {  // the next chunk lands while this one is computed
      const int nxt = ((c + 1) & 1) * kBK * LD;
      load_tile<D>(k_s + nxt, kg, p.kt, (c + 1) * kBK, kend);
      load_tile<D>(v_s + nxt, vg, p.vt, (c + 1) * kBK, kend);
    }
    cp_async_commit();
    cp_async_wait<1>();  // chunk c (and q, dO) has landed
    __syncthreads();
    const E* kc = k_s + (c & 1) * kBK * LD;
    const E* vc = v_s + (c & 1) * kBK * LD;
    chunk_logits<D>(s, q_s + warp * kRows * LD, kc, scr.sc, lane);    // q k^T
    chunk_logits<D>(dp, do_s + warp * kRows * LD, vc, scr.sc, lane);  // dO v^T

    const int s0 = c * kBK;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int t = row0 + r;
      const float lse_t = lse_s[warp * kRows + r], ds = dsum_s[warp * kRows + r];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = s0 + lane + 32 * j;
        const bool masked =
            t >= qlim || key >= kend || (kLengths && p.causal && p.col0 + key > p.row0 + t);
        float x = s[r][j] * p.scale;
        if (!kLengths && bias != nullptr && !masked) x += __ldg(bias + (long long)t * p.bt + key);
        float d = dp[r][j];
        if (kDrop != kDropNone) d *= p.drop.keep_scale<kDrop>(b, n, N, t, key, S);
        s[r][j] = masked ? 0.f : expf(x - lse_t) * (d - ds);  // dz
      }
    }
    chunk_pv<D>(acc, s, kc, scr.sc, scr.ph, lane);  // dq += dz k
    __syncthreads();  // stage c & 1 is free for chunk c + 2
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = row0 + r;
    if (t >= T) break;  // uniform over the warp
    const bool live = t < qlim;
    E* row = dq + (((long long)b * T + t) * N + n) * D;
#pragma unroll
    for (int j = 0; j < kO; ++j) row[lane + 32 * j] = from_float<E>(live ? acc[r][j] * p.scale : 0.f);
  }
}

template <typename E, int D, bool kLengths, int kDrop>
__global__ void __launch_bounds__(kThreads) attention_dkdv_staged_kernel(BwdArgs p) {
  constexpr int LD = Tile<E, D>::LD, kO = D / 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  E* k_s = reinterpret_cast<E*>(smem_raw);  // [kBK][LD]
  E* v_s = k_s + kBK * LD;                  // [kBK][LD]
  E* q_s = v_s + kBK * LD;                  // two stages of [kBQ][LD]
  E* do_s = q_s + 2 * kBQ * LD;             // two stages of [kBQ][LD]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const BwdScratch<E> scr(do_s + 2 * kBQ * LD, warp);

  const int n = blockIdx.x, k0 = blockIdx.y * kBK, b = blockIdx.z;
  const int T = p.T, S = p.S, N = p.N;
  E* __restrict__ dk = static_cast<E*>(p.dk);
  E* __restrict__ dv = static_cast<E*>(p.dv);
  int kend = S, qlim = T, tile0 = 0;
  // With causal (either mode) query tiles before the chunk's first key lie
  // wholly above the diagonal: masked, so never loaded (_causal_live; at
  // global indices with ring offsets, _causal_live_off).
  if (p.causal) tile0 = max(0, (k0 + p.col0 - p.row0) / kBQ);
  if (kLengths) {
    const int len = p.lengths[b];
    kend = max(0, min(S, len - p.col0));
    qlim = max(0, min(T, len - p.row0));
    if (k0 >= kend) {  // no live key in the chunk: dk and dv are zero
      zero_rows<D>(dk, b, k0, min(kBK, S - k0), S, N, n);
      zero_rows<D>(dv, b, k0, min(kBK, S - k0), S, N, n);
      return;
    }
  }

  const E* qg = static_cast<const E*>(p.q) + b * p.qb + n * p.qn;
  const E* kg = static_cast<const E*>(p.k) + b * p.kb + n * p.kn;
  const E* vg = static_cast<const E*>(p.v) + b * p.vb + n * p.vn;
  const E* dog = static_cast<const E*>(p.dout) + b * p.ob + n * p.on;
  const float* bias = nullptr;
  if (!kLengths && p.bias != nullptr) bias = p.bias + b * p.bb + n * p.bn;
  const float* lse = p.lse + ((long long)b * N + n) * T;
  const float* dsum = p.dsum + ((long long)b * N + n) * T;
  const int ntiles = (qlim + kBQ - 1) / kBQ;
  load_tile<D>(k_s, kg, p.kt, k0, kend);
  load_tile<D>(v_s, vg, p.vt, k0, kend);
  if (tile0 < ntiles) {
    load_tile<D>(q_s, qg, p.qt, tile0 * kBQ, T);
    load_tile<D>(do_s, dog, p.ot, tile0 * kBQ, qlim);  // dead rows' dO lands as zeros
  }
  cp_async_commit();

  const int key0 = k0 + warp * kRows;  // this warp's first key
  float dk_acc[kRows][kO], dv_acc[kRows][kO], s[kRows][2], dp[kRows][2];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kO; ++j) dk_acc[r][j] = dv_acc[r][j] = 0.f;

  for (int i = tile0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {  // the next query tile lands while this one is computed
      const int nxt = ((i + 1 - tile0) & 1) * kBQ * LD;
      load_tile<D>(q_s + nxt, qg, p.qt, (i + 1) * kBQ, T);
      load_tile<D>(do_s + nxt, dog, p.ot, (i + 1) * kBQ, qlim);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile i (and K, V) has landed
    __syncthreads();
    const int stage = ((i - tile0) & 1) * kBQ * LD;
    const E* qc = q_s + stage;
    const E* doc = do_s + stage;
    chunk_logits<D>(s, k_s + warp * kRows * LD, qc, scr.sc, lane);    // k q^T
    chunk_logits<D>(dp, v_s + warp * kRows * LD, doc, scr.sc, lane);  // v dO^T

    const int t0 = i * kBQ;
    float lse_j[2], ds_j[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int t = t0 + lane + 32 * j;
      lse_j[j] = t < qlim ? __ldg(lse + t) : 0.f;
      ds_j[j] = t < qlim ? __ldg(dsum + t) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int key = key0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int t = t0 + lane + 32 * j;
        const bool masked =
            t >= qlim || key >= kend || (kLengths && p.causal && p.col0 + key > p.row0 + t);
        float x = s[r][j] * p.scale;
        if (!kLengths && bias != nullptr && !masked) x += __ldg(bias + (long long)t * p.bt + key);
        const float pr = masked ? 0.f : expf(x - lse_j[j]);
        const float keep = kDrop != kDropNone ? p.drop.keep_scale<kDrop>(b, n, N, t, key, S) : 1.f;
        s[r][j] = masked ? 0.f : pr * (dp[r][j] * keep - ds_j[j]);  // dz^T
        dp[r][j] = pr * keep;                                         // (p o keepc)^T
      }
    }
    chunk_pv<D>(dv_acc, dp, doc, scr.sc, scr.ph, lane);  // dv += (p o keepc)^T dO
    chunk_pv<D>(dk_acc, s, qc, scr.sc, scr.ph, lane);    // dk += dz^T q
    __syncthreads();  // the stage is free for tile i + 2
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int key = key0 + r;
    if (key >= S) break;  // uniform over the warp
    const long long off = (((long long)b * S + key) * N + n) * D;
#pragma unroll
    for (int j = 0; j < kO; ++j) {
      dk[off + lane + 32 * j] = from_float<E>(dk_acc[r][j] * p.scale);
      dv[off + lane + 32 * j] = from_float<E>(dv_acc[r][j]);
    }
  }
}


// --- bf16 at D = 64 and 128: wgmma on TMA-fed tiles ---------------------------

namespace tc {

// Zeros into rows r_from .. 63 of a [64][D] tile, by the consumer warpgroup.
// A box row stays 128 contiguous bytes under the 128-byte swizzle (which
// permutes the 16-byte chunks within a row), so whole rows are cleared.
template <int D>
__device__ __forceinline__ void zero_tile_rows(bf16* tile, int r_from, int tid) {
#pragma unroll
  for (int box = 0; box < D / 64; ++box) {
    uint4* rows = reinterpret_cast<uint4*>(tile + box * 64 * 64 + r_from * 64);
    for (int i = tid; i < (64 - r_from) * 8; i += kConsumers) rows[i] = make_uint4(0, 0, 0, 0);
  }
}

template <int D, bool kLengths, int kDrop>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
    attention_dq_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
                        BwdArgs p) {
  using namespace hopper;
  constexpr int kTile = tile_elems<D>();
  constexpr uint32_t kTileBytes = kTile * sizeof(bf16);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int n = blockIdx.x, q0 = blockIdx.y * kBQ, b = blockIdx.z;
  const int T = p.T, S = p.S, N = p.N;
  bf16* __restrict__ dq = static_cast<bf16*>(p.dq);
  int kend = S, qlim = T;  // keys >= kend and queries >= qlim carry nothing
  // Dense bias declared causal: keys above the tile's last diagonal are
  // masked by the bias, so their chunks are never loaded (_causal_live).
  if (!kLengths && p.causal) kend = min(min(q0 + kBQ, T), S);
  if (kLengths) {
    const int len = p.lengths[b];
    kend = min(S, len - p.col0);
    qlim = max(0, min(T, len - p.row0));
    // causal: global key col0 + s <= row0 + (last query of the tile)
    if (p.causal) kend = min(kend, p.row0 + min(q0 + kBQ, T) - p.col0);
    kend = max(kend, 0);
    if (q0 >= qlim) {  // no live query in the tile: dq is zero
      zero_rows<D>(dq, b, q0, min(kBQ, T - q0), T, N, n);
      return;
    }
  }
  const int nchunks = (kend + kBK - 1) / kBK;
  const Smem m = carve<D, 2, kLdR>(smem_raw);
  const float* bias = !kLengths && p.bias != nullptr ? p.bias + b * p.bb + n * p.bn : nullptr;
  bf16* q_s = m.res;
  bf16* do_s = m.res + kTile;

  if (threadIdx.x >= kConsumers) {  // the producer warp
    const int lane = threadIdx.x - kConsumers;
    if (nchunks == 0) return;
    if (lane == 0) {
      mbar_expect_tx(&m.bars->once, 2 * kTileBytes);
      load_tile<D>(q_s, &map_q, &m.bars->once, n, q0, b);
      load_tile<D>(do_s, &map_do, &m.bars->once, n, q0, b);
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
      if (bias != nullptr) {
        load_bias_tile(m.bias + s * 64 * kLdR, kLdR, bias, p.bt, 1, q0, T, c * kBK, kend, lane);
      }
      cp_async_mbar_arrive(&m.bars->full[s]);
    }
    cp_async_wait_all();
    return;
  }

  const int tid = threadIdx.x, w = tid >> 5, g = (tid & 31) >> 2, tig = tid & 3;
  int t_h[2];
  float lse_h[2], ds_h[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    t_h[h] = q0 + 16 * w + g + 8 * h;
    const long long idx = ((long long)b * N + n) * T + t_h[h];
    lse_h[h] = t_h[h] < qlim ? p.lse[idx] : 0.f;
    ds_h[h] = t_h[h] < qlim ? p.dsum[idx] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  if (nchunks > 0) mbar_wait(&m.bars->once, 0);
  for (int c = 0; c < nchunks; ++c) {
    const int s = c % kStages;
    mbar_wait(&m.bars->full[s], (c / kStages) & 1);
    const bf16* k_st = m.str + 2 * s * kTile;
    float st[32], dpt[32];
    wgmma_fence();
    ss_logits<D>(st, q_s, k_st);           // q k^T
    ss_logits<D>(dpt, do_s, k_st + kTile);  // dO v^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(st);
    fence_operands(dpt);

    const float* bias_st = m.bias + s * 64 * kLdR;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t_h[h], col = 8 * j + 2 * tig;
        float2 bb = make_float2(0.f, 0.f);
        if (bias != nullptr) bb = *reinterpret_cast<const float2*>(bias_st + (16 * w + g + 8 * h) * kLdR + col);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * j + 2 * h + e, key = c * kBK + col + e;
          const bool masked =
              t >= qlim || key >= kend || (kLengths && p.causal && p.col0 + key > p.row0 + t);
          const float x = st[idx] * p.scale + (e ? bb.y : bb.x);
          float d = dpt[idx];
          if (kDrop != kDropNone) d *= p.drop.keep_scale<kDrop>(b, n, N, t, key, S);
          st[idx] = masked ? 0.f : exp2f((x - lse_h[h]) * kLog2e) * (d - ds_h[h]);  // dz
        }
      }
    }
    uint32_t zh[16], zl[16];
    split_hi_lo(st, zh, zl);
    wgmma_fence();
    rs_product<D>(acc, zh, zl, k_st);  // dq += dz k
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    fence_operands(zh);
    fence_operands(zl);
    if (tid == 0) mbar_arrive(&m.bars->empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t_h[h];
    if (t < T) store_rows<D>(dq, ((long long)b * T + t) * N + n, acc, h, p.scale, t < qlim, tig);
  }
}

template <int D, bool kLengths, int kDrop>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
    attention_dkdv_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
                          BwdArgs p) {
  using namespace hopper;
  constexpr int kTile = tile_elems<D>();
  constexpr uint32_t kTileBytes = kTile * sizeof(bf16);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int n = blockIdx.x, k0 = blockIdx.y * kBK, b = blockIdx.z;
  const int T = p.T, S = p.S, N = p.N;
  bf16* __restrict__ dk = static_cast<bf16*>(p.dk);
  bf16* __restrict__ dv = static_cast<bf16*>(p.dv);
  int kend = S, qlim = T, tile0 = 0;
  // With causal (either mode) query tiles before the chunk's first key lie
  // wholly above the diagonal: masked, so never loaded (_causal_live; at
  // global indices with ring offsets, _causal_live_off).
  if (p.causal) tile0 = max(0, (k0 + p.col0 - p.row0) / kBQ);
  if (kLengths) {
    const int len = p.lengths[b];
    kend = max(0, min(S, len - p.col0));
    qlim = max(0, min(T, len - p.row0));
    if (k0 >= kend) {  // no live key in the chunk: dk and dv are zero
      zero_rows<D>(dk, b, k0, min(kBK, S - k0), S, N, n);
      zero_rows<D>(dv, b, k0, min(kBK, S - k0), S, N, n);
      return;
    }
  }
  const int ntiles = (qlim + kBQ - 1) / kBQ;
  const Smem m = carve<D, 2, kLdT>(smem_raw);
  const float* bias = !kLengths && p.bias != nullptr ? p.bias + b * p.bb + n * p.bn : nullptr;
  bf16* k_s = m.res;
  bf16* v_s = m.res + kTile;

  if (threadIdx.x >= kConsumers) {  // the producer warp
    const int lane = threadIdx.x - kConsumers;
    if (tile0 >= ntiles) return;
    if (lane == 0) {
      mbar_expect_tx(&m.bars->once, 2 * kTileBytes);
      load_tile<D>(k_s, &map_k, &m.bars->once, n, k0, b);
      load_tile<D>(v_s, &map_v, &m.bars->once, n, k0, b);
    }
    const float* lse = p.lse + ((long long)b * N + n) * T;
    const float* dsum = p.dsum + ((long long)b * N + n) * T;
    for (int i = tile0; i < ntiles; ++i) {
      const int it = i - tile0, s = it % kStages;
      if (it >= kStages) mbar_wait(&m.bars->empty[s], (it / kStages - 1) & 1);
      bf16* q_st = m.str + 2 * s * kTile;
      if (lane == 0) {
        mbar_expect_tx(&m.bars->full[s], 2 * kTileBytes);
        load_tile<D>(q_st, &map_q, &m.bars->full[s], n, i * kBQ, b);
        load_tile<D>(q_st + kTile, &map_do, &m.bars->full[s], n, i * kBQ, b);
      }
      float* rows = m.rows + 128 * s;
      for (int r = lane; r < kBQ; r += 32) {
        const int t = i * kBQ + r;
        cp_async4_zfill(rows + r, t < qlim ? lse + t : lse, t < qlim);
        cp_async4_zfill(rows + kBQ + r, t < qlim ? dsum + t : dsum, t < qlim);
      }
      if (bias != nullptr) {
        load_bias_tile(m.bias + s * 64 * kLdT, kLdT, bias, p.bt, 1, i * kBQ, qlim, k0, kend, lane);
      }
      cp_async_mbar_arrive(&m.bars->full[s]);
    }
    cp_async_wait_all();
    return;
  }

  const int tid = threadIdx.x, w = tid >> 5, g = (tid & 31) >> 2, tig = tid & 3;
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  if (tile0 < ntiles) mbar_wait(&m.bars->once, 0);
  for (int i = tile0; i < ntiles; ++i) {
    const int it = i - tile0, s = it % kStages;
    mbar_wait(&m.bars->full[s], (it / kStages) & 1);
    bf16* q_st = m.str + 2 * s * kTile;
    bf16* do_st = q_st + kTile;
    const int t0 = i * kBQ;
    if (kLengths && t0 + kBQ > qlim) {  // dead rows' dO: zeros, whatever the caller sent
      zero_tile_rows<D>(do_st, qlim - t0, tid);
      fence_proxy_async();
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");  // the warpgroup alone
    }
    float st[32], dpt[32];
    wgmma_fence();
    ss_logits<D>(st, k_s, q_st);    // k q^T
    ss_logits<D>(dpt, v_s, do_st);  // v dO^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(st);
    fence_operands(dpt);

    const float* bias_st = m.bias + s * 64 * kLdT;
    const float* lse_st = m.rows + 128 * s;
    const float* dsum_st = lse_st + kBQ;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * tig + e, t = t0 + col;
        const float lse_t = lse_st[col], ds_t = dsum_st[col];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int idx = 4 * j + 2 * h + e, kr = 16 * w + g + 8 * h, key = k0 + kr;
          const bool masked =
              t >= qlim || key >= kend || (kLengths && p.causal && p.col0 + key > p.row0 + t);
          float x = st[idx] * p.scale;
          if (bias != nullptr) x += bias_st[col * kLdT + kr];
          const float pr = masked ? 0.f : exp2f((x - lse_t) * kLog2e);
          const float keep = kDrop == kDropNone ? 1.f : p.drop.keep_scale<kDrop>(b, n, N, t, key, S);
          st[idx] = masked ? 0.f : pr * (dpt[idx] * keep - ds_t);  // dz^T
          dpt[idx] = pr * keep;                                     // (p o keepc)^T
        }
      }
    }
    // One operand's fragments at a time, each product waited for before the
    // next operand is split, so that at most one operand's fragments are live
    // beside the two accumulators. (ptxas still serialises these wgmmas at
    // the register cap of two blocks an SM, C7512; without that cap the
    // kernel is slower at one block an SM: PERF.md §6.)
    {
      uint32_t ph[16], pl[16];
      split_hi_lo(dpt, ph, pl);
      wgmma_fence();
      rs_product<D>(dv_acc, ph, pl, do_st);  // dv += (p o keepc)^T dO
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(dv_acc);
      fence_operands(ph);
      fence_operands(pl);
    }
    {
      uint32_t zh[16], zl[16];
      split_hi_lo(st, zh, zl);
      wgmma_fence();
      rs_product<D>(dk_acc, zh, zl, q_st);  // dk += dz^T q
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(dk_acc);
      fence_operands(zh);
      fence_operands(zl);
    }
    if (tid == 0) mbar_arrive(&m.bars->empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + 16 * w + g + 8 * h;
    if (key >= S) continue;
    const long long row = ((long long)b * S + key) * N + n;
    store_rows<D>(dk, row, dk_acc, h, p.scale, true, tig);
    store_rows<D>(dv, row, dv_acc, h, 1.f, true, tig);
  }
}

template <int D, bool kLengths, int kDrop>
int launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mo;
  int err = hopper::make_heads_map(&mq, a.q, a.B, a.T, a.N, D, a.qb, a.qt, a.qn);
  if (!err) err = hopper::make_heads_map(&mk, a.k, a.B, a.S, a.N, D, a.kb, a.kt, a.kn);
  if (!err) err = hopper::make_heads_map(&mv, a.v, a.B, a.S, a.N, D, a.vb, a.vt, a.vn);
  if (!err) err = hopper::make_heads_map(&mo, a.dout, a.B, a.T, a.N, D, a.ob, a.ot, a.on);
  if (err) return err;
  auto dq_kernel = attention_dq_kernel<D, kLengths, kDrop>;
  auto dkdv_kernel = attention_dkdv_kernel<D, kLengths, kDrop>;
  const size_t smem_q = smem_bytes<D, 2, kLdR, 128>(), smem_k = smem_bytes<D, 2, kLdT, 128>();
  cudaError_t e = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_k);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_q(a.N, (a.T + kBQ - 1) / kBQ, a.B), grid_k(a.N, (a.S + kBK - 1) / kBK, a.B);
  if (grid_q.y > 65535 || grid_k.y > 65535 || grid_q.z > 65535) return -1;
  dq_kernel<<<grid_q, kThreads, smem_q, stream>>>(mq, mk, mv, mo, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dkdv_kernel<<<grid_k, kThreads, smem_k, stream>>>(mq, mk, mv, mo, a);
  return (int)cudaGetLastError();
}

}  // namespace tc

template <typename E, int D, bool kLengths, int kDrop>
int launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  if constexpr (std::is_same<E, __nv_bfloat16>::value && D >= 64) {
    return tc::launch_bwd<D, kLengths, kDrop>(a, stream);
  } else {
    const size_t smem = bwd_smem_bytes<E, D>();
    auto dq_kernel = attention_dq_staged_kernel<E, D, kLengths, kDrop>;
    auto dkdv_kernel = attention_dkdv_staged_kernel<E, D, kLengths, kDrop>;
    cudaError_t err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid_q(a.N, (a.T + kBQ - 1) / kBQ, a.B), grid_k(a.N, (a.S + kBK - 1) / kBK, a.B);
    if (grid_q.y > 65535 || grid_k.y > 65535 || grid_q.z > 65535) return -1;
    dq_kernel<<<grid_q, kThreads, smem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    dkdv_kernel<<<grid_k, kThreads, smem, stream>>>(a);
    return (int)cudaGetLastError();
  }
}

template <typename E, int D, bool kLengths>
int launch_bwd_drop(const BwdArgs& a, cudaStream_t s) {
  switch (drop_mode(a.drop)) {
    case kDropHash: return launch_bwd<E, D, kLengths, kDropHash>(a, s);
    case kDropMask: return launch_bwd<E, D, kLengths, kDropMask>(a, s);
    default: return launch_bwd<E, D, kLengths, kDropNone>(a, s);
  }
}

template <int D, bool kLengths>
int launch_bwd_dtype(const BwdArgs& a, int dtype, cudaStream_t s) {
  if (dtype == 0) return launch_bwd_drop<float, D, kLengths>(a, s);
  if (dtype == 1) return launch_bwd_drop<__nv_bfloat16, D, kLengths>(a, s);
  return -2;
}

// Returns 0, a cudaError_t from a launch, -1 for a shape the kernels do not
// take (D not in {32, 64, 128}, an empty dim), -2 for an unknown dtype code
// (0 = float32, 1 = bfloat16) or -3 for operands TMA cannot map.
template <bool kLengths>
int dispatch_bwd(const BwdArgs& a, int D, int dtype, void* stream) {
  if (a.B < 1 || a.T < 1 || a.S < 1 || a.N < 1) return -1;
  if (a.lse == nullptr || a.dsum == nullptr || (kLengths && a.lengths == nullptr)) return -1;
  if (a.row0 < 0 || a.col0 < 0 || (!kLengths && (a.row0 != 0 || a.col0 != 0))) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
#define STLT_CASE(d) \
    case d: return launch_bwd_dtype<d, kLengths>(a, dtype, s);
    STLT_HEAD_DIMS(STLT_CASE)
#undef STLT_CASE
    default: return -1;
  }
}

}  // namespace attn
}  // namespace stlt
