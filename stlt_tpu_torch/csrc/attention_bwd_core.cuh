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
// with q, k, v and dO promoted to f32, every product summed in f32 and the
// results rounded once to the storage type. Two kernels, each output with a
// single owner, so there are no atomics and two runs give the same bits:
//
// - attention_dq_kernel: one block per (clip, head, 64-query tile), keys in
//   chunks of 64 (K and V double-buffered by cp.async);
// - attention_dkdv_kernel: one block per (clip, head, 64-key chunk), query
//   tiles of 64 (q and dO double-buffered).
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
// Dead rows. The lengths-mode forward writes query rows t >= lengths[b] as
// constants (zeros, lse 0). Their p is taken as 0 and their dO as 0 (dO tiles
// are loaded with those rows zero-filled), so their dq is exactly zero and
// they add nothing to dk and dv: the exact VJP of that forward, whatever the
// caller sends into dead rows. exp(z - 0) of a dead row is never formed, so a
// large logit there cannot make inf * 0 = NaN.
//
// Products. Each warp owns 16 rows (queries in dq, keys in dk/dv) and runs
// the forward's two building blocks: chunk_logits (a [16, 64] tile of row .
// column dots: q k^T, dO v^T, k q^T, v dO^T) and chunk_pv (a [16, 64] f32
// tile times a [64, 64] tile: dz k, (p o keepc) dO, dz q). In bf16 both run on
// WMMA; chunk_pv splits the f32 probabilities and dz into bf16 hi + lo, so
// they multiply at f32 grade. In f32 both run on the SIMT pipes.
//
// Bound on this card: 10 D flops per live (query, key, head) pair (five
// products) against q, k, v, dO, lse, dsum read once and dq, dk, dv written
// once. At the long-clip shapes (B = 32, T = 257 or B = 16, T = 513) that is
// ~16-17 GFLOP and ~60-80 MB, ~250 flop/byte: near the bf16 ridge, ~0.02 ms.
// This simple kernel is far from it: the softmax terms (an expf per pair, a
// hash per pair with dropout) run on the SIMT pipes, every product goes
// through a shared-memory round trip, and in the bias mode the dk/dv kernel
// reads the bias down its columns (from L2).
#pragma once

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
  const float* lse;   // [B, N, T] from the forward
  const float* dsum;  // [B, N, T], rowsum(dO o out); 0 on dead rows
  void* dq;           // [B, T, N, kD] contiguous, storage type
  void* dk;           // [B, S, N, kD]
  void* dv;           // [B, S, N, kD]
  int B, T, S, N;
  float scale;
  Dropout drop;
};

// Two resident [64][LD] tiles and two double-buffered ones, the per-warp f32
// product scratch, the bf16 hi/lo probability tiles, then lse and dsum of
// the dq kernel's 64 queries.
template <typename E>
constexpr size_t bwd_smem_bytes() {
  constexpr int LD = Tile<E>::LD;
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

template <typename E>
__device__ __forceinline__ void zero_rows(E* base, int B_idx, int r0, int rows, int R, int N, int n) {
  for (int i = threadIdx.x; i < rows * kD; i += kThreads) {
    base[(((long long)B_idx * R + r0 + i / kD) * N + n) * kD + i % kD] = from_float<E>(0.f);
  }
}

template <typename E, bool kLengths, bool kDrop>
__global__ void __launch_bounds__(kThreads) attention_dq_kernel(BwdArgs p) {
  constexpr int LD = Tile<E>::LD;
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
    kend = min(S, len);
    qlim = min(T, len);
    if (p.causal) kend = min(kend, min(q0 + kBQ, T));
    if (q0 >= qlim) {  // no live query in the tile: dq is zero
      zero_rows(dq, b, q0, min(kBQ, T - q0), T, N, n);
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
  load_tile(q_s, qg, p.qt, q0, T);
  load_tile(do_s, dog, p.ot, q0, qlim);  // dead rows' dO lands as zeros
  load_tile(k_s, kg, p.kt, 0, kend);
  load_tile(v_s, vg, p.vt, 0, kend);
  cp_async_commit();
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    const int t = q0 + i;
    const long long idx = ((long long)b * N + n) * T + t;
    lse_s[i] = t < qlim ? p.lse[idx] : 0.f;
    dsum_s[i] = t < qlim ? p.dsum[idx] : 0.f;
  }

  const int row0 = q0 + warp * kRows;  // this warp's first query
  float acc[kRows][2], s[kRows][2], dp[kRows][2];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = 0.f;

  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {  // the next chunk lands while this one is computed
      const int nxt = ((c + 1) & 1) * kBK * LD;
      load_tile(k_s + nxt, kg, p.kt, (c + 1) * kBK, kend);
      load_tile(v_s + nxt, vg, p.vt, (c + 1) * kBK, kend);
    }
    cp_async_commit();
    cp_async_wait<1>();  // chunk c (and q, dO) has landed
    __syncthreads();
    const E* kc = k_s + (c & 1) * kBK * LD;
    const E* vc = v_s + (c & 1) * kBK * LD;
    chunk_logits(s, q_s + warp * kRows * LD, kc, scr.sc, lane);    // q k^T
    chunk_logits(dp, do_s + warp * kRows * LD, vc, scr.sc, lane);  // dO v^T

    const int s0 = c * kBK;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int t = row0 + r;
      const float lse_t = lse_s[warp * kRows + r], ds = dsum_s[warp * kRows + r];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = s0 + lane + 32 * j;
        const bool masked = t >= qlim || key >= kend || (kLengths && p.causal && key > t);
        float x = s[r][j] * p.scale;
        if (!kLengths && bias != nullptr && !masked) x += __ldg(bias + (long long)t * p.bt + key);
        float d = dp[r][j];
        if (kDrop) d *= p.drop.keep_scale(b, n, N, t, key, S);
        s[r][j] = masked ? 0.f : expf(x - lse_t) * (d - ds);  // dz
      }
    }
    chunk_pv(acc, s, kc, scr.sc, scr.ph, lane);  // dq += dz k
    __syncthreads();  // stage c & 1 is free for chunk c + 2
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = row0 + r;
    if (t >= T) break;  // uniform over the warp
    const bool live = t < qlim;
    E* row = dq + (((long long)b * T + t) * N + n) * kD;
    row[lane] = from_float<E>(live ? acc[r][0] * p.scale : 0.f);
    row[lane + 32] = from_float<E>(live ? acc[r][1] * p.scale : 0.f);
  }
}

template <typename E, bool kLengths, bool kDrop>
__global__ void __launch_bounds__(kThreads) attention_dkdv_kernel(BwdArgs p) {
  constexpr int LD = Tile<E>::LD;
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
  // wholly above the diagonal: masked, so never loaded (_causal_live).
  if (p.causal) tile0 = k0 / kBQ;
  if (kLengths) {
    const int len = p.lengths[b];
    kend = min(S, len);
    qlim = min(T, len);
    if (k0 >= kend) {  // no live key in the chunk: dk and dv are zero
      zero_rows(dk, b, k0, min(kBK, S - k0), S, N, n);
      zero_rows(dv, b, k0, min(kBK, S - k0), S, N, n);
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
  load_tile(k_s, kg, p.kt, k0, kend);
  load_tile(v_s, vg, p.vt, k0, kend);
  if (tile0 < ntiles) {
    load_tile(q_s, qg, p.qt, tile0 * kBQ, T);
    load_tile(do_s, dog, p.ot, tile0 * kBQ, qlim);  // dead rows' dO lands as zeros
  }
  cp_async_commit();

  const int key0 = k0 + warp * kRows;  // this warp's first key
  float dk_acc[kRows][2], dv_acc[kRows][2], s[kRows][2], dp[kRows][2];
#pragma unroll
  for (int r = 0; r < kRows; ++r) dk_acc[r][0] = dk_acc[r][1] = dv_acc[r][0] = dv_acc[r][1] = 0.f;

  for (int i = tile0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {  // the next query tile lands while this one is computed
      const int nxt = ((i + 1 - tile0) & 1) * kBQ * LD;
      load_tile(q_s + nxt, qg, p.qt, (i + 1) * kBQ, T);
      load_tile(do_s + nxt, dog, p.ot, (i + 1) * kBQ, qlim);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile i (and K, V) has landed
    __syncthreads();
    const int stage = ((i - tile0) & 1) * kBQ * LD;
    const E* qc = q_s + stage;
    const E* doc = do_s + stage;
    chunk_logits(s, k_s + warp * kRows * LD, qc, scr.sc, lane);    // k q^T
    chunk_logits(dp, v_s + warp * kRows * LD, doc, scr.sc, lane);  // v dO^T

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
        const bool masked = t >= qlim || key >= kend || (kLengths && p.causal && key > t);
        float x = s[r][j] * p.scale;
        if (!kLengths && bias != nullptr && !masked) x += __ldg(bias + (long long)t * p.bt + key);
        const float pr = masked ? 0.f : expf(x - lse_j[j]);
        const float keep = kDrop ? p.drop.keep_scale(b, n, N, t, key, S) : 1.f;
        s[r][j] = masked ? 0.f : pr * (dp[r][j] * keep - ds_j[j]);  // dz^T
        dp[r][j] = pr * keep;                                         // (p o keepc)^T
      }
    }
    chunk_pv(dv_acc, dp, doc, scr.sc, scr.ph, lane);  // dv += (p o keepc)^T dO
    chunk_pv(dk_acc, s, qc, scr.sc, scr.ph, lane);    // dk += dz^T q
    __syncthreads();  // the stage is free for tile i + 2
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int key = key0 + r;
    if (key >= S) break;  // uniform over the warp
    const long long off = (((long long)b * S + key) * N + n) * kD;
    dk[off + lane] = from_float<E>(dk_acc[r][0] * p.scale);
    dk[off + lane + 32] = from_float<E>(dk_acc[r][1] * p.scale);
    dv[off + lane] = from_float<E>(dv_acc[r][0]);
    dv[off + lane + 32] = from_float<E>(dv_acc[r][1]);
  }
}

template <typename E, bool kLengths, bool kDrop>
int launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<E>();
  auto dq_kernel = attention_dq_kernel<E, kLengths, kDrop>;
  auto dkdv_kernel = attention_dkdv_kernel<E, kLengths, kDrop>;
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

// Returns 0, a cudaError_t from a launch, -1 for a shape the kernels do not
// take or -2 for an unknown dtype code (0 = float32, 1 = bfloat16).
template <bool kLengths>
int dispatch_bwd(const BwdArgs& a, int D, int dtype, void* stream) {
  if (D != kD || a.B < 1 || a.T < 1 || a.S < 1 || a.N < 1) return -1;
  if (a.lse == nullptr || a.dsum == nullptr || (kLengths && a.lengths == nullptr)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return a.drop.on ? launch_bwd<float, kLengths, true>(a, s) : launch_bwd<float, kLengths, false>(a, s);
  }
  if (dtype == 1) {
    return a.drop.on ? launch_bwd<__nv_bfloat16, kLengths, true>(a, s)
                     : launch_bwd<__nv_bfloat16, kLengths, false>(a, s);
  }
  return -2;
}

}  // namespace attn
}  // namespace stlt
