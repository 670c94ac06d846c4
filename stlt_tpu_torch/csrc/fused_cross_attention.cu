// Cross-attention sublayer of the fusion models, eval: for each row b of
// x [rows, T, H] (queries) and ctx [rows, S, H] (keys and values),
//
//   q   = x @ Wq + bq, kv = ctx @ Wkv + bkv     (each rounded to the compute dtype)
//   o_h = softmax(q_h k_h^T / sqrt(D) + bias) v_h     (f32 logits and softmax)
//   y   = concat_h(o_h) @ Wo + bo               (o_h rounded before the product)
//
// with Wkv = [Wk | Wv] and a head-invariant f32 bias [rows or 1, T or 1, S]
// read through its strides. T, S <= 64.
//
// Replaces the TPU kernel stlt_tpu/ops/fused_encoder.py::_fused_cross_attn_kernel
// as launched by fused_cross_attention. The numerics follow its contract; its
// TPU blocking (T and S padded to 8, padded keys at bias -1e9, row blocks with
// the weights resident in VMEM) does not carry over: here the loops stop at
// the real S, so there are no padded keys, and a row whose keys are all masked
// by the caller's -1e9 bias gets finite logits and a finite softmax.
//
// bf16 (launch_tc): split at the contract's rounding points onto Hopper's
// tensor cores (sublayer.cuh): a q GEMM (round(x Wq + bq) [rows * T, H]), a
// kv GEMM (round(ctx Wkv + bkv) [rows * S, 2H]), the short-attention kernel
// (each (row, head)'s rounded output [rows * T, H]) and the out GEMM
// (round(o Wo + bo)), four launches over a bf16 scratch. The weights come as
// the model stores them (Wq = in_proj_weight[:H], Wkv = in_proj_weight[H:],
// Wo = out_proj.weight, each [N, K]) and are read where they lie, each once
// per 128-token tile. Bound on this card: at the fusion models' shapes (B =
// 32, T = 17 against S = 33 and back, H = 768) the projections are ~4 * rows
// * (T + S) * H^2 flops (~3 GFLOP) against ~3 MB of weights and activations:
// ~1000 flop/byte, above the H100's ~295 flop/byte ridge, so the tensor
// cores bound it (a few microseconds); at these small stages the launches
// and the host weigh more.
//
// The model axis (stlt_fused_cross_attention_partial): a model rank's N / M
// heads, q/k/v width Hq = H / M (wq [H, Hq], wkv [H, 2Hq], wo [Hq, H]), as
// fused_proj_attention.cu's partial mode: the out-projection's f32 partial
// [rows * T, H] with no bias, then after the model ranks' f32 sum a row
// kernel (cross_sum_kernel, stlt_fused_cross_attention_sum) writes round(s +
// bo).
//
// f32: two kernels on the SIMT pipes, so f32 stays true f32: kv_proj writes
// kv = ctx @ Wkv + bkv into a [rows * S, 2H] scratch (a block owns 32
// context tokens and one slab of 128 kv columns); cross_attn takes the 32
// queries of one row (T > 32: two blocks per row), projects q_h per head
// from its x tile, reads k_h, v_h of its row from the scratch, runs the T x
// S attention and adds o_h @ Wo[hD:(h+1)D, :] into an f32 [32, H]
// accumulator in registers. It takes the weights input-major (Wq [H, H],
// Wkv [H, 2H], Wo [H, H]).
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"
#include "sublayer.cuh"

namespace {

using namespace stlt;
using bf16 = __nv_bfloat16;

constexpr int kKT = 16;      // f32: k-slice of x, Wq, Wkv staged per SIMT step
constexpr int kKTo = 8;      // f32: k-slice (rows) of Wo staged per SIMT step
constexpr int kSlab = 128;   // f32: kv columns of one kv_proj block

struct CrossArgs {
  const void* x;
  const void* ctx;
  const void* wq;
  const void* bq;
  const void* wkv;
  const void* bkv;
  const void* wo;
  const void* bo;
  const float* bias;
  long long bias_row_stride;
  long long bias_q_stride;
  void* kv;   // f32: the scratch [rows * S, 2H]; bf16: the scratch of launch_tc
  void* out;  // [rows, T, H], storage type
  int rows;
  int tq;  // T, queries of a row
  int skv; // S, keys of a row
  int hidden;
  int num_heads;
  float scale;
  int inner;  // Hq: the q/k/v width N D (H, or a model rank's H / M); bo null: the partial
};

// n (<= kTM) tokens from `src` (row stride H) into a [kTM][ld] tile, zeros
// past n.
template <typename E>
__device__ __forceinline__ void load_tokens(E* dst, int ld, const E* src, int n, int H) {
  copy_rows(dst, ld, src, H, n, kTM, H);
}

// k_h and v_h of row b (S keys) from the kv scratch (rounded to the storage
// type E) into [kTK][D] tiles of type KE.
template <int D, typename KE, typename E>
__device__ __forceinline__ void load_kv_head(KE* k_s, KE* v_s, const E* kv, int b, int h, int S,
                                             int H) {
  for (int idx = threadIdx.x; idx < S * D; idx += kThreads) {
    const int s = idx / D, d = idx % D;
    const E* row = kv + ((long long)b * S + s) * 2 * H + h * D + d;
    k_s[idx] = from_float<KE>(to_float(row[0]));
    v_s[idx] = from_float<KE>(to_float(row[H]));
  }
}

// o_s[i][d] (i < nq, row stride ld) = sum_s softmax(q_i . k_s * scale +
// bias[b, q0 + i, s]) v[s][d], the softmax normalised before the product;
// rows i >= nq are zeros. q_s holds f32 values (rounded to the storage type
// where the contract rounds), k_s and v_s type KE. p_s: [kTM][kTK] f32
// scratch; o_s the storage type E.
template <int D, typename KE, typename E>
__device__ __forceinline__ void head_attention(const CrossArgs& p, int b, int q0, int nq,
                                               const float* q_s, const KE* k_s, const KE* v_s,
                                               float* p_s, E* o_s, int ld) {
  const int tid = threadIdx.x, S = p.skv;
  for (int idx = tid; idx < nq * S; idx += kThreads) {
    const int i = idx / S, s = idx % S;
    const float* qi = q_s + i * D;
    const KE* ks = k_s + s * D;
    float dot = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) dot = fmaf(qi[d], to_float(ks[d]), dot);
    const float bias = p.bias[(long long)b * p.bias_row_stride +
                              (long long)(q0 + i) * p.bias_q_stride + s];
    p_s[i * kTK + s] = dot * p.scale + bias;
  }
  __syncthreads();
  if (tid < nq) {
    float* pr = p_s + tid * kTK;
    float m = pr[0];
    for (int s = 1; s < S; ++s) m = fmaxf(m, pr[s]);
    float sum = 0.f;
    for (int s = 0; s < S; ++s) {
      const float e = expf(pr[s] - m);
      pr[s] = e;
      sum += e;
    }
    for (int s = 0; s < S; ++s) pr[s] = pr[s] / sum;
  }
  __syncthreads();
  for (int idx = tid; idx < kTM * D; idx += kThreads) {
    const int i = idx / D, d = idx % D;
    float o = 0.f;
    if (i < nq) {
      const float* pr = p_s + i * kTK;
      for (int s = 0; s < S; ++s) o = fmaf(pr[s], to_float(v_s[s * D + d]), o);
    }
    o_s[i * ld + d] = from_float<E>(o);
  }
  __syncthreads();
}

// --- f32: SIMT ----------------------------------------------------------------

size_t kv_smem_bytes(int H) {
  return sizeof(float) * (size_t)(kTM * H + kKT * kSlab);
}

__global__ void __launch_bounds__(kThreads, 1) kv_proj_kernel(CrossArgs p) {
  const int H = p.hidden, Hq = p.inner;
  const float* __restrict__ ctx = static_cast<const float*>(p.ctx);
  const float* __restrict__ wkv = static_cast<const float*>(p.wkv);
  const float* __restrict__ bkv = static_cast<const float*>(p.bkv);
  float* __restrict__ kv = static_cast<float*>(p.kv);
  extern __shared__ float smem[];
  float* a_s = smem;            // [kTM][H] ctx tokens
  float* w_s = a_s + kTM * H;   // [kKT][kSlab] slice of Wkv
  const int tid = threadIdx.x, tx = tid & 63, ty = tid >> 6;
  const long long tok0 = (long long)blockIdx.x * kTM;
  const int n = (int)min((long long)kTM, (long long)p.rows * p.skv - tok0);
  const int col0 = blockIdx.y * kSlab;
  load_tokens(a_s, H, ctx + tok0 * H, n, H);
  float acc[kRM][2];
#pragma unroll
  for (int r = 0; r < kRM; ++r) acc[r][0] = acc[r][1] = 0.f;
  __syncthreads();
  for (int k0 = 0; k0 < H; k0 += kKT) {
    for (int i = tid; i < kKT * kSlab; i += kThreads) {
      w_s[i] = wkv[(long long)(k0 + i / kSlab) * 2 * Hq + col0 + i % kSlab];
    }
    __syncthreads();
    tile_fma<kRM, 2>(acc, a_s + k0, H, ty * kRM, w_s, kSlab, tx, kKT);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kRM; ++r) {
    const int i = ty * kRM + r;
    if (i >= n) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = col0 + tx + 64 * j;
      kv[(tok0 + i) * 2 * Hq + c] = acc[r][j] + bkv[c];
    }
  }
}

// f32 cross_attn: the weight slices take [kKT][64 kQJ] of Wq (zero columns
// past D) or [kKTo][H] of Wo.
template <int D>
__host__ __device__ int cross_w_elems(int H) {
  constexpr int wq = kKT * 64 * ((D + 63) / 64);
  return wq > kKTo * H ? wq : kKTo * H;
}

template <int D>
size_t cross_smem_bytes(int H) {
  const int w = cross_w_elems<D>(H);
  return sizeof(float) * (size_t)(kTM * kKT + w + 2 * kTM * D + 2 * kTK * D + kTM * kTK);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) cross_attn_kernel(CrossArgs p) {
  constexpr int kQJ = (D + 63) / 64;  // q columns of a thread, 64 apart
  const int H = p.hidden, nc = H / 64, Hq = p.inner;
  const int W = cross_w_elems<D>(H);
  const float* __restrict__ x = static_cast<const float*>(p.x);
  const float* __restrict__ wq = static_cast<const float*>(p.wq);
  const float* __restrict__ bq = static_cast<const float*>(p.bq);
  const float* __restrict__ wo = static_cast<const float*>(p.wo);
  const float* __restrict__ bo = static_cast<const float*>(p.bo);
  const float* __restrict__ kv = static_cast<const float*>(p.kv);
  float* __restrict__ out = static_cast<float*>(p.out);

  extern __shared__ float smem[];
  float* x_sl = smem;             // [kTM][kKT] slice of the x tile
  float* w_s = x_sl + kTM * kKT;  // [kKT][64 kQJ] slices of Wq, then [kKTo][H] of Wo
  float* q_s = w_s + W;           // [kTM][D]
  float* o_s = q_s + kTM * D;     // [kTM][D]
  float* k_s = o_s + kTM * D;     // [kTK][D]
  float* v_s = k_s + kTK * D;     // [kTK][D]
  float* p_s = v_s + kTK * D;     // [kTM][kTK]

  const int tid = threadIdx.x, tx = tid & 63, ty = tid >> 6;
  const int chunks = (p.tq + kTM - 1) / kTM;
  const int b = blockIdx.x / chunks, q0 = kTM * (blockIdx.x % chunks);
  const int nq = min(kTM, p.tq - q0);
  const long long tok0 = (long long)b * p.tq + q0;
  const float* xb = x + tok0 * H;
  float acc[kRM][kMaxNC];
#pragma unroll
  for (int r = 0; r < kRM; ++r)
#pragma unroll
    for (int j = 0; j < kMaxNC; ++j) acc[r][j] = 0.f;

  for (int h = 0; h < p.num_heads; ++h) {
    float pq[kRM][kQJ];
#pragma unroll
    for (int r = 0; r < kRM; ++r)
#pragma unroll
      for (int j = 0; j < kQJ; ++j) pq[r][j] = 0.f;
    for (int k0 = 0; k0 < H; k0 += kKT) {
      for (int i = tid; i < kTM * kKT; i += kThreads) {
        const int r = i / kKT;
        x_sl[i] = r < nq ? xb[(long long)r * H + k0 + i % kKT] : 0.f;
      }
      for (int i = tid; i < kKT * 64 * kQJ; i += kThreads) {
        const int kk = i / (64 * kQJ), c = i % (64 * kQJ);
        w_s[i] = c < D ? wq[(long long)(k0 + kk) * Hq + h * D + c] : 0.f;
      }
      __syncthreads();
      tile_fma<kRM, kQJ>(pq, x_sl, kKT, ty * kRM, w_s, 64 * kQJ, tx, kKT);
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kQJ; ++j) {
      const int d = tx + 64 * j;
      if (d >= D) continue;
#pragma unroll
      for (int r = 0; r < kRM; ++r) q_s[(ty * kRM + r) * D + d] = pq[r][j] + bq[h * D + d];
    }
    load_kv_head<D>(k_s, v_s, kv, b, h, p.skv, Hq);
    __syncthreads();
    head_attention<D>(p, b, q0, nq, q_s, k_s, v_s, p_s, o_s, D);

    // acc += o_h @ Wo[h*D:(h+1)*D, :]
    for (int k0 = 0; k0 < D; k0 += kKTo) {
      for (int i = tid; i < kKTo * H; i += kThreads) w_s[i] = wo[(long long)(h * D + k0) * H + i];
      __syncthreads();
      tile_fma<kRM, kMaxNC>(acc, o_s + k0, D, ty * kRM, w_s, H, tx, kKTo, nc);
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < kRM; ++r) {
    const int i = ty * kRM + r;
    if (i >= nq) continue;
#pragma unroll
    for (int j = 0; j < kMaxNC; ++j) {
      const int c = tx + 64 * j;
      if (j < nc) out[(tok0 + i) * H + c] = acc[r][j] + (bo ? bo[c] : 0.f);
    }
  }
}

// --- bf16: wgmma on TMA-fed tiles, split at the rounding points ----------------

using namespace stlt::sublayer;

__global__ void __launch_bounds__(kGemmThreads, 2)
    cross_gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                      GemmArgs p) {
  gemm_body(map_a, map_b, p);
}

template <int D>
__global__ void __launch_bounds__(kAttnThreads) cross_short_attn_kernel(AttnArgs p) {
  attn_body<D, false>(p);
}

template <typename T>
__global__ void __launch_bounds__(kSumThreads)
    cross_sum_kernel(const float* s, const T* bo, const uint8_t* rows_live, T* out, long long n, int seq, int H) {
  sum_bias_body(s, bo, rows_live, out, n, seq, H);
}

bool gemm_attribute_set = false;

template <int D>
int launch_cross_attn(AttnArgs a, cudaStream_t stream) {
  static bool attribute_set = false;
  a.hb = attn_heads<D>(a.T, a.S, a.N);
  return launch_attn<D>(cross_short_attn_kernel<D>, attribute_set, a, stream);
}

// The bf16 sublayer. p.kv is the scratch (16-byte aligned): q [rows * T, Hq],
// kv [rows * S, 2Hq], o [rows * T, Hq], bf16. Hq = H but in the partial mode
// (p.bo null), whose out GEMM writes the f32 partial into p.out.
int launch_tc(const CrossArgs& p, int head_dim, cudaStream_t stream) {
  const long long Mq = (long long)p.rows * p.tq, Mk = (long long)p.rows * p.skv;
  if (p.rows == 0) return 0;
  if (p.kv == nullptr || Mq > 0x7fffffffLL || Mk > 0x7fffffffLL) return -1;
  const int H = p.hidden, Hq = p.inner;
  bf16* q = static_cast<bf16*>(p.kv);
  bf16* kv = q + Mq * Hq;
  bf16* o = kv + Mk * 2 * Hq;
  CUtensorMap map_x, map_wq, map_ctx, map_wkv, map_o, map_wo;
  int err = hopper::make_map(&map_x, p.x, Mq, H, kBM);
  if (!err) err = hopper::make_map(&map_wq, p.wq, Hq, H, kBN);  // each weight [N, K]: K-major B
  if (!err) err = hopper::make_map(&map_ctx, p.ctx, Mk, H, kBM);
  if (!err) err = hopper::make_map(&map_wkv, p.wkv, 2 * Hq, H, kBN);
  if (!err) err = hopper::make_map(&map_o, o, Mq, Hq, kBM);
  if (!err) err = hopper::make_map(&map_wo, p.wo, H, Hq, kBN);
  if (err) return err;
  const GemmArgs gq{(int)Mq, Hq, H, static_cast<const bf16*>(p.bq), q, nullptr, nullptr, 1, 0, nullptr};
  if ((err = launch_gemm(cross_gemm_kernel, gemm_attribute_set, map_x, map_wq, gq, stream))) return err;
  const GemmArgs gkv{(int)Mk, 2 * Hq, H, static_cast<const bf16*>(p.bkv), kv, nullptr, nullptr, 1, 0, nullptr};
  if ((err = launch_gemm(cross_gemm_kernel, gemm_attribute_set, map_ctx, map_wkv, gkv, stream))) return err;
  const AttnArgs a{q, kv, kv + Hq, (long long)Hq, 2LL * Hq, o, p.bias, p.bias_row_stride, p.bias_q_stride,
                   nullptr, nullptr, nullptr, p.rows, p.tq, p.skv, Hq, p.num_heads, 1, p.scale,
                   RowDropout{}};
  switch (head_dim) {
    case 32: err = launch_cross_attn<32>(a, stream); break;
    case 64: err = launch_cross_attn<64>(a, stream); break;
    case 128: err = launch_cross_attn<128>(a, stream); break;
    default: err = -1;
  }
  if (err) return err;
  // An out GEMM: each row to its own token.
  const GemmArgs go = p.bo == nullptr
      ? GemmArgs{(int)Mq, H, Hq, nullptr, nullptr, nullptr, nullptr, 1, 1, static_cast<float*>(p.out)}
      : GemmArgs{(int)Mq, H, H, static_cast<const bf16*>(p.bo), static_cast<bf16*>(p.out), nullptr,
                 nullptr, 1, 1, nullptr};
  return launch_gemm(cross_gemm_kernel, gemm_attribute_set, map_o, map_wo, go, stream);
}

// --- f32 launch -----------------------------------------------------------------

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D>
int launch(const CrossArgs& a, cudaStream_t stream) {
  const size_t kv_smem = kv_smem_bytes(a.hidden), attn_smem = cross_smem_bytes<D>(a.hidden);
  if (kv_smem > kMaxSmem || attn_smem > kMaxSmem) return -1;
  cudaError_t err = set_smem(kv_proj_kernel, kv_smem);
  if (err == cudaSuccess) err = set_smem(cross_attn_kernel<D>, attn_smem);
  if (err != cudaSuccess) return (int)err;
  const long long kv_tiles = ((long long)a.rows * a.skv + kTM - 1) / kTM;
  const long long attn_blocks = (long long)a.rows * ((a.tq + kTM - 1) / kTM);
  if (kv_tiles > 0x7fffffffLL || attn_blocks > 0x7fffffffLL) return -1;
  if (a.rows > 0) {
    kv_proj_kernel<<<dim3((unsigned)kv_tiles, 2 * a.inner / kSlab), kThreads, kv_smem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cross_attn_kernel<D><<<(unsigned)attn_blocks, kThreads, attn_smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

int dispatch_f32(int head_dim, const CrossArgs& a, cudaStream_t s) {
  switch (head_dim) {
    case 32: return launch<32>(a, s);
    case 64: return launch<64>(a, s);
    case 128: return launch<128>(a, s);
    default: return -1;
  }
}

}  // namespace

// Returns 0, a cudaError_t from a launch, -1 for a shape the kernels do not
// take (H not a multiple of 64 up to 1024, H / num_heads not in {32, 64,
// 128}, T or S outside 1..64), -2 for an unknown dtype code (0 = float32,
// 1 = bfloat16) or -3 if a TMA map cannot be encoded. f32 takes wq [H, H],
// wkv [H, 2H] and wo [H, H] input-major and kv, a [rows * S, 2H] f32
// scratch; bf16 takes them as the model stores them (wq [H, H], wkv [2H, H],
// wo [H, H] output-major, 16-byte aligned), x and ctx 16-byte aligned, and
// in kv a scratch of (2 rows T H + 2 rows S H) bf16 (launch_tc).
extern "C" int stlt_fused_cross_attention(
    const void* x, const void* ctx, const void* wq, const void* bq, const void* wkv,
    const void* bkv, const void* wo, const void* bo, const void* bias,
    long long bias_row_stride, long long bias_q_stride, void* kv, void* out, int rows, int tq,
    int skv, int hidden, int num_heads, float scale, int dtype, void* stream) {
  if (hidden % 64 != 0 || hidden < 64 || hidden > 64 * kMaxNC || num_heads < 1 ||
      hidden % num_heads != 0 || tq < 1 || tq > kTK || skv < 1 || skv > kTK || rows < 0) {
    return -1;
  }
  CrossArgs a{x, ctx, wq, bq, wkv, bkv, wo, bo, static_cast<const float*>(bias), bias_row_stride,
              bias_q_stride, kv, out, rows, tq, skv, hidden, num_heads, scale, hidden};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_f32(hidden / num_heads, a, s);
  if (dtype == 1) return launch_tc(a, hidden / num_heads, s);
  return -2;
}

// The model axis's partial mode: a model rank's num_heads heads of inner
// width Hq = `inner` (a multiple of 64): wq [H, Hq], wkv [H, 2Hq], wo [Hq, H]
// input-major in f32, as stored ([Hq, H], [2Hq, H], [H, Hq]) in bf16; the
// f32 partial [rows * T, hidden] into `out`; kv the scratch of the full mode
// at width Hq. Returns as stlt_fused_cross_attention.
extern "C" int stlt_fused_cross_attention_partial(
    const void* x, const void* ctx, const void* wq, const void* bq, const void* wkv, const void* bkv,
    const void* wo, const void* bias, long long bias_row_stride, long long bias_q_stride, void* kv,
    void* out, int rows, int tq, int skv, int hidden, int inner, int num_heads, float scale, int dtype,
    void* stream) {
  if (hidden % 64 != 0 || hidden < 64 || hidden > 64 * kMaxNC || inner % 64 != 0 || inner < 64 ||
      inner > hidden || num_heads < 1 || inner % num_heads != 0 || tq < 1 || tq > kTK || skv < 1 ||
      skv > kTK || rows < 0) {
    return -1;
  }
  CrossArgs a{x, ctx, wq, bq, wkv, bkv, wo, nullptr, static_cast<const float*>(bias), bias_row_stride,
              bias_q_stride, kv, out, rows, tq, skv, hidden, num_heads, scale, inner};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_f32(inner / num_heads, a, s);
  if (dtype == 1) return launch_tc(a, inner / num_heads, s);
  return -2;
}

// The sum epilogue: out = round(s + bo) [rows * seq, hidden] from the summed
// f32 partials s (rows_live null here: the cross-attention has no dead rows).
extern "C" int stlt_fused_cross_attention_sum(const void* s, const void* bo, const void* rows_live, void* out,
                                              int rows, int seq, int hidden, int dtype, void* stream) {
  return launch_sum(cross_sum_kernel<float>, cross_sum_kernel<bf16>, s, bo, rows_live, out, rows, seq, hidden,
                    dtype, static_cast<cudaStream_t>(stream));
}
