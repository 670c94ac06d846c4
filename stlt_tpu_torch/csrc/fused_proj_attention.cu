// Self-attention sublayer: for each row of x [rows, T, H],
//
//   qkv = x @ Wqkv + bqkv                      (rounded to the compute dtype)
//   o_h = softmax(q_h k_h^T / sqrt(D) + bias) v_h     (f32 logits and softmax)
//   y   = concat_h(o_h) @ Wo + bo              (o_h rounded before the product)
//
// Replaces the TPU kernel stlt_tpu/ops/fused_encoder.py::_fused_proj_attn_kernel,
// both as launched by fused_proj_attention (eval) and by _fused_proj_train_fwd
// (train, with `prng`): with dropout on, each probability is multiplied by
// keep * 1/(1-rate) before the product with v, the keep bit hashed in place
// from (seed, global row, head, t, s) exactly as _keep_block does, so the
// backward kernel (fused_proj_attention_bwd.cu) and the plain version
// regenerate the same bits. The numerics follow the TPU kernel's contract;
// its TPU blocking (T padded to 8, whole-grid-resident weights) does not
// carry over. Rows whose rows_live flag is 0 write exact zeros. The bias is
// read per row as [T, T] or broadcast [1, T] through its strides, never
// materialised.
//
// bf16 (launch_tc): split at the contract's rounding points onto Hopper's
// tensor cores (sublayer.cuh). With rows_live a scan packs the live rows in
// order (the dead ones after them) and a gather copies their tokens into a
// dense bf16 A; the QKV GEMM writes round(x Wqkv + bqkv) [tokens, 3H] into
// the scratch; the short-attention kernel writes each (row, head)'s rounded
// output [tokens, H] over the packed x, and zeros every dead row's output;
// the out GEMM writes round(o Wo + bo) at the tokens' own rows. Five launches
// with rows_live, three without. The weights come in the model's storage
// (in_proj_weight [3H, H], out_proj.weight [H, H], both [N, K]) and are read
// where they lie, each once per 128-token tile. Bound on this card: two GEMMs
// of 2*tokens*H*4H flops against ~2 x 2*tokens*H bytes of activations, far
// above the H100's ~295 flop/byte ridge, so the tensor cores bound it; the
// split adds the bf16 round trips of qkv and o (and of the packed x).
//
// The model axis (--model_parallel M, stlt_fused_proj_attention_partial): a
// model rank's N / M heads, inner width Hq = H / M. Both routes stop before
// the row-parallel sum and write the f32 partial o_m Wo_m [tokens, H] with
// no bias (dead rows: f32 zeros; bf16 leaves them to the caller's zeroed
// buffer); bf16's QKV GEMM writes [tokens, 3Hq] over the whole K = H, its
// out GEMM runs K = Hq (sublayer.cuh's out32). The model ranks sum the
// partials in f32, then a small row kernel (proj_sum_kernel,
// stlt_fused_proj_attention_sum) writes round(s + bo), dead rows exact
// zeros: the epilogue is a kernel of its own, not folded into the tail's
// LN1, so the sublayer's output keeps its one rounding point. In training
// (row 3's partial mode) the same launch drops the probabilities of its
// heads, each hashed as its global head m N / M + n among the N, so M ranks
// drop the one process's bits (fused_proj_attention_bwd.cu takes the
// backward).
//
// f32: one kernel on the SIMT pipes, so f32 stays true f32. For T <= 32 one
// block owns floor(32 / T) rows; for 32 < T <= 64 a block owns the 32
// queries of one half of one row and all T keys of that row. Per head the
// block projects that head's q/k/v ([tokens, D] each) from x, runs the
// attention on chip and adds o_h @ Wo[hD:(h+1)D, :] into an f32 [32, H]
// accumulator in registers: the same sum as concat-then-project, in another
// order. A block with no live row skips all compute. It takes the weights
// input-major (Wqkv [H, 3H], Wo [H, H]).
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"
#include "sublayer.cuh"

namespace {

using namespace stlt;
using bf16 = __nv_bfloat16;

constexpr int kKT = 16;   // f32: k-slice of x and Wqkv staged per SIMT step
constexpr int kKTo = 8;   // f32: k-slice (rows) of Wo staged per SIMT step

struct ProjArgs {
  const void* x;
  const void* wqkv;
  const void* bqkv;
  const void* wo;
  const void* bo;
  const float* bias;
  long long bias_row_stride;
  long long bias_q_stride;
  const uint8_t* rows_live;
  void* out;
  int rows;
  int seq;
  int hidden;
  int num_heads;
  int rows_per_block;  // T <= 32: rows of one block; T > 32: 1
  float scale;
  RowDropout drop;
  int inner;  // Hq: the q/k/v width N D (H, or a model rank's H / M); bo null: the partial
};

// T > 32: kKeyChunks blocks (query halves) per row, each projecting the
// row's keys in kKeyChunks chunks of kTM tokens.
constexpr int kKeyChunks = kTK / kTM;

// The tokens one block works on. Its key tile holds nkv tokens (nrows whole
// rows) from token tok0; its queries are the nq tokens from q0 of that tile.
struct Tile {
  int row0, nrows, nkv, q0, nq;
  long long tok0;
};

template <bool kChunked>
__device__ __forceinline__ Tile block_tile(const ProjArgs& p) {
  Tile t;
  if (!kChunked) {
    t.row0 = blockIdx.x * p.rows_per_block;
    t.nrows = min(p.rows_per_block, p.rows - t.row0);
    t.nkv = t.nrows * p.seq;
    t.q0 = 0;
    t.nq = t.nkv;
  } else {
    t.row0 = blockIdx.x / kKeyChunks;
    t.nrows = 1;
    t.nkv = p.seq;
    t.q0 = kTM * (blockIdx.x % kKeyChunks);
    t.nq = min(kTM, p.seq - t.q0);
  }
  t.tok0 = (long long)t.row0 * p.seq;
  return t;
}

// Softmax probabilities of head h for the block's nq queries, into
// p_s [kTM][kTK]: f32 logits q.k * scale + bias over the keys of each
// query's own row, max-subtracted exp, normalised, then (kDrop) dropped.
// q_s [kTM][D] and k_s [kTK][D] hold f32 (f32 kernel) or bf16 values.
template <int D, bool kDrop, typename QE>
__device__ __forceinline__ void head_probs(const ProjArgs& p, const Tile& tl, int h,
                                           const QE* q_s, const QE* k_s, float* p_s) {
  const int tid = threadIdx.x, seq = p.seq;
  for (int idx = tid; idx < tl.nq * seq; idx += kThreads) {
    const int i = idx / seq, s = idx % seq;
    const int tok = tl.q0 + i, lr = tok / seq, t = tok % seq;
    const QE* qi = q_s + i * D;
    const QE* ks = k_s + (lr * seq + s) * D;
    float dot = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) dot = fmaf(to_float(qi[d]), to_float(ks[d]), dot);
    const float b = p.bias[(long long)(tl.row0 + lr) * p.bias_row_stride +
                           (long long)t * p.bias_q_stride + s];
    p_s[i * kTK + s] = dot * p.scale + b;
  }
  __syncthreads();
  if (tid < tl.nq) {
    const int tok = tl.q0 + tid, lr = tok / seq, t = tok % seq;
    float* pr = p_s + tid * kTK;
    float m = pr[0];
    for (int s = 1; s < seq; ++s) m = fmaxf(m, pr[s]);
    float sum = 0.f;
    for (int s = 0; s < seq; ++s) {
      const float e = expf(pr[s] - m);
      pr[s] = e;
      sum += e;
    }
    for (int s = 0; s < seq; ++s) pr[s] = pr[s] / sum;
    if (kDrop) {
      const uint32_t dl = p.drop.row_lane(tl.row0 + lr, h);
      for (int s = 0; s < seq; ++s) pr[s] *= p.drop.keep_at(dl, t, s, seq);
    }
  }
  __syncthreads();
}

// Attention output o[i][d] of query i (< nq): probabilities times the
// values of its row.
template <int D, typename QE>
__device__ __forceinline__ float head_out(const float* p_s, const QE* v_s, const Tile& tl, int i,
                                          int d, int seq) {
  const float* pr = p_s + i * kTK;
  const QE* vs = v_s + ((tl.q0 + i) / seq) * seq * D + d;
  float o = 0.f;
  for (int s = 0; s < seq; ++s) o = fmaf(pr[s], to_float(vs[s * D]), o);
  return o;
}

// --- f32: SIMT ----------------------------------------------------------------

template <int D>
size_t proj_smem_bytes(int H) {
  const int w = kKT * 3 * D > kKTo * H ? kKT * 3 * D : kKTo * H;
  return sizeof(float) * (size_t)(kTM * kKT + w + 2 * kTM * D + 2 * kTK * D + kTM * kTK);
}

// kChunked: T > 32 (a block takes one query half of one row); kDrop: the
// train forward's probability dropout. Both are template flags so that the
// eval kernel at T <= 32 carries neither's registers.
template <int D, bool kChunked, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1) fused_proj_attn_kernel(ProjArgs p) {
  constexpr int kQJ = (3 * D + 63) / 64;  // q/k/v columns of a thread, 64 apart
  const int H = p.hidden, nc = H / 64, Hq = p.inner;
  const int W = kKT * 3 * D > kKTo * H ? kKT * 3 * D : kKTo * H;
  const float* __restrict__ x = static_cast<const float*>(p.x);
  const float* __restrict__ wqkv = static_cast<const float*>(p.wqkv);
  const float* __restrict__ bqkv = static_cast<const float*>(p.bqkv);
  const float* __restrict__ wo = static_cast<const float*>(p.wo);
  const float* __restrict__ bo = static_cast<const float*>(p.bo);
  float* __restrict__ out = static_cast<float*>(p.out);

  extern __shared__ float smem[];
  float* x_sl = smem;              // [kTM][kKT] slice of the x chunk
  float* w_s = x_sl + kTM * kKT;   // [kKT][3 * D] slices of Wqkv, then
  float* wo_s = w_s;               // [kKTo][H] slices of Wo
  float* q_s = w_s + W;            // [kTM][D]
  float* o_s = q_s + kTM * D;      // [kTM][D]
  float* k_s = o_s + kTM * D;      // [kTK][D]
  float* v_s = k_s + kTK * D;      // [kTK][D]
  float* p_s = v_s + kTK * D;      // [kTM][kTK] logits, then probabilities

  const int tid = threadIdx.x, tx = tid & 63, ty = tid >> 6;
  const int seq = p.seq;
  const Tile tl = block_tile<kChunked>(p);
  constexpr int nchunks = kChunked ? kKeyChunks : 1;
  const int qchunk = kChunked ? tl.q0 / kTM : 0;
  if (!block_has_live(p.rows_live, tl.row0, tl.nrows)) {
    for (int i = tid; i < tl.nq * H; i += kThreads) out[(tl.tok0 + tl.q0) * H + i] = 0.f;
    return;
  }

  float acc[kRM][kMaxNC];
#pragma unroll
  for (int r = 0; r < kRM; ++r)
#pragma unroll
    for (int j = 0; j < kMaxNC; ++j) acc[r][j] = 0.f;

  for (int h = 0; h < p.num_heads; ++h) {
#pragma unroll 1
    for (int c = 0; c < nchunks; ++c) {
      const int ntok = min(kTM, tl.nkv - kTM * c);
      const float* xc = x + (tl.tok0 + kTM * c) * H;
      // q/k/v of head h: thread column tx + 64 j of the head's [3 D] columns.
      float pq[kRM][kQJ];
#pragma unroll
      for (int r = 0; r < kRM; ++r)
#pragma unroll
        for (int j = 0; j < kQJ; ++j) pq[r][j] = 0.f;
      for (int k0 = 0; k0 < H; k0 += kKT) {
        for (int i = tid; i < kTM * kKT; i += kThreads) {
          const int r = i / kKT;
          x_sl[i] = r < ntok ? xc[(long long)r * H + k0 + i % kKT] : 0.f;
        }
        for (int i = tid; i < kKT * 3 * D; i += kThreads) {
          const int kk = i / (3 * D), cc = i % (3 * D);
          w_s[i] = wqkv[(long long)(k0 + kk) * 3 * Hq + (cc / D) * Hq + h * D + cc % D];
        }
        __syncthreads();
        // Columns past 3 D (D = 32) read the next slice row and are dropped.
        tile_fma<kRM, kQJ>(pq, x_sl, kKT, ty * kRM, w_s, 3 * D, tx, kKT);
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < kQJ; ++j) {
        const int cc = tx + 64 * j, part = cc / D, d = cc % D;
        if (cc >= 3 * D || (part == 0 && c != qchunk)) continue;
        float* dst = part == 0 ? q_s : (part == 1 ? k_s + c * kTM * D : v_s + c * kTM * D);
        const float b = bqkv[part * Hq + h * D + d];
#pragma unroll
        for (int r = 0; r < kRM; ++r) dst[(ty * kRM + r) * D + d] = pq[r][j] + b;
      }
    }
    __syncthreads();
    head_probs<D, kDrop>(p, tl, h, q_s, k_s, p_s);
    for (int idx = tid; idx < kTM * D; idx += kThreads) {
      const int i = idx / D, d = idx % D;
      o_s[idx] = i < tl.nq ? head_out<D>(p_s, v_s, tl, i, d, seq) : 0.f;
    }
    __syncthreads();

    // acc += o_h @ Wo[h*D:(h+1)*D, :]
    for (int k0 = 0; k0 < D; k0 += kKTo) {
      for (int i = tid; i < kKTo * H; i += kThreads) {
        wo_s[i] = wo[(long long)(h * D + k0) * H + i];
      }
      __syncthreads();
      tile_fma<kRM, kMaxNC>(acc, o_s + k0, D, ty * kRM, wo_s, H, tx, kKTo, nc);
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < kRM; ++r) {
    const int i = ty * kRM + r;
    if (i >= tl.nq) continue;
    const bool live = p.rows_live == nullptr || p.rows_live[tl.row0 + (tl.q0 + i) / seq];
#pragma unroll
    for (int j = 0; j < kMaxNC; ++j) {
      const int c = tx + 64 * j;
      if (j < nc) out[(tl.tok0 + tl.q0 + i) * H + c] = live ? acc[r][j] + (bo ? bo[c] : 0.f) : 0.f;
    }
  }
}

// --- bf16: wgmma on TMA-fed tiles, split at the rounding points ----------------

using namespace stlt::sublayer;

__global__ void __launch_bounds__(kScanThreads) proj_live_rows_kernel(const uint8_t* live, int rows,
                                                                      int* packed, int* count) {
  tail::live_rows_scan<true>(live, rows, packed, count);
}

__global__ void __launch_bounds__(32 * kRowWarps)
    proj_gather_kernel(const bf16* x, bf16* xp, const int* rows, const int* count, int seq, int H) {
  gather_body(x, xp, rows, count, seq, H);
}

__global__ void __launch_bounds__(kGemmThreads, 2)
    proj_gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                     GemmArgs p) {
  gemm_body(map_a, map_b, p);
}

template <int D, bool kDrop>
__global__ void __launch_bounds__(kAttnThreads) proj_attn_kernel(AttnArgs p) {
  attn_body<D, kDrop>(p);
}

template <typename T>
__global__ void __launch_bounds__(kSumThreads)
    proj_sum_kernel(const float* s, const T* bo, const uint8_t* rows_live, T* out, long long n, int seq, int H) {
  sum_bias_body(s, bo, rows_live, out, n, seq, H);
}

bool gemm_attribute_set = false;

template <int D>
int launch_proj_attn(AttnArgs a, cudaStream_t stream) {
  static bool attribute_set[2] = {false, false};  // without, with dropout
  a.hb = attn_heads<D>(a.T, a.S, a.N);
  return a.drop.on ? launch_attn<D>(proj_attn_kernel<D, true>, attribute_set[1], a, stream)
                   : launch_attn<D>(proj_attn_kernel<D, false>, attribute_set[0], a, stream);
}

// The bf16 sublayer. `scratch` (16-byte aligned) holds qkv [rows * T, 3Hq]
// and the packed x [rows * T, H], overwritten by o [rows * T, Hq], in bf16,
// then (with rows_live) the packed rows [rows] (live in order, then dead)
// and their live count (int32). Hq = H but in the partial mode (p.bo null),
// whose out GEMM writes the f32 partial into p.out.
int launch_tc(const ProjArgs& p, int head_dim, void* scratch, cudaStream_t stream) {
  const long long M = (long long)p.rows * p.seq;
  if (M == 0) return 0;
  if (scratch == nullptr || M > 0x7fffffffLL) return -1;
  const int H = p.hidden, Hq = p.inner;
  const bool partial = p.bo == nullptr;
  bf16* qkv = static_cast<bf16*>(scratch);
  bf16* xo = qkv + M * 3 * Hq;
  int* rows = reinterpret_cast<int*>(xo + M * H);
  int* count = rows + p.rows;
  const bool packed = p.rows_live != nullptr;
  if (!packed) rows = count = nullptr;  // every row live: packed row b is row b
  CUtensorMap map_x, map_wqkv, map_o, map_wo;
  int err = hopper::make_map(&map_x, packed ? xo : p.x, M, H, kBM);
  if (!err) err = hopper::make_map(&map_wqkv, p.wqkv, 3 * Hq, H, kBN);  // [3Hq, H]: K-major B
  if (!err) err = hopper::make_map(&map_o, xo, M, Hq, kBM);
  if (!err) err = hopper::make_map(&map_wo, p.wo, H, Hq, kBN);  // [H, Hq]: K-major B
  if (err) return err;
  if (packed) {
    proj_live_rows_kernel<<<1, kScanThreads, 0, stream>>>(p.rows_live, p.rows, rows, count);
    proj_gather_kernel<<<(unsigned)((M + kRowWarps - 1) / kRowWarps), 32 * kRowWarps, 0, stream>>>(
        static_cast<const bf16*>(p.x), xo, rows, count, p.seq, H);
    if ((err = (int)cudaGetLastError())) return err;
  }
  const GemmArgs g1{(int)M, 3 * Hq, H, static_cast<const bf16*>(p.bqkv), qkv, rows, count, p.seq, 0};
  if ((err = launch_gemm(proj_gemm_kernel, gemm_attribute_set, map_x, map_wqkv, g1, stream))) return err;
  const AttnArgs a{qkv, qkv + Hq, qkv + 2 * Hq, 3LL * Hq, 3LL * Hq, xo, p.bias, p.bias_row_stride,
                   p.bias_q_stride, rows, count, partial ? nullptr : static_cast<bf16*>(p.out), p.rows,
                   p.seq, p.seq, Hq, p.num_heads, 1, p.scale, p.drop};
  switch (head_dim) {
    case 32: err = launch_proj_attn<32>(a, stream); break;
    case 64: err = launch_proj_attn<64>(a, stream); break;
    case 128: err = launch_proj_attn<128>(a, stream); break;
    default: err = -1;
  }
  if (err) return err;
  const GemmArgs g2 = partial
      ? GemmArgs{(int)M, H, Hq, nullptr, nullptr, rows, count, p.seq, 1, static_cast<float*>(p.out)}
      : GemmArgs{(int)M, H, H, static_cast<const bf16*>(p.bo), static_cast<bf16*>(p.out), rows, count,
                 p.seq, 1, nullptr};
  return launch_gemm(proj_gemm_kernel, gemm_attribute_set, map_o, map_wo, g2, stream);
}

// --- f32 launch -----------------------------------------------------------------

template <int D, bool kChunked, bool kDrop>
int launch(const ProjArgs& a, cudaStream_t stream) {
  auto kernel = fused_proj_attn_kernel<D, kChunked, kDrop>;
  const size_t smem = proj_smem_bytes<D>(a.hidden);
  if (smem > kMaxSmem) return -1;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = kChunked ? a.rows * kKeyChunks
                            : (a.rows + a.rows_per_block - 1) / a.rows_per_block;
  if (grid > 0) kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_flags(const ProjArgs& a, cudaStream_t s) {
  const bool chunked = a.seq > kTM, drop = a.drop.on;
  if (chunked) return drop ? launch<D, true, true>(a, s) : launch<D, true, false>(a, s);
  return drop ? launch<D, false, true>(a, s) : launch<D, false, false>(a, s);
}

int dispatch_f32(int head_dim, const ProjArgs& a, cudaStream_t s) {
  switch (head_dim) {
    case 32: return launch_flags<32>(a, s);
    case 64: return launch_flags<64>(a, s);
    case 128: return launch_flags<128>(a, s);
    default: return -1;
  }
}

}  // namespace

// Returns 0, a cudaError_t from a launch, -1 for a shape the kernels do not
// take (H not a multiple of 64 up to 1024, H / num_heads not in {32, 64,
// 128}, T > 64, no scratch in bf16), -2 for an unknown dtype code (0 =
// float32, 1 = bfloat16) or -3 if a TMA map cannot be encoded. dropout = 0
// is the eval function; otherwise probabilities are dropped with (seed,
// thresh) at the global rows of the map (row_base, row_period,
// row_stride, row_magic: common.cuh RowMap) and kept ones scaled by
// dropout_scale. f32 takes wqkv [H, 3H] and
// wo [H, H] input-major and no scratch; bf16 takes them as the model stores
// them (wqkv [3H, H], wo [H, H] output-major, 16-byte aligned), x and the
// rows_live bytes 16-byte aligned, and a scratch of (4 H bf16) per token and
// (rows + 1) int32 (launch_tc).
extern "C" int stlt_fused_proj_attention(
    const void* x, const void* wqkv, const void* bqkv, const void* wo, const void* bo,
    const void* bias, long long bias_row_stride, long long bias_q_stride,
    const void* rows_live, void* out, void* scratch, int rows, int seq, int hidden, int num_heads,
    float scale, int dropout, unsigned int seed, unsigned int thresh, float dropout_scale,
    unsigned int row_base, unsigned int row_period, unsigned int row_stride, unsigned int row_magic,
    int dtype, void* stream) {
  if (hidden % 64 != 0 || hidden < 64 || hidden > 64 * kMaxNC || num_heads < 1 ||
      hidden % num_heads != 0 || seq < 1 || seq > kTK || rows < 0) {
    return -1;
  }
  ProjArgs a{x, wqkv, bqkv, wo, bo, static_cast<const float*>(bias), bias_row_stride,
             bias_q_stride, static_cast<const uint8_t*>(rows_live), out, rows, seq, hidden,
             num_heads, seq > kTM ? 1 : kTM / seq, scale,
             RowDropout{dropout, seed, thresh, dropout_scale,
                        RowMap{row_base, row_period, row_stride, row_magic}, 0u,
                        static_cast<uint32_t>(num_heads)},
             hidden};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_f32(hidden / num_heads, a, s);
  if (dtype == 1) return launch_tc(a, hidden / num_heads, scratch, s);
  return -2;
}

// The model axis's partial mode, eval or train: a model rank's num_heads
// heads of inner width Hq = `inner` (a multiple of 64; wqkv [H, 3Hq]
// input-major in f32, [3Hq, H] as stored in bf16; wo [Hq, H] input-major in
// f32, [H, Hq] as stored in bf16), writing the f32 partial [rows * seq,
// hidden] into `out` (bf16: dead rows unwritten). dropout = 0 is the eval
// function; otherwise the probabilities are dropped as
// stlt_fused_proj_attention drops them, the rank's heads hashed as the
// global heads head0, ..., head0 + num_heads - 1 of `heads` (common.cuh
// RowDropout). bf16's scratch: (3Hq + H) bf16 a token and (rows + 1)
// int32. Returns as stlt_fused_proj_attention.
extern "C" int stlt_fused_proj_attention_partial(
    const void* x, const void* wqkv, const void* bqkv, const void* wo, const void* bias,
    long long bias_row_stride, long long bias_q_stride, const void* rows_live, void* out, void* scratch,
    int rows, int seq, int hidden, int inner, int num_heads, float scale, int dropout, unsigned int seed,
    unsigned int thresh, float dropout_scale, unsigned int row_base, unsigned int row_period,
    unsigned int row_stride, unsigned int row_magic, unsigned int head0, unsigned int heads, int dtype,
    void* stream) {
  if (hidden % 64 != 0 || hidden < 64 || hidden > 64 * kMaxNC || inner % 64 != 0 || inner < 64 ||
      inner > hidden || num_heads < 1 || inner % num_heads != 0 || seq < 1 || seq > kTK || rows < 0 ||
      head0 + num_heads > heads) {
    return -1;
  }
  ProjArgs a{x, wqkv, bqkv, wo, nullptr, static_cast<const float*>(bias), bias_row_stride,
             bias_q_stride, static_cast<const uint8_t*>(rows_live), out, rows, seq, hidden,
             num_heads, seq > kTM ? 1 : kTM / seq, scale,
             RowDropout{dropout, seed, thresh, dropout_scale,
                        RowMap{row_base, row_period, row_stride, row_magic}, head0, heads},
             inner};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_f32(inner / num_heads, a, s);
  if (dtype == 1) return launch_tc(a, inner / num_heads, scratch, s);
  return -2;
}

// The sum epilogue: out = round(s + bo) [rows * seq, hidden] in the dtype's
// type from the summed f32 partials s; rows whose rows_live flag is 0 (when
// given) write zeros.
extern "C" int stlt_fused_proj_attention_sum(const void* s, const void* bo, const void* rows_live, void* out,
                                             int rows, int seq, int hidden, int dtype, void* stream) {
  return launch_sum(proj_sum_kernel<float>, proj_sum_kernel<bf16>, s, bo, rows_live, out, rows, seq, hidden,
                    dtype, static_cast<cudaStream_t>(stream));
}
