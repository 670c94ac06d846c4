// The blockwise attention kernel of the long-clip path, for 513 tokens and
// up, head dim 32, 64 or 128. Writes out [B, T, N, D] and lse [B, N, T] =
// m + log(l). Two modes:
//
// - lengths (lengths != nullptr): key s of clip b is live iff s < lengths[b]
//   (and s <= t when causal), the mask made in the kernel, so no
//   [B, 1, T, S] bias exists; query rows t >= lengths[b] are zeros with
//   lse 0. With ring offsets (row0, col0), one step of the ring: local
//   query t and key s are global rows row0 + t and col0 + s, the mask and
//   the dead rows are taken at those (attention_core.cuh); a live row with
//   no live key in the held chunk is zeros with lse -1e30;
// - dense bias (lengths == nullptr): an f32 bias broadcastable to
//   [B, N, T, S] read through its (b, n, t) strides (stride 0 for a
//   broadcast dim); with `causal` (the bias declared causal) key chunks above
//   the last query's diagonal are skipped; every query row is computed. T and
//   S may differ (the fusion models' cross-attentions: 33 queries against
//   513 keys and back).
//
// Replaces the TPU kernel stlt_tpu/ops/flash.py::_blockwise_attn_kernel as
// launched by _blockwise_forward, in its lengths mode (_block_bias with
// lengths_bias, the causal block skip _causal_live and the dead-q-block skip)
// and its dense-bias mode (_block_bias reading bias_arr, with _causal_live),
// each with its prng dropout variant (_keep_block_heads) and its
// dropout_mask operand (a ring step passes the chunk's column view), and the lengths
// mode's ring-offset variant (off_base / valid_cols, _causal_live_off). The TPU kernel's block sizes (tb = 104, sb = 384
// at 513 tokens) do not carry over: here 64 queries per block and keys in
// chunks of 64, with chunks above the diagonal or past the clip's length
// never loaded; in bf16 at head dims 64 and 128 on wgmma and TMA
// (tc::attention_fwd_kernel), else the staged attention_kernel
// (attention_core.cuh, which also states the design and the bound).
#include "attention_core.cuh"

extern "C" int stlt_blockwise_attention(
    const void* q, const void* k, const void* v, long long qb, long long qt, long long qn,
    long long kb, long long kt, long long kn, long long vb, long long vt, long long vn,
    const void* bias, long long bias_b, long long bias_n, long long bias_t, const void* lengths,
    int causal, int row0, int col0, void* out, void* lse, int B, int T, int S, int N, int D,
    float scale, int dropout, unsigned seed, unsigned thresh, float dropout_scale, unsigned row_base,
    const void* mask, long long mask_b,
    long long mask_n, long long mask_t, int dtype,
    void* stream) {
  if (lse == nullptr) return -1;
  stlt::attn::AttnArgs a{q, k, v, qb, qt, qn, kb, kt, kn, vb, vt, vn,
                         static_cast<const float*>(bias), bias_b, bias_n, bias_t,
                         static_cast<const int*>(lengths), causal, row0, col0, out,
                         static_cast<float*>(lse), B, T, S, N, scale,
                         stlt::attn::MaskedDropout{{dropout, seed, thresh, dropout_scale, row_base, 0u, static_cast<unsigned>(N)},
                                                 static_cast<const uint8_t*>(mask), mask_b,
                                                 mask_n, mask_t}};
  if (lengths != nullptr) return stlt::attn::dispatch<true>(a, D, dtype, stream);
  return stlt::attn::dispatch<false>(a, D, dtype, stream);
}

// The last accepted forward launch of this library: {wgmma body, D,
// lengths mode, bias stage, drop mode} (attention_core.cuh).
extern "C" void stlt_blockwise_attention_last_launch(int* out) {
  for (int i = 0; i < 5; ++i) out[i] = stlt::attn::last_fwd_launch()[i];
}
