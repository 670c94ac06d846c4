// The blockwise attention kernel of the long-clip path, lengths mode: key s of
// clip b is live iff s < lengths[b] (and s <= t when causal), the mask made in
// the kernel, so no [B, 1, T, S] bias exists. Writes out [B, T, N, 64] and
// lse [B, N, T] = m + log(l); query rows t >= lengths[b] are zeros with lse 0.
//
// Replaces the TPU kernel stlt_tpu/ops/flash.py::_blockwise_attn_kernel as
// launched by _blockwise_forward for 513 tokens and up, in its lengths mode
// (_block_bias with lengths_bias, the causal block skip _causal_live and the
// dead-q-block skip), with its prng dropout variant (_keep_block_heads).
// Its dense-bias and ring-offset variants are not ported yet. The TPU
// kernel's block sizes (tb = 104, sb = 384 at 513 tokens) do not carry
// over: here 64 queries per block and keys in chunks of 64, with chunks above
// the diagonal or past the clip's length never loaded (attention_core.cuh,
// which also states the design and the bound).
#include "attention_core.cuh"

extern "C" int stlt_blockwise_attention(
    const void* q, const void* k, const void* v, long long qb, long long qt, long long qn,
    long long kb, long long kt, long long kn, long long vb, long long vt, long long vn,
    const void* lengths, int causal, void* out, void* lse, int B, int T, int S, int N, int D,
    float scale, int dropout, unsigned seed, unsigned thresh, float dropout_scale, int dtype,
    void* stream) {
  stlt::attn::AttnArgs a{q, k, v, qb, qt, qn, kb, kt, kn, vb, vt, vn,
                         nullptr, 0, 0, 0,
                         static_cast<const int*>(lengths), causal, out,
                         static_cast<float*>(lse), B, T, S, N, scale,
                         stlt::Dropout{dropout, seed, thresh, dropout_scale}};
  return stlt::attn::dispatch<true>(a, D, dtype, stream);
}
