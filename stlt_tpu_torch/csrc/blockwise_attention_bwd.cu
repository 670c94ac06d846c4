// The backward of the blockwise attention kernel (blockwise_attention.cu):
// dq, dk, dv with hashed probability dropout, from the forward's lse and
// dsum = rowsum(dO o out), in the forward's two modes:
//
// - lengths (lengths != nullptr): the causal and length mask made in the
//   kernel; key chunks past the clip's length or above the diagonal and dead
//   query tiles are skipped; dead query rows get dq = 0 and add nothing to
//   dk, dv;
// - dense bias (lengths == nullptr): an f32 bias broadcastable to
//   [B, N, T, S] read through its (b, n, t) strides (stride 0 for a broadcast
//   dim); with `causal` (the bias declared causal) key chunks above a query
//   tile's diagonal (dq) and query tiles above a key chunk's (dk, dv) are
//   skipped; every row is computed; T and S may differ (the fusion models'
//   cross-attentions, 33 queries against 513 keys and back).
//
// Replaces the TPU kernels stlt_tpu/ops/flash.py::_blockwise_dq_kernel (:655)
// and _blockwise_dkdv_kernel (:745) as launched by _blockwise_backward for
// 513 tokens and up, in their lengths and dense-bias modes; their ring-offset
// variant is not ported yet. The TPU kernels carry their sums across a
// sequential grid in VMEM scratch; here each block loops over the other axis
// itself (attention_bwd_core.cuh, which also states the design and the
// bound).
#include "attention_bwd_core.cuh"

extern "C" int stlt_blockwise_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, long long qb, long long qt,
    long long qn, long long kb, long long kt, long long kn, long long vb, long long vt,
    long long vn, long long ob, long long ot, long long on, const void* bias, long long bias_b,
    long long bias_n, long long bias_t, const void* lengths, int causal, const void* lse,
    const void* dsum, void* dq, void* dk, void* dv, int B, int T, int S, int N, int D,
    float scale, int dropout, unsigned seed, unsigned thresh, float dropout_scale, int dtype,
    void* stream) {
  if (bias != nullptr && lengths != nullptr) return -1;
  stlt::attn::BwdArgs a{q, k, v, dout, qb, qt, qn, kb, kt, kn, vb, vt, vn, ob, ot, on,
                        static_cast<const float*>(bias), bias_b, bias_n, bias_t,
                        static_cast<const int*>(lengths), causal,
                        static_cast<const float*>(lse), static_cast<const float*>(dsum),
                        dq, dk, dv, B, T, S, N, scale,
                        stlt::Dropout{dropout, seed, thresh, dropout_scale}};
  if (lengths != nullptr) return stlt::attn::dispatch_bwd<true>(a, D, dtype, stream);
  return stlt::attn::dispatch_bwd<false>(a, D, dtype, stream);
}
