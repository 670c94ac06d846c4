// The backward of the blockwise attention kernel (blockwise_attention.cu),
// lengths mode: dq, dk, dv with the causal and length mask made in the
// kernel, hashed probability dropout, from the forward's lse and
// dsum = rowsum(dO o out). Key chunks past the clip's length or above the
// diagonal and dead query tiles are skipped; dead query rows get dq = 0 and
// add nothing to dk, dv.
//
// Replaces the TPU kernels stlt_tpu/ops/flash.py::_blockwise_dq_kernel (:655)
// and _blockwise_dkdv_kernel (:745) as launched by _blockwise_backward for
// 513 tokens and up, in their lengths mode; their dense-bias and ring-offset
// variants are not ported yet. The TPU kernels carry their sums across a
// sequential grid in VMEM scratch; here each block loops over the other axis
// itself (attention_bwd_core.cuh, which also states the design and the
// bound).
#include "attention_bwd_core.cuh"

extern "C" int stlt_blockwise_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, long long qb, long long qt,
    long long qn, long long kb, long long kt, long long kn, long long vb, long long vt,
    long long vn, long long ob, long long ot, long long on, const void* lengths, int causal,
    const void* lse, const void* dsum, void* dq, void* dk, void* dv, int B, int T, int S, int N,
    int D, float scale, int dropout, unsigned seed, unsigned thresh, float dropout_scale,
    int dtype, void* stream) {
  stlt::attn::BwdArgs a{q, k, v, dout, qb, qt, qn, kb, kt, kn, vb, vt, vn, ob, ot, on,
                        nullptr, 0, 0, 0,
                        static_cast<const int*>(lengths), causal,
                        static_cast<const float*>(lse), static_cast<const float*>(dsum),
                        dq, dk, dv, B, T, S, N, scale,
                        stlt::Dropout{dropout, seed, thresh, dropout_scale}};
  return stlt::attn::dispatch_bwd<true>(a, D, dtype, stream);
}
