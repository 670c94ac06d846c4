// The backward of the short attention kernel (flash_attention.cu), bias mode:
// dq, dk, dv of softmax(q k^T / sqrt(D) + bias) v with hashed probability
// dropout or a caller's keep mask, from the forward's lse and dsum =
// rowsum(dO o out).
//
// Replaces the TPU kernel stlt_tpu/ops/flash.py::_fused_bwd_kernel as
// launched by _fused_backward for 65..512 tokens. The TPU kernel holds each
// row's whole [T, S] tile in VMEM and recomputes the softmax; this one reads
// the lse its own forward wrote (the same function) and runs as two kernels,
// one for dq and one for dk and dv (attention_bwd_core.cuh, which also states
// the design and the bound).
#include "attention_bwd_core.cuh"

extern "C" int stlt_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, long long qb, long long qt,
    long long qn, long long kb, long long kt, long long kn, long long vb, long long vt,
    long long vn, long long ob, long long ot, long long on, const void* bias, long long bias_b,
    long long bias_n, long long bias_t, const void* lse, const void* dsum, void* dq, void* dk,
    void* dv, int B, int T, int S, int N, int D, float scale, int dropout, unsigned seed,
    unsigned thresh, float dropout_scale, unsigned row_base, unsigned head0, unsigned heads,
    const void* mask, long long mask_b, long long mask_n, long long mask_t, int dtype, void* stream) {
  stlt::attn::BwdArgs a{q, k, v, dout, qb, qt, qn, kb, kt, kn, vb, vt, vn, ob, ot, on,
                        static_cast<const float*>(bias), bias_b, bias_n, bias_t,
                        nullptr, 0, 0, 0,
                        static_cast<const float*>(lse), static_cast<const float*>(dsum),
                        dq, dk, dv, B, T, S, N, scale,
                        stlt::attn::MaskedDropout{{dropout, seed, thresh, dropout_scale, row_base, head0, heads},
                                                 static_cast<const uint8_t*>(mask), mask_b,
                                                 mask_n, mask_t}};
  return stlt::attn::dispatch_bwd<false>(a, D, dtype, stream);
}
