// The short attention kernel of the long-clip path: softmax(q k^T / sqrt(D) +
// bias) v over whole rows, q [B, T, N, D] and k, v [B, S, N, D] (D = 32, 64 or
// 128) read through their strides, an additive f32 bias broadcastable to [B, N, T, S].
//
// Replaces the TPU kernel stlt_tpu/ops/flash.py::_fused_attn_kernel as
// launched by _flash_forward for 65..512 tokens, with its prng dropout
// variant (in-kernel hashed keep bits at the global rows from row_base and
// the global heads from head0 of `heads`: a model rank's N / M heads hash
// their bits among the N) and its dropout_mask operand (mask mode: the
// caller's uint8 keep bits and their strides). In training it also writes
// lse [B, N, T] (pass nullptr in eval), which the backward
// (flash_attention_bwd.cu) reads. The TPU kernel holds each row's whole
// [T, S] f32 tile in VMEM; here the keys stream in chunks of 64 through an
// online softmax: in bf16 at head dims 64 and 128 on wgmma and TMA
// (tc::attention_fwd_kernel), else the staged attention_kernel
// (attention_core.cuh, which also states the design and the bound).
#include "attention_core.cuh"

extern "C" int stlt_flash_attention(
    const void* q, const void* k, const void* v, long long qb, long long qt, long long qn,
    long long kb, long long kt, long long kn, long long vb, long long vt, long long vn,
    const void* bias, long long bias_b, long long bias_n, long long bias_t, void* out, void* lse,
    int B, int T, int S, int N, int D, float scale, int dropout, unsigned seed, unsigned thresh,
    float dropout_scale, unsigned row_base, unsigned head0, unsigned heads, const void* mask,
    long long mask_b, long long mask_n, long long mask_t, int dtype, void* stream) {
  stlt::attn::AttnArgs a{q, k, v, qb, qt, qn, kb, kt, kn, vb, vt, vn,
                         static_cast<const float*>(bias), bias_b, bias_n, bias_t,
                         nullptr, 0, 0, 0, out, static_cast<float*>(lse), B, T, S, N, scale,
                         stlt::attn::MaskedDropout{{dropout, seed, thresh, dropout_scale, row_base, head0, heads},
                                                 static_cast<const uint8_t*>(mask), mask_b,
                                                 mask_n, mask_t}};
  return stlt::attn::dispatch<false>(a, D, dtype, stream);
}

// The last accepted forward launch of this library: {wgmma body, D,
// lengths mode, bias stage, drop mode} (attention_core.cuh).
extern "C" void stlt_flash_attention_last_launch(int* out) {
  for (int i = 0; i < 5; ++i) out[i] = stlt::attn::last_fwd_launch()[i];
}
