"""Mutation check of the bf16 tolerances that ``chip_smoke.py`` states as
relative norms.

``chip_smoke.py`` holds the long-clip attention forwards' output (rows 6
and 8 in every mode, ``ATTN_FWD_REL``), the long-clip attention backwards'
dq, dk and dv against ``attention_bwd_plain`` (``BWD_REL``), the fused train
tail's dx
and dattn against its plain backward (``TAIL_BWD_REL``), the fused
cross-attention's output against its plain version (``CROSS_REL``), the
blockwise forward's dense-bias output against its plain version
(``DENSE_REL``) and the blockwise backward's dense-bias dq, dk and dv
against ``attention_bwd_plain`` (``DENSE_BWD_REL``), within a relative
Frobenius-norm error; the fused projection+attention (rows 1 and 3) and the
cross-attention also elementwise (``OP_TOL``) with dead rows exact zeros.
This script shows which faults those limits catch. It copies the package into a temporary
directory, edits the kernel sources there (the checkout is never touched),
builds the kernels of the family the variant belongs to from each copy and
prints each variant's relative norm errors in bf16:

- ``sound``: the sources as they are (every family);
- attention, dense and dense_bwd, ``no_lo_split``: the tensor-core products
  of the probabilities and of dz take only the bf16 hi part, not hi + lo
  (the staged forward's and backward's ``attention_core.cuh::chunk_pv``, the
  wgmma forward's and backward's ``attention_tc.cuh::tc::split_hi_lo``);
- attention and dense, ``fwd_pv_hi_only``: the wgmma forward's P V takes
  only P's bf16 hi part (``attention_core.cuh::tc::attention_fwd_kernel``;
  its backward keeps hi + lo);
- attention and dense, ``fwd_no_rescale``: the wgmma forward does not
  rescale the O accumulator by exp(m_old - m) when a row's running max
  grows (l still is);
- attention and dense, ``fwd_keep_ts_swapped``: the wgmma forward hashes
  the keep bit of (query t, key s) at (s, t);
- attention and dense_bwd, ``no_dsum``: dz = p o dp, without the ``- dsum``
  term (every backward body);
- attention and dense_bwd, ``dkdv_keep_ts_swapped``: the dk/dv kernel hashes
  the keep bit of (query t, key s) at (s, t) on its transposed fragment;
- tail, ``act_grad_of_cd_z1``: act' taken on z1 rounded to bf16 instead of
  the f32 z1 (``fused_tail_train_bwd.cu::hidden_grads``, which GEMM A's
  epilogue calls);
- tail, ``no_keep2_in_input``: the input entry point's dh2 without the
  out-site keep bits (``tail_bwd_prologue_kernel``);
- tail, ``weight_partials_in_bf16``: the weight GEMM rounds each split's
  partial dW1 and dW2 to bf16 before the ordered sum
  (``tail_bwd_weight_gemm_kernel``);
- tail, ``weight_split_left_out``: the weight GEMM's last token split adds
  nothing (``tail_bwd_weight_gemm_kernel``);
- tail, ``tail_hidden_n128``: no fault but a design variant, GEMM A
  (``tail_bwd_hidden_kernel``) on [128, 128] tiles at one block an SM
  instead of [128, 64] at two, timed beside ``sound``;
- cross, ``cross_no_bo``: the output bias bo left out (the out GEMM's
  epilogue, ``sublayer.cuh::gemm_body``);
- cross, ``cross_no_bkv``: the context projection's bias bkv left out (the
  kv GEMM's epilogue; its k half moves no softmax, its v half moves the
  output by bv @ Wo);
- proj and cross, ``qkv_rounded_before_bias``: the projection GEMMs round
  their f32 sums before the bias add, then round again (a rounding point of
  the contract moved; in the split q/k/v pass through device memory in bf16,
  so the old variants that kept q or qkv in f32 have no counterpart);
- cross, ``cross_head_left_out``: the last head adds nothing (its
  probabilities zero in ``sublayer.cuh::attn_body``);
- proj, ``proj_keep_at_packed_row``: the train forward's keep bits hashed at
  the packed row instead of the original one (``attn_body``);
- proj, ``proj_dead_rows_computed``: no packing, so the dead rows are
  computed like live ones instead of written as zeros
  (``fused_proj_attention.cu::launch_tc``); the dead-row check, not a norm,
  is what sees it;
- proj_bwd, ``proj_bwd_do_rounded``: the backward's do = g Wo^T rounded to
  bf16 in the f32 GEMM's epilogue (``sublayer.cuh::gemm_f32_tile``), a
  rounding point the contract does not have;
- proj_bwd, ``proj_bwd_keep_at_packed_row``: the attention backward's keep
  bits hashed at the packed row instead of the original one
  (``fused_proj_attention_bwd.cu::proj_bwd_attn_kernel``);
- proj_bwd, ``proj_bwd_split_left_out``: the dWo/dbo GEMM's first row split
  adds nothing (``proj_bwd_weight_gemm_kernel``);
- proj_bwd, ``proj_bwd_no_bqkv``: the qkv recompute without its bias
  (``gemm_tile``'s epilogue);
- proj_bwd, ``proj_bwd_dead_rows_unwritten``: the attention backward's
  blocks past the live count leave their dead rows' dqkv as they find them;
  each case first frees a NaN-filled block of dqkv's size, which dqkv's
  allocation takes ("poisoned"), so the dead-row check sees it;
- dense, ``dense_causal_last_key_dropped``: with the causal flag, each
  query tile's key range stops one key short, so the last query of every
  tile loses its diagonal key;
- dense_bwd, ``dense_bwd_causal_last_key_dropped``: the same in the dq
  kernel of the backward's dense-bias mode;
- dense_bwd, ``dense_bwd_bias_transposed``: the dk/dv kernel reads the
  bias with its t and s strides swapped (``bias[b, n, s, t]``; in the wgmma
  body, the producer's copy of each bias tile).

Run on a machine with one H100, ``nvcc`` and PyTorch for CUDA::

    python -m stlt_tpu_torch.utils.bwd_tolerance [attention | tail | cross | proj | proj_bwd | dense | dense_bwd]

(those families' variants only when named). The variants' kernels are built
in parallel, then measured one variant at a time. The last line is one JSON
object {variant: {family: [rows]}}. Attention rows {"T", "rate", "out",
"lse", "dq", "dk", "dv"}: 6 clips, 12 heads of 64, T = 257 on the short
kernels with a causal padding bias, T = 513 on the blockwise kernels in
lengths mode, dropout 0 and 0.1 (chip_smoke's check shapes); "out" and
"lse" are the forward kernel's against the plain forward's, and the
backward takes out and lse from the plain forward, so that only the
backward differs in dq, dk and dv. Tail rows {"tokens", "rate",
"dx", "dattn", "dn1s", ..., "dn2b"}: H = 768, FF = 3072, GELU (tanh), r2
from the plain forward; 4,112 tokens (16 clips of 257 frames, the temporal
stage of a 512-frame batch) with ragged live tokens and dropout 0 and 0.1
(one split of the weight products), and 65,792 live tokens with dropout
0.1 (the spatial stage of a 256-frame batch: 8 splits), where the row also
holds the input and weight entry points' times ("input_ms", "weight_ms":
CUDA events, the median of five windows of five launches). Cross rows {"T",
"S", "padded", "y"}: chip_smoke's row-5 checks at B = 64, H = 768, 12
heads, (T, S) = (17, 33), (33, 17), (8, 64), (64, 8), with and without a
key-padding bias, weights drawn as ``chip_smoke.make_weights`` draws them.
Proj rows {"stage", "T", "rate", "y", "op_tol", "dead_zero"}: rows 1 (rate
0) and 3 (rate 0.1) at B = 64, H = 768, 12 heads: spatial (T = 8, 1,088
rows, about 60 % of them live, key padding), temporal (T = 17, causal plus
padding) and T = 33 (B = 32); "op_tol" whether every element is within
OP_TOL, "dead_zero" whether every dead row is exact zeros. Cross rows also
carry "op_tol". Proj_bwd rows {"stage", "T", "rate", "dqkv", "dwo", "dbo",
"op_tol", "dead_zero", "poisoned"}: row 4's bf16 backward on the same
shapes and weights in the model's layout (the temporal stage without
rows_live, as on the main path; T = 33 with 80 % of the rows live), dropout
0 and 0.1, the cotangent zero on dead rows; a non-finite output reads as an
infinite error; "op_tol" for dqkv. Dense rows {"T", "S", "bias", "causal",
"rate", "out", "lse"}: chip_smoke's row-8 dense-bias checks at B = 16, 12
heads of 64, dropout 0 and 0.1. Dense_bwd rows {"T", "S",
"bias", "causal", "rate", "dq", "dk", "dv"}: the same cases with dropout 0
and 0.1; out and lse from the plain forward, so only the backward differs.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
FAMILIES = {
    "attention": ("flash_attention", "blockwise_attention", "flash_attention_bwd",
                  "blockwise_attention_bwd"),
    "tail": ("fused_tail_train_bwd_row",),
    "cross": ("fused_cross_attention",),
    "proj": ("fused_proj_attention",),
    "proj_bwd": ("fused_proj_attention_train_bwd",),
    "dense": ("blockwise_attention",),
    "dense_bwd": ("blockwise_attention_bwd",),
}
# variant -> (families it is measured in, source edits)
MUTATIONS = {
    "sound": (tuple(FAMILIES), []),
    "no_lo_split": (("attention", "dense", "dense_bwd"), [
        ("attention_core.cuh",
         "pl[r * kLDP + lane + 32 * j] = __float2bfloat16_rn(p[r][j] - __bfloat162float(hi));",
         "pl[r * kLDP + lane + 32 * j] = __float2bfloat16_rn(0.f);"),
        ("attention_tc.cuh",
         "const __nv_bfloat162 l = __floats2bfloat162_rn(x[2 * i] - __low2float(h), x[2 * i + 1] - __high2float(h));",
         "const __nv_bfloat162 l = __floats2bfloat162_rn(0.f, 0.f);"),
    ]),
    "fwd_pv_hi_only": (("attention", "dense"), [(
        "attention_core.cuh", "split_hi_lo(st, ph, pl);",
        "split_hi_lo(st, ph, pl);\n    for (int i = 0; i < 16; ++i) pl[i] = 0u;",
    )]),
    "fwd_no_rescale": (("attention", "dense"), [(
        "attention_core.cuh", "acc[i] *= corr[(i >> 1) & 1];", "acc[i] *= 1.f;",
    )]),
    "fwd_keep_ts_swapped": (("attention", "dense"), [(
        "attention_core.cuh",
        "pr *= p.drop.keep_scale<kDrop>(b, n, t_h[h], c * kBK + 8 * j + 2 * tig + e, S);",
        "pr *= p.drop.keep_scale<kDrop>(b, n, c * kBK + 8 * j + 2 * tig + e, t_h[h], S);",
    )]),
    "no_dsum": (("attention", "dense_bwd"), [
        ("attention_bwd_core.cuh", "expf(x - lse_t) * (d - ds);", "expf(x - lse_t) * d;"),
        ("attention_bwd_core.cuh", "pr * (dp[r][j] * keep - ds_j[j]);", "pr * (dp[r][j] * keep);"),
        ("attention_bwd_core.cuh", "exp2f((x - lse_h[h]) * kLog2e) * (d - ds_h[h]);",
         "exp2f((x - lse_h[h]) * kLog2e) * d;"),
        ("attention_bwd_core.cuh", "pr * (dpt[idx] * keep - ds_t);", "pr * (dpt[idx] * keep);"),
    ]),
    "dkdv_keep_ts_swapped": (("attention", "dense_bwd"), [(
        "attention_bwd_core.cuh",
        "const float keep = kDrop == kDropNone ? 1.f : p.drop.keep_scale<kDrop>(b, n, t, key, S);",
        "const float keep = kDrop == kDropNone ? 1.f : p.drop.keep_scale<kDrop>(b, n, key, t, S);",
    )]),
    "act_grad_of_cd_z1": (("tail",), [(
        "fused_tail_train_bwd.cu",
        "return make_float2(dacc * activation_grad(z, act), h1);",
        "return make_float2(dacc * activation_grad(round_to<T>(z), act), h1);",
    )]),
    "no_keep2_in_input": (("tail",), [(
        "fused_tail_train_bwd.cu",
        "e[j] = from_float<bf16>(to_float(e[j]) * p.drop.keep_at(lane2, rc2, vi * 8 + j));",
        "e[j] = from_float<bf16>(to_float(e[j]));",
    )]),
    "weight_partials_in_bf16": (("tail",), [(
        "fused_tail_train_bwd.cu",
        "*reinterpret_cast<float2*>(out + (long long)r * cols_out + c) =\n"
        "            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);",
        "*reinterpret_cast<float2*>(out + (long long)r * cols_out + c) =\n"
        "            make_float2(round_to<bf16>(acc[4 * j + 2 * h]), round_to<bf16>(acc[4 * j + 2 * h + 1]));",
    )]),
    "weight_split_left_out": (("tail",), [(
        "fused_tail_train_bwd.cu",
        "const long long k1 = min(k0 + p.chunk, depth);",
        "const long long k1 = blockIdx.y + 1 < gridDim.y ? min(k0 + p.chunk, depth) : k0;",
    )]),
    "tail_hidden_n128": (("tail",), [
        ("fused_tail_train_bwd.cu", "constexpr int kHiddenBN = 64;", "constexpr int kHiddenBN = 128;"),
        ("fused_tail_train_bwd.cu", "__launch_bounds__(kGemmThreads, 2)\n    tail_bwd_hidden_kernel(",
         "__launch_bounds__(kGemmThreads, 1)\n    tail_bwd_hidden_kernel("),
    ]),
    "cross_no_bo": (("cross",), [(
        "sublayer.cuh",
        "const float2 b = c < p.N ? __bfloat1622float2",
        "const float2 b = c < p.N && !p.scatter ? __bfloat1622float2",
    )]),
    "cross_no_bkv": (("cross",), [(
        "sublayer.cuh",
        "const float2 b = c < p.N ? __bfloat1622float2",
        "const float2 b = c < p.N && p.N != 2 * p.K ? __bfloat1622float2",
    )]),
    "qkv_rounded_before_bias": (("proj", "cross"), [(
        "sublayer.cuh",
        "__floats2bfloat162_rn(acc[4 * j + 2 * h] + b.x, acc[4 * j + 2 * h + 1] + b.y);",
        "__floats2bfloat162_rn((p.scatter ? acc[4 * j + 2 * h] : round_to<bf16>(acc[4 * j + 2 * h])) + b.x,\n"
        "                                  (p.scatter ? acc[4 * j + 2 * h + 1] : round_to<bf16>(acc[4 * j + 2 * h + 1])) + b.y);",
    )]),
    "cross_head_left_out": (("cross",), [(
        "sublayer.cuh", "      pr[s] = pv;\n", "      pr[s] = h == p.N - 1 ? 0.f : pv;\n",
    )]),
    "proj_keep_at_packed_row": (("proj",), [(
        "sublayer.cuh", "p.drop.row_lane(orig, h)", "p.drop.row_lane(b, h)",
    )]),
    "proj_dead_rows_computed": (("proj",), [(
        "fused_proj_attention.cu", "const bool packed = p.rows_live != nullptr;", "const bool packed = false;",
    )]),
    "proj_bwd_do_rounded": (("proj_bwd",), [(
        "sublayer.cuh",
        "*reinterpret_cast<float2*>(p.out + (long long)r * p.N + c) =\n"
        "            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);",
        "*reinterpret_cast<float2*>(p.out + (long long)r * p.N + c) =\n"
        "            make_float2(round_to<bf16>(acc[4 * j + 2 * h]), round_to<bf16>(acc[4 * j + 2 * h + 1]));",
    )]),
    "proj_bwd_keep_at_packed_row": (("proj_bwd",), [
        ("fused_proj_attention_bwd.cu", "p.drop.row_lane(orig, h)", "p.drop.row_lane(b, h)"),
    ]),
    "proj_bwd_split_left_out": (("proj_bwd",), [(
        "fused_proj_attention_bwd.cu",
        "const long long k1 = min(k0 + p.chunk, round_up(live, kBK));",
        "const long long k1 = blockIdx.y == 0 ? k0 : min(k0 + p.chunk, round_up(live, kBK));",
    )]),
    "proj_bwd_no_bqkv": (("proj_bwd",), [(
        "sublayer.cuh", "const float2 b = c < p.N ? __bfloat1622float2", "const float2 b = false ? __bfloat1622float2",
    )]),
    "proj_bwd_dead_rows_unwritten": (("proj_bwd",), [(
        "fused_proj_attention_bwd.cu",
        "for (int i = tid; i < T * 3 * H / 8; i += kBwdThreads) d[i] = make_uint4(0u, 0u, 0u, 0u);",
        "(void)d;",
    )]),
    "dense_causal_last_key_dropped": (("dense",), [(
        "attention_core.cuh",
        "if (!kLengths && p.causal) kend = min(min(q0 + kBQ, T), S);",
        "if (!kLengths && p.causal) kend = min(min(q0 + kBQ, T), S) - 1;",
    )]),
    "dense_bwd_causal_last_key_dropped": (("dense_bwd",), [(
        "attention_bwd_core.cuh",
        "if (!kLengths && p.causal) kend = min(min(q0 + kBQ, T), S);",
        "if (!kLengths && p.causal) kend = min(min(q0 + kBQ, T), S) - 1;",
    )]),
    "dense_bwd_bias_transposed": (("dense_bwd",), [
        ("attention_bwd_core.cuh",
         "x += __ldg(bias + (long long)t * p.bt + key);\n        const float pr =",
         "x += __ldg(bias + (long long)key * p.bt + t);\n        const float pr ="),
        ("attention_bwd_core.cuh",
         "load_bias_tile(m.bias + s * 64 * kLdT, kLdT, bias, p.bt, 1, i * kBQ, qlim, k0, kend, lane);",
         "load_bias_tile(m.bias + s * 64 * kLdT, kLdT, bias, 1, p.bt, i * kBQ, qlim, k0, kend, lane);"),
    ]),
}
TAIL_GRADS = ("dx", "dattn", "dn1s", "dn1b", "dw1", "db1", "dw2", "db2", "dn2s", "dn2b")


def median_ms(fn, iters: int = 5, windows: int = 5) -> float:
    """Median over ``windows`` windows of the mean device time of ``iters``
    launches of ``fn`` (CUDA events), after warmup."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[windows // 2]


def _rel(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30)).item()


def build(families) -> None:
    """Build the kernels of ``families`` with this interpreter's
    ``stlt_tpu_torch``."""
    from stlt_tpu_torch.ops import _kernels

    _kernels.build_all(names=[name for family in families for name in FAMILIES[family]])


def measure(family: str) -> list:
    """Relative norm errors of the bf16 kernels of ``family``
    against their plain versions, with this interpreter's
    ``stlt_tpu_torch``."""
    build([family])
    return {"attention": _measure_attention, "tail": _measure_tail, "cross": _measure_cross,
            "proj": _measure_proj, "proj_bwd": _measure_proj_bwd, "dense": _measure_dense,
            "dense_bwd": _measure_dense_bwd}[family]()


def _measure_tail() -> list:
    from stlt_tpu_torch.ops import fused_tail_train as ftt

    device = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    H, FF = 768, 3072
    u = lambda *shape, b: ((torch.rand(shape, generator=gen) * 2 - 1) * b).to(device)
    weights = [1 + u(H, b=0.1), u(H, b=0.1), u(H, FF, b=H ** -0.5), u(FF, b=H ** -0.5),
               u(FF, H, b=FF ** -0.5), u(H, b=FF ** -0.5), 1 + u(H, b=0.1), u(H, b=0.1)]
    rows = []
    for tokens, rate, ragged in ((16 * 257, 0.0, True), (16 * 257, 0.1, True),
                                 (32 * 257 * 8, 0.1, False)):
        x = torch.randn(tokens, H, generator=gen).to(device, torch.bfloat16)
        a = (0.5 * torch.randn(tokens, H, generator=gen)).to(device, torch.bfloat16)
        g = torch.randn(tokens, H, generator=gen).to(device, torch.bfloat16)
        live = (torch.rand(tokens, generator=gen) < 0.8).to(device) if ragged else None
        cfg = ftt.TailConfig(1e-12, "gelu", True, rate, 0x5EED if rate else None)
        _, r2 = ftt.fused_layer_tail_train_plain(x, a, weights, cfg, live)
        got = ftt._launch_tail_train_bwd(x, a, r2, g, weights, cfg, live)
        want = ftt.fused_layer_tail_train_bwd_plain(x, a, r2, g, weights, cfg, live)
        torch.cuda.synchronize()
        rows.append({"tokens": tokens, "rate": rate,
                     **{name: _rel(p, q) for name, p, q in zip(TAIL_GRADS, got, want)}})
        if not ragged:
            dr2 = ftt._launch_bwd_row(r2, g, weights[6], cfg)[0]
            scratch = ftt._launch_bwd_input(x, a, dr2, weights, cfg)[4]
            rows[-1]["input_ms"] = median_ms(lambda: ftt._launch_bwd_input(x, a, dr2, weights, cfg))
            rows[-1]["weight_ms"] = median_ms(lambda: ftt._launch_bwd_weight(scratch))
            del dr2, scratch
        del x, a, g, live, r2, got, want
        torch.cuda.empty_cache()
    return rows


# chip_smoke.OP_TOL in bf16: the elementwise bound every bf16 kernel output is held to.
OP_TOL_BF16 = dict(atol=6e-2, rtol=2e-2)


def _within_op_tol(got, want) -> bool:
    err = (got.float() - want.float()).abs()
    return bool((err <= OP_TOL_BF16["atol"] + OP_TOL_BF16["rtol"] * want.float().abs()).all())


def _measure_proj() -> list:
    from stlt_tpu_torch.ops import fused_encoder as fe
    from stlt_tpu_torch.ops import masks

    device = torch.device("cuda")
    gen = torch.Generator().manual_seed(5)
    H, heads, bf = 768, 12, torch.bfloat16
    u = lambda *shape, b: ((torch.rand(shape, generator=gen) * 2 - 1) * b).to(device)
    # The model's layout: transposed views of in_proj_weight [3H, H] and out_proj.weight.
    in_proj, out_proj = u(3 * H, H, b=(6 / (4 * H)) ** 0.5), u(H, H, b=H ** -0.5)
    weights = (in_proj.t(), u(3 * H, b=0.02), out_proj.t(), u(H, b=0.02))
    rows = []
    for stage, B, T in (("spatial", 64 * 17, 8), ("temporal", 64, 17), ("temporal", 32, 33)):
        x = torch.randn((B, T, H), generator=gen).to(device, bf)
        lengths = torch.randint(1, T + 1, (B,), generator=gen)
        pad = torch.arange(T)[None, :] >= lengths[:, None]
        if stage == "spatial":
            pad[:, 0] = False
            bias, live = masks.key_padding_bias(pad), torch.rand(B, generator=gen) < 0.6
        else:
            bias, live = masks.causal_bias(T) + masks.key_padding_bias(pad), torch.rand(B, generator=gen) < 0.8
        bias, live = bias.to(device), live.to(device)
        for rate in (0.0, 0.1):
            kw = dict(num_heads=heads, compute_dtype=bf, rows_live=live)
            if rate:
                got = fe.fused_proj_attention_train(x, *weights, bias, 0x5EED, dropout_rate=rate, **kw)
                want = fe.fused_proj_attention_train_plain(x, *weights, bias, 0x5EED, dropout_rate=rate, **kw)
            else:
                got = fe.fused_proj_attention(x, *weights, bias, **kw)
                want = fe.fused_proj_attention_plain(x, *weights, bias, **kw)
            torch.cuda.synchronize()
            rows.append({"stage": stage, "T": T, "rate": rate, "y": _rel(got, want),
                         "op_tol": _within_op_tol(got, want), "dead_zero": not bool(got[~live].any())})
    return rows


def _rel_or_inf(got, want) -> float:
    return _rel(got, want) if bool(torch.isfinite(got.float()).all()) else float("inf")


def _measure_proj_bwd() -> list:
    from stlt_tpu_torch.ops import fused_encoder as fe
    from stlt_tpu_torch.ops import masks

    device = torch.device("cuda")
    gen = torch.Generator().manual_seed(6)
    H, heads, bf = 768, 12, torch.bfloat16
    u = lambda *shape, b: ((torch.rand(shape, generator=gen) * 2 - 1) * b).to(device)
    # The model's layout in bf16 (no conversion allocates): transposed views
    # of in_proj_weight [3H, H] and out_proj.weight.
    in_proj, out_proj = u(3 * H, H, b=(6 / (4 * H)) ** 0.5).to(bf), u(H, H, b=H ** -0.5).to(bf)
    bqkv = u(3 * H, b=0.02).to(bf)
    rows = []
    for stage, B, T in (("spatial", 64 * 17, 8), ("temporal", 64, 17), ("temporal", 32, 33)):
        x = torch.randn((B, T, H), generator=gen).to(device, bf)
        g = torch.randn((B, T, H), generator=gen).to(device, bf)
        lengths = torch.randint(1, T + 1, (B,), generator=gen)
        pad = torch.arange(T)[None, :] >= lengths[:, None]
        if stage == "spatial":
            pad[:, 0] = False
            bias, live = masks.key_padding_bias(pad), torch.rand(B, generator=gen) < 0.6
        else:
            bias, live = masks.causal_bias(T) + masks.key_padding_bias(pad), torch.rand(B, generator=gen) < 0.8
        rows_live = None if T == 17 else live.to(device)
        if rows_live is not None:
            g[~rows_live] = 0
        bias = bias.to(device)
        for rate in (0.0, 0.1):
            args = (x, in_proj.t(), bqkv, out_proj.t(), bias, g, 0x5EED)
            kw = dict(num_heads=heads, dropout_rate=rate, compute_dtype=bf, rows_live=rows_live)
            want = fe.fused_proj_attention_train_bwd_plain(*args, **kw)
            poison = torch.full((B, T, 3 * H), float("nan"), dtype=bf, device=device)
            poison_ptr = poison.data_ptr()
            del poison  # its block goes back to the allocator, and dqkv's allocation takes it
            got = fe._launch_proj_bwd(*args, **kw)
            torch.cuda.synchronize()
            dead = ~rows_live if rows_live is not None else torch.zeros(B, dtype=torch.bool, device=device)
            rows.append({"stage": stage, "T": T, "rate": rate,
                         **{name: _rel_or_inf(a, b) for name, a, b in zip(("dqkv", "dwo", "dbo"), got, want)},
                         "op_tol": _within_op_tol(got[0], want[0]),
                         "dead_zero": bool(torch.isfinite(got[0][dead].float()).all()) and not bool(got[0][dead].any()),
                         "poisoned": got[0].data_ptr() == poison_ptr})
            del got, want
        del x, g
        torch.cuda.empty_cache()
    return rows


def _measure_cross() -> list:
    from stlt_tpu_torch.ops import fused_encoder as fe
    from stlt_tpu_torch.ops import masks

    device = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)
    B, H, heads = 64, 768, 12
    u = lambda *shape, b: ((torch.rand(shape, generator=gen) * 2 - 1) * b).to(device)
    wq, wkv = u(H, H, b=(6 / (4 * H)) ** 0.5), u(H, 2 * H, b=(6 / (4 * H)) ** 0.5)
    weights = (wq, u(H, b=0.02), wkv, u(2 * H, b=0.02), u(H, H, b=H ** -0.5), u(H, b=0.02))
    rows = []
    for T, S in ((17, 33), (33, 17), (8, 64), (64, 8)):
        for padded in (False, True):
            x = torch.randn((B, T, H), generator=gen).to(device, torch.bfloat16)
            ctx = torch.randn((B, S, H), generator=gen).to(device, torch.bfloat16)
            bias = None
            if padded:
                lengths = torch.randint(1, S + 1, (B,), generator=gen)
                bias = masks.key_padding_bias(torch.arange(S)[None, :] >= lengths[:, None]).to(device)
            kw = dict(num_heads=heads, compute_dtype=torch.bfloat16)
            got = fe.fused_cross_attention(x, ctx, *weights, bias, **kw)
            want = fe.fused_cross_attention_plain(x, ctx, *weights, bias, **kw)
            torch.cuda.synchronize()
            rows.append({"T": T, "S": S, "padded": padded, "y": _rel(got, want),
                         "op_tol": _within_op_tol(got, want)})
    return rows


def _measure_dense() -> list:
    from stlt_tpu_torch.ops import flash
    from stlt_tpu_torch.ops import masks

    device = torch.device("cuda")
    gen = torch.Generator().manual_seed(3)
    B, N, D = 16, 12, 64
    rows = []
    for T, S, kind, causal in ((513, 513, "causal_padding", False), (513, 513, "causal_padding", True),
                               (513, 33, "none", False), (33, 513, "key_padding", False)):
        q, k, v = (torch.randn((B, L, N, D), generator=gen).to(device, torch.bfloat16) for L in (T, S, S))
        lengths = torch.randint(1, S + 1, (B,), generator=gen)
        lengths[0] = S
        pad = torch.arange(S)[None, :] >= lengths[:, None]
        bias = {"causal_padding": lambda: masks.causal_bias(T) + masks.key_padding_bias(pad),
                "key_padding": lambda: masks.key_padding_bias(pad), "none": lambda: None}[kind]()
        bias = None if bias is None else bias.to(device)
        for rate in (0.0, 0.1):
            kw = dict(bias=bias, causal=causal, dropout_rate=rate, dropout_seed=0x5EED if rate else None)
            out, lse = flash.blockwise_attention(q, k, v, **kw)
            want, want_lse = flash.blockwise_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            rows.append({"T": T, "S": S, "bias": kind, "causal": causal, "rate": rate,
                         "out": _rel(out, want), "lse": _rel(lse, want_lse)})
    return rows


def _measure_dense_bwd() -> list:
    from stlt_tpu_torch.ops import flash
    from stlt_tpu_torch.ops import masks

    device = torch.device("cuda")
    gen = torch.Generator().manual_seed(4)
    B, N, D = 16, 12, 64
    rows = []
    for T, S, kind, causal in ((513, 513, "causal_padding", False), (513, 513, "causal_padding", True),
                               (513, 33, "none", False), (33, 513, "key_padding", False)):
        for rate in (0.0, 0.1):
            q, k, v, dout = (torch.randn((B, L, N, D), generator=gen).to(device, torch.bfloat16)
                             for L in (T, S, S, T))
            lengths = torch.randint(1, S + 1, (B,), generator=gen)
            lengths[0] = S
            pad = torch.arange(S)[None, :] >= lengths[:, None]
            bias = {"causal_padding": lambda: masks.causal_bias(T) + masks.key_padding_bias(pad),
                    "key_padding": lambda: masks.key_padding_bias(pad), "none": lambda: None}[kind]()
            bias = None if bias is None else bias.to(device)
            kw = dict(bias=bias, causal=causal, dropout_rate=rate, dropout_seed=0x5EED if rate else None)
            out, lse = flash.blockwise_attention_plain(q, k, v, **kw)
            dsum = flash._dsum(dout, out, None)
            got = flash.blockwise_attention_bwd(q, k, v, dout, lse, dsum, **kw)
            want = flash.attention_bwd_plain(q, k, v, dout, lse, dsum, **kw)
            torch.cuda.synchronize()
            rows.append({"T": T, "S": S, "bias": kind, "causal": causal, "rate": rate,
                         **{name: _rel(a, b) for name, a, b in zip(("dq", "dk", "dv"), got, want)}})
    return rows


def _measure_attention() -> list:
    from stlt_tpu_torch.ops import flash

    device = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    B, N, D = 6, 12, 64
    rows = []
    for T in (257, 513):
        for rate in (0.0, 0.1):
            q, k, v, dout = (torch.randn((B, T, N, D), generator=gen).to(device, torch.bfloat16)
                             for _ in range(4))
            lengths = torch.randint(T // 2, T + 1, (B,), generator=gen).to(device)
            kw = dict(dropout_rate=rate, dropout_seed=0x5EED if rate else None)
            if T < 513:
                kw["bias"] = flash._lengths_dense_bias(lengths, T, T, True)
                out, lse = flash.fused_attention_plain(q, k, v, with_lse=True, **kw)
                got_out, got_lse = flash.fused_attention(q, k, v, with_lse=True, **kw)
                dsum, bwd = flash._dsum(dout, out, None), flash.fused_attention_bwd
            else:
                kw.update(kv_lengths=lengths, causal=True)
                out, lse = flash.blockwise_attention_plain(q, k, v, **kw)
                got_out, got_lse = flash.blockwise_attention(q, k, v, **kw)
                dsum, bwd = flash._dsum(dout, out, lengths), flash.blockwise_attention_bwd
            got = bwd(q, k, v, dout, lse, dsum, **kw)
            want = flash.attention_bwd_plain(q, k, v, dout, lse, dsum, **kw)
            torch.cuda.synchronize()
            rows.append({"T": T, "rate": rate, "out": _rel(got_out, out), "lse": _rel(got_lse, lse),
                         **{name: _rel(a, b) for name, a, b in zip(("dq", "dk", "dv"), got, want)}})
    return rows


def main(argv=None) -> int:
    wanted = set((sys.argv[1:] if argv is None else argv) or FAMILIES)
    if not wanted <= set(FAMILIES):
        print(f"families are {sorted(FAMILIES)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: this check runs the kernels on an H100", file=sys.stderr)
        return 1
    results = {}
    with tempfile.TemporaryDirectory(prefix="stlt_bwd_tolerance_") as root:
        copies = {}
        for variant, (families, edits) in MUTATIONS.items():
            families = tuple(f for f in families if f in wanted)
            if not families:
                continue
            top = Path(root) / variant
            shutil.copytree(_PKG, top / _PKG.name, ignore=shutil.ignore_patterns("_build", "__pycache__"))
            for source, old, new in edits:
                path = top / _PKG.name / "csrc" / source
                text = path.read_text()
                if old not in text:
                    raise RuntimeError(f"{variant}: {source} no longer holds {old!r}")
                path.write_text(text.replace(old, new))
            copies[variant] = (top, families)

        def run(variant, call):
            top, families = copies[variant]
            return subprocess.Popen(
                [sys.executable, "-c", "import json; from stlt_tpu_torch.utils.bwd_tolerance "
                 f"import build, measure; {call(families)}"],
                cwd=top, env=dict(os.environ, PYTHONPATH=str(top)), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)

        def wait(variant, proc):
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"{variant} failed:\n{err[-4000:]}")
            return out

        # Every variant's nvcc at once; then one variant at a time on the card.
        builds = {variant: run(variant, lambda f: f"build({f!r})") for variant in copies}
        for variant, proc in builds.items():
            wait(variant, proc)
        for variant in copies:
            out = wait(variant, run(variant, lambda f: "print(json.dumps({f: measure(f) for f in "
                                                        f"{f!r}}}))"))
            results[variant] = json.loads(out.strip().splitlines()[-1])
            for family, rows in results[variant].items():
                groups = {"attention": {"out": ("out",), "lse": ("lse",), "dq/dk/dv": ("dq", "dk", "dv")},
                          "tail": {"dx/dattn": TAIL_GRADS[:2], "summed gradients": TAIL_GRADS[2:]},
                          "cross": {"y": ("y",)},
                          "proj": {"y": ("y",)},
                          "proj_bwd": {"dqkv": ("dqkv",), "dWo": ("dwo",), "dbo": ("dbo",)},
                          "dense": {"out": ("out",), "lse": ("lse",)},
                          "dense_bwd": {"dq/dk/dv": ("dq", "dk", "dv")}}[family]
                worst = ", ".join(f"{label} {max(r[k] for r in rows for k in keys):.3e}"
                                  for label, keys in groups.items())
                times = ", ".join(f"{k} {r[k]:.3f} ms" for r in rows for k in ("input_ms", "weight_ms")
                                  if k in r)
                flags = ", ".join(f"{k} {'held' if all(r[k] for r in rows) else 'FAILED'}"
                                  for k in ("op_tol", "dead_zero", "poisoned") if k in rows[0])
                print(f"{variant} ({family}): worst relative norm error of {worst}"
                      + (f"; at {max(r['tokens'] for r in rows)} tokens {times}" if times else "")
                      + (f"; {flags}" if flags else ""), flush=True)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
