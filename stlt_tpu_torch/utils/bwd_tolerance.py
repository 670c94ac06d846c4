"""Mutation check of the bf16 tolerances that ``chip_smoke.py`` states as
relative norms.

``chip_smoke.py`` holds the long-clip attention backwards' dq, dk and dv
against ``attention_bwd_plain`` (``BWD_REL``), the fused train tail's dx
and dattn against its plain backward (``TAIL_BWD_REL``), the fused
cross-attention's output against its plain version (``CROSS_REL``), the
blockwise forward's dense-bias output against its plain version
(``DENSE_REL``) and the blockwise backward's dense-bias dq, dk and dv
against ``attention_bwd_plain`` (``DENSE_BWD_REL``), within a relative
Frobenius-norm error. This script shows
which faults those limits catch. It copies the package into a temporary
directory, edits the kernel sources there (the checkout is never touched),
builds the kernels of the family the variant belongs to from each copy and
prints each variant's relative norm errors in bf16:

- ``sound``: the sources as they are (every family);
- attention, dense and dense_bwd, ``no_lo_split``: the tensor-core products
  of the probabilities and of dz (``attention_core.cuh::chunk_pv``) take
  only the bf16 hi part, not hi + lo;
- attention and dense_bwd, ``no_dsum``: dz = p o dp, without the ``- dsum``
  term;
- tail, ``act_grad_of_cd_z1``: act' taken on z1 rounded to bf16 instead of
  the f32 z1 (``fused_tail_train_bwd.cu::hidden_grads``);
- tail, ``no_keep2_in_input``: the input kernel's dh2 without the out-site
  keep bits (``stage_dh2``);
- tail, ``weight_partials_in_bf16``: the weight kernel rounds each split's
  partial dW1 and dW2 to bf16 before the ordered sum (``weight_tile_tc``);
- tail, ``weight_split_left_out``: the weight kernel's last token split adds
  nothing (``weight_tile``);
- cross, ``cross_no_bo``: the output bias bo left out
  (``fused_cross_attention.cu::cross_attn_tc_kernel``);
- cross, ``cross_no_bkv``: the context projection's bias bkv left out
  (``kv_proj_tc_kernel``; its k half moves no softmax, its v half moves
  the output by bv @ Wo);
- cross, ``cross_q_unrounded``: q_h kept in f32 after its bias add instead
  of rounded to bf16 (a rounding point of the contract moved; o_h feeds the
  tensor cores from a bf16 tile, so it cannot be left unrounded);
- cross, ``cross_head_left_out``: the last head adds nothing;
- dense, ``dense_causal_last_key_dropped``: with the causal flag, each
  query tile's key range stops one key short, so the last query of every
  tile loses its diagonal key;
- dense_bwd, ``dense_bwd_causal_last_key_dropped``: the same in the dq
  kernel of the backward's dense-bias mode;
- dense_bwd, ``dense_bwd_bias_transposed``: the dk/dv kernel reads the
  bias with its t and s strides swapped (``bias[b, n, s, t]``).

Run on a machine with one H100, ``nvcc`` and PyTorch for CUDA::

    python -m stlt_tpu_torch.utils.bwd_tolerance [attention | tail | cross | dense | dense_bwd]

(those families' variants only when named). The variants' kernels are built
in parallel, then measured one variant at a time. The last line is one JSON
object {variant: {family: [rows]}}. Attention rows {"T", "rate", "dq",
"dk", "dv"}: 6 clips, 12 heads of 64, T = 257 on the short kernel with a
causal padding bias, T = 513 on the blockwise kernel in lengths mode,
dropout 0 and 0.1 (chip_smoke's check shapes); out and lse come from the
plain forward, so only the backward differs. Tail rows {"tokens", "rate",
"dx", "dattn", "dn1s", ..., "dn2b"}: H = 768, FF = 3072, GELU (tanh), r2
from the plain forward; 4,112 tokens (16 clips of 257 frames, the temporal
stage of a 512-frame batch) with ragged live tokens and dropout 0 and 0.1
(two splits of the weight products), and 65,792 live tokens with dropout
0.1 (the spatial stage of a 256-frame batch: 17 splits). Cross rows {"T",
"S", "padded", "y"}: chip_smoke's row-5 checks at B = 64, H = 768, 12
heads, (T, S) = (17, 33), (33, 17), (8, 64), (64, 8), with and without a
key-padding bias, weights drawn as ``chip_smoke.make_weights`` draws them.
Dense rows {"T", "S", "bias", "causal", "out", "lse"}: chip_smoke's row-8
dense-bias checks at B = 16, 12 heads of 64. Dense_bwd rows {"T", "S",
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
    "dense": ("blockwise_attention",),
    "dense_bwd": ("blockwise_attention_bwd",),
}
# variant -> (families it is measured in, source edits)
MUTATIONS = {
    "sound": (tuple(FAMILIES), []),
    "no_lo_split": (("attention", "dense", "dense_bwd"), [(
        "attention_core.cuh",
        "pl[r * kLDP + lane + 32 * j] = __float2bfloat16_rn(p[r][j] - __bfloat162float(hi));",
        "pl[r * kLDP + lane + 32 * j] = __float2bfloat16_rn(0.f);",
    )]),
    "no_dsum": (("attention", "dense_bwd"), [
        ("attention_bwd_core.cuh", "expf(x - lse_t) * (d - ds);", "expf(x - lse_t) * d;"),
        ("attention_bwd_core.cuh", "pr * (dp[r][j] * keep - ds_j[j]);", "pr * (dp[r][j] * keep);"),
    ]),
    "act_grad_of_cd_z1": (("tail",), [(
        "fused_tail_train_bwd.cu",
        "return make_float2(dacc * activation_grad(z, p.act), h1);",
        "return make_float2(dacc * activation_grad(round_to<T>(z), p.act), h1);",
    )]),
    "no_keep2_in_input": (("tail",), [(
        "fused_tail_train_bwd.cu",
        "if (p.drop.on) v = round_to<T>(v * p.drop.keep_scale(lane2, tok, H, c));",
        "if (p.drop.on) v = round_to<T>(v);",
    )]),
    "weight_partials_in_bf16": (("tail",), [(
        "fused_tail_train_bwd.cu",
        "      wmma::store_matrix_sync(t.out + (long long)(wm + r * 16) * ldo + wn + c * 16, acc[r][c], ldo,\n"
        "                              wmma::mem_row_major);",
        "      { for (int i = 0; i < acc[r][c].num_elements; ++i) "
        "acc[r][c].x[i] = __bfloat162float(__float2bfloat16_rn(acc[r][c].x[i]));\n"
        "        wmma::store_matrix_sync(t.out + (long long)(wm + r * 16) * ldo + wn + c * 16, acc[r][c], "
        "ldo, wmma::mem_row_major); }",
    )]),
    "weight_split_left_out": (("tail",), [(
        "fused_tail_train_bwd.cu",
        "  t.k_end = min(p.tokens, t.k_begin + p.chunk);",
        "  t.k_end = blockIdx.y + 1 < gridDim.y ? min(p.tokens, t.k_begin + p.chunk) : t.k_begin;",
    )]),
    "cross_no_bo": (("cross",), [(
        "fused_cross_attention.cu",
        "out[(tok0 + row) * H + c] = from_float<bf16>(v + to_float(bo[c]));",
        "out[(tok0 + row) * H + c] = from_float<bf16>(v);",
    )]),
    "cross_no_bkv": (("cross",), [(
        "fused_cross_attention.cu",
        "kv[(tok0 + row) * 2 * H + c] = from_float<bf16>(v + to_float(bkv[c]));",
        "kv[(tok0 + row) * 2 * H + c] = from_float<bf16>(v);",
    )]),
    "cross_q_unrounded": (("cross",), [(
        "fused_cross_attention.cu",
        "q_s[(qrf * 16 + i) * kD + d] = round_to<bf16>(v + to_float(bq[h * kD + d]));",
        "q_s[(qrf * 16 + i) * kD + d] = v + to_float(bq[h * kD + d]);",
    )]),
    "cross_head_left_out": (("cross",), [(
        "fused_cross_attention.cu",
        "for (int h = 0; h < NC; ++h) {  // NC == number of heads, since D == 64\n"
        "    // gemm_streamed synchronises the block before it reads x_s and after.",
        "for (int h = 0; h < NC - 1; ++h) {",
    )]),
    "dense_causal_last_key_dropped": (("dense",), [(
        "attention_core.cuh",
        "if (!kLengths && p.causal) kend = min(S, min(q0 + kBQ, T));",
        "if (!kLengths && p.causal) kend = min(S, min(q0 + kBQ, T)) - 1;",
    )]),
    "dense_bwd_causal_last_key_dropped": (("dense_bwd",), [(
        "attention_bwd_core.cuh",
        "if (!kLengths && p.causal) kend = min(S, min(q0 + kBQ, T));",
        "if (!kLengths && p.causal) kend = min(S, min(q0 + kBQ, T)) - 1;",
    )]),
    "dense_bwd_bias_transposed": (("dense_bwd",), [(
        "attention_bwd_core.cuh",
        "x += __ldg(bias + (long long)t * p.bt + key);\n        const float pr =",
        "x += __ldg(bias + (long long)key * p.bt + t);\n        const float pr =",
    )]),
}
TAIL_GRADS = ("dx", "dattn", "dn1s", "dn1b", "dw1", "db1", "dw2", "db2", "dn2s", "dn2b")


def _rel(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30)).item()


def build(families) -> None:
    """Build the kernels of ``families`` with this interpreter's
    ``stlt_tpu_torch``."""
    from stlt_tpu_torch.ops import _kernels

    _kernels.build_all(names=[name for family in families for name in FAMILIES[family]])


def measure(family: str) -> list:
    """Relative norm errors of the bf16 backward kernels of ``family``
    against their plain versions, with this interpreter's
    ``stlt_tpu_torch``."""
    build([family])
    return {"attention": _measure_attention, "tail": _measure_tail, "cross": _measure_cross,
            "dense": _measure_dense, "dense_bwd": _measure_dense_bwd}[family]()


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
        del x, a, g, live, r2, got, want
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
            rows.append({"T": T, "S": S, "padded": padded, "y": _rel(got, want)})
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
        out, lse = flash.blockwise_attention(q, k, v, bias=bias, causal=causal)
        want, want_lse = flash.blockwise_attention_plain(q, k, v, bias=bias, causal=causal)
        torch.cuda.synchronize()
        rows.append({"T": T, "S": S, "bias": kind, "causal": causal, "out": _rel(out, want),
                     "lse": _rel(lse, want_lse)})
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
                dsum, bwd = flash._dsum(dout, out, None), flash.fused_attention_bwd
            else:
                kw.update(kv_lengths=lengths, causal=True)
                out, lse = flash.blockwise_attention_plain(q, k, v, **kw)
                dsum, bwd = flash._dsum(dout, out, lengths), flash.blockwise_attention_bwd
            got = bwd(q, k, v, dout, lse, dsum, **kw)
            want = flash.attention_bwd_plain(q, k, v, dout, lse, dsum, **kw)
            torch.cuda.synchronize()
            rows.append({"T": T, "rate": rate,
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
                groups = {"attention": {"dq/dk/dv": ("dq", "dk", "dv")},
                          "tail": {"dx/dattn": TAIL_GRADS[:2], "summed gradients": TAIL_GRADS[2:]},
                          "cross": {"y": ("y",)},
                          "dense": {"out": ("out",), "lse": ("lse",)},
                          "dense_bwd": {"dq/dk/dv": ("dq", "dk", "dv")}}[family]
                worst = ", ".join(f"{label} {max(r[k] for r in rows for k in keys):.3e}"
                                  for label, keys in groups.items())
                print(f"{variant} ({family}): worst relative norm error of {worst}", flush=True)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
