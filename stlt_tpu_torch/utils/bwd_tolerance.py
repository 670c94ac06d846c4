"""Mutation check of the long-clip attention backwards' bf16 tolerance.

``chip_smoke.py`` holds the backward kernels' dq, dk and dv against
``attention_bwd_plain`` within a relative Frobenius-norm error (``BWD_REL``).
This script shows which faults that limit catches. It copies the package
into a temporary directory, edits the kernel sources there (the checkout is
never touched), builds the four long-clip attention kernels from each copy
and prints each variant's relative norm errors in bf16:

- ``sound``: the sources as they are;
- ``no_lo_split``: the tensor-core products of the probabilities and of dz
  (``attention_core.cuh::chunk_pv``) take only the bf16 hi part, not hi + lo;
- ``no_dsum``: dz = p o dp, without the ``- dsum`` term.

Run on a machine with one H100, ``nvcc`` and PyTorch for CUDA::

    python -m stlt_tpu_torch.utils.bwd_tolerance

The last line is one JSON object {variant: [{"T", "rate", "dq", "dk",
"dv"}, ...]}. The inputs (6 clips, 12 heads of 64, T = 257 on the short
kernel with a causal padding bias, T = 513 on the blockwise kernel in
lengths mode, dropout 0 and 0.1) are chip_smoke's check shapes; out and
lse come from the plain forward, so only the backward differs.
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
KERNELS = ("flash_attention", "blockwise_attention", "flash_attention_bwd", "blockwise_attention_bwd")
MUTATIONS = {
    "sound": [],
    "no_lo_split": [(
        "attention_core.cuh",
        "pl[r * kLDP + lane + 32 * j] = __float2bfloat16_rn(p[r][j] - __bfloat162float(hi));",
        "pl[r * kLDP + lane + 32 * j] = __float2bfloat16_rn(0.f);",
    )],
    "no_dsum": [
        ("attention_bwd_core.cuh", "expf(x - lse_t) * (d - ds);", "expf(x - lse_t) * d;"),
        ("attention_bwd_core.cuh", "pr * (dp[r][j] * keep - ds_j[j]);", "pr * (dp[r][j] * keep);"),
    ],
}


def _rel(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30)).item()


def measure() -> list:
    """Relative norm errors of both bf16 backward kernels against the plain
    version, with this interpreter's ``stlt_tpu_torch``."""
    from stlt_tpu_torch.ops import _kernels, flash

    _kernels.build_all(names=KERNELS)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this check runs the kernels on an H100", file=sys.stderr)
        return 1
    results = {}
    with tempfile.TemporaryDirectory(prefix="stlt_bwd_tolerance_") as root:
        procs = {}
        for variant, edits in MUTATIONS.items():
            top = Path(root) / variant
            shutil.copytree(_PKG, top / _PKG.name, ignore=shutil.ignore_patterns("_build", "__pycache__"))
            for source, old, new in edits:
                path = top / _PKG.name / "csrc" / source
                text = path.read_text()
                if old not in text:
                    raise RuntimeError(f"{variant}: {source} no longer holds {old!r}")
                path.write_text(text.replace(old, new))
            env = dict(os.environ, PYTHONPATH=str(top))
            procs[variant] = subprocess.Popen(
                [sys.executable, "-c", "import json; from stlt_tpu_torch.utils.bwd_tolerance "
                 "import measure; print(json.dumps(measure()))"],
                cwd=top, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for variant, proc in procs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"{variant} failed:\n{err[-4000:]}")
            results[variant] = json.loads(out.strip().splitlines()[-1])
            worst = max(max(r["dq"], r["dk"], r["dv"]) for r in results[variant])
            print(f"{variant}: worst relative norm error {worst:.3e}", flush=True)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
