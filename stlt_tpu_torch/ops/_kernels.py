"""Build and bind the port's hand-written CUDA kernels.

Each kernel has a plain C entry point in a source ``csrc/<source>.cu``
(``<source>`` is the kernel's name unless :data:`SOURCES` names another; the
three entry points of the train tail's backward share one). At first use a
source is compiled by ``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared`` into ``stlt_tpu_torch/_build/`` (listed in ``.gitignore``) and
loaded with ``ctypes``. The library's file name carries a hash of its
sources, so an edited source is rebuilt and a built one is reused.
:func:`build_all` starts one ``nvcc`` per source at once.

Nothing GPU-specific happens at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
_U = ctypes.c_uint

# C entry point and argument types of each kernel library.
SIGNATURES = {
    "fused_proj_attention": (
        "stlt_fused_proj_attention",
        # x, wqkv, bqkv, wo, bo, bias, bias_row_stride, bias_q_stride,
        # rows_live, out, rows, seq, hidden, num_heads, scale,
        # dropout, seed, thresh, dropout_scale, dtype, stream
        [_P, _P, _P, _P, _P, _P, _LL, _LL, _P, _P, _I, _I, _I, _I, _F, _I, _U, _U, _F, _I, _P],
    ),
    "fused_proj_attention_bwd": (
        "stlt_fused_proj_attention_bwd",
        # x, wqkv, bqkv, wot, bias, bias_row_stride, bias_q_stride, g,
        # rows_live, dqkv, attn, partial, partial_b, dwo, dbo, rows, seq,
        # hidden, num_heads, scale, dropout, seed, thresh, dropout_scale,
        # splits, chunk, dtype, stream
        [_P, _P, _P, _P, _P, _LL, _LL, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
         _I, _U, _U, _F, _I, _LL, _I, _P],
    ),
    "fused_layer_tail": (
        "stlt_fused_layer_tail",
        # x, a, n1s, n1b, w1, b1, w2, b2, n2s, n2b, live, out, r2 (null in
        # eval), tokens, hidden, ff, eps, act, dropout, seed, thresh,
        # dropout_scale, dtype, stream
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I,
         _I, _U, _U, _F, _I, _P],
    ),
    "fused_tail_train_bwd_row": (
        "stlt_tail_train_bwd_row",
        # r2, g, n2s, live, dr2, partial, out, tokens, hidden, eps, dropout,
        # seed, thresh, dropout_scale, blocks, chunk, dtype, stream
        [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _F, _I, _U, _U, _F, _I, _LL, _I, _P],
    ),
    "fused_tail_train_bwd_input": (
        "stlt_tail_train_bwd_input",
        # x, a, dr2, n1s, n1b, w1, b1, w1t, w2t, live, dx, dattn, u, dh2, dh1,
        # h1d, partial_ln, partial_b1, out, tokens, hidden, ff, eps, act,
        # dropout, seed, thresh, dropout_scale, rows_per_block, dtype, stream
        [*[_P] * 19, _LL, _I, _I, _F, _I, _I, _U, _U, _F, _I, _I, _P],
    ),
    "fused_tail_train_bwd_weight": (
        "stlt_tail_train_bwd_weight",
        # u, dh1, h1d, dh2, partial_b1, b1_parts, partial, out_w, db1, tokens,
        # chunk, splits, hidden, ff, dtype, stream
        [_P, _P, _P, _P, _P, _I, _P, _P, _P, _LL, _LL, _I, _I, _I, _I, _P],
    ),
    "fused_cross_attention": (
        "stlt_fused_cross_attention",
        # x, ctx, wq, bq, wkv, bkv, wo, bo, bias, bias_row_stride,
        # bias_q_stride, kv (scratch), out, rows, T, S, hidden, num_heads,
        # scale, dtype, stream
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
    ),
    "flash_attention": (
        "stlt_flash_attention",
        # q, k, v, their (b, t, n) strides, bias, its (b, n, t) strides, out,
        # lse (or null), B, T, S, N, D, scale, dropout, seed, thresh,
        # dropout_scale, dtype, stream
        [_P, _P, _P, *[_LL] * 9, _P, _LL, _LL, _LL, _P, _P, _I, _I, _I, _I, _I, _F,
         _I, _U, _U, _F, _I, _P],
    ),
    "blockwise_attention": (
        "stlt_blockwise_attention",
        # q, k, v, their (b, t, n) strides, bias (or null), its (b, n, t)
        # strides, lengths (or null), causal, out, lse, B, T, S, N, D, scale,
        # dropout, seed, thresh, dropout_scale, dtype, stream
        [_P, _P, _P, *[_LL] * 9, _P, _LL, _LL, _LL, _P, _I, _P, _P, _I, _I, _I, _I, _I, _F,
         _I, _U, _U, _F, _I, _P],
    ),
    "flash_attention_bwd": (
        "stlt_flash_attention_bwd",
        # q, k, v, dO, their (b, t, n) strides, bias, its (b, n, t) strides,
        # lse, dsum, dq, dk, dv, B, T, S, N, D, scale, dropout, seed, thresh,
        # dropout_scale, dtype, stream
        [_P, _P, _P, _P, *[_LL] * 12, _P, _LL, _LL, _LL, _P, _P, _P, _P, _P,
         _I, _I, _I, _I, _I, _F, _I, _U, _U, _F, _I, _P],
    ),
    "blockwise_attention_bwd": (
        "stlt_blockwise_attention_bwd",
        # q, k, v, dO, their (b, t, n) strides, bias (or null), its (b, n, t)
        # strides, lengths (or null), causal, lse, dsum, dq, dk, dv, B, T, S,
        # N, D, scale, dropout, seed, thresh, dropout_scale, dtype, stream
        [_P, _P, _P, _P, *[_LL] * 12, _P, _LL, _LL, _LL, _P, _I, _P, _P, _P, _P, _P,
         _I, _I, _I, _I, _I, _F, _I, _U, _U, _F, _I, _P],
    ),
}

# Kernels (by their launch-count names) whose entry point lives in another
# source than csrc/<name>.cu: the train variants share their eval sources, the
# blockwise forward's and backward's dense-bias modes their lengths modes'.
SOURCES = {
    "blockwise_attention_dense": "blockwise_attention",
    "blockwise_attention_bwd_dense": "blockwise_attention_bwd",
    "fused_proj_attention_train": "fused_proj_attention",
    "fused_proj_attention_train_bwd": "fused_proj_attention_bwd",
    "fused_layer_tail_train": "fused_layer_tail",
    "fused_tail_train_bwd_row": "fused_tail_train_bwd",
    "fused_tail_train_bwd_input": "fused_tail_train_bwd",
    "fused_tail_train_bwd_weight": "fused_tail_train_bwd",
}

_libs: Dict[str, ctypes.CDLL] = {}


def source(name: str) -> str:
    """The source stem (``csrc/<stem>.cu``) of kernel ``name``."""
    return SOURCES.get(name, name)


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built on a machine with the CUDA toolkit")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _nvcc_command(name: str, target: Path):
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC),
        "-o", str(target), str(CSRC / f"{name}.cu"),
    ]


def build_all(verbose: bool = False, names=None) -> Dict[str, Path]:
    """Compile the library of every kernel (or of those in ``names``) that is
    not built yet, one ``nvcc`` per source, all started together. Returns
    {source: library path}; raises with the compiler's output when a build
    fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src: _library_path(src) for src in dict.fromkeys(map(source, names or SIGNATURES))}
    procs = {}
    for name, target in targets.items():
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                _nvcc_command(name, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
            ),
            tmp,
        )
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name} (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, targets[name])
        if verbose:
            print(f"--- nvcc {name} ---\n{log}", flush=True)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use, with the
    argument types of every entry point it holds set."""
    src = source(name)
    lib = _libs.get(src)
    if lib is None:
        path = _library_path(src)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        for kernel, (symbol, argtypes) in SIGNATURES.items():
            if source(kernel) == src:
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _libs[src] = lib
    return lib


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s C entry point; raise if it did not launch."""
    symbol, _ = SIGNATURES[name]
    err = getattr(library(name), symbol)(*args)
    if err == -1:
        raise ValueError(f"{name}: shape not supported by the CUDA kernel")
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
