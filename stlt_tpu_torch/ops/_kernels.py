"""Build and bind the port's hand-written CUDA kernels.

Each kernel has a plain C entry point in a source ``csrc/<source>.cu``
(``<source>`` is the kernel's name unless :data:`SOURCES` names another; the
three entry points of the train tail's backward share one). At first use a
source is compiled by ``nvcc -gencode arch=compute_90a,code=sm_90a -O3
--split-compile=0 -shared`` (its kernels optimised on every core: the
width-templated sources hold dozens) into ``stlt_tpu_torch/_build/``
(listed in ``.gitignore``) and
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
        # x, wqkv, bqkv, wo, bo (f32: wqkv [H, 3H], wo [H, H]; bf16: as the
        # model stores them, [3H, H] and [H, H]), bias, bias_row_stride,
        # bias_q_stride, rows_live, out, scratch (bf16: qkv, o and the
        # packed rows; null in f32), rows, seq, hidden, num_heads, scale,
        # dropout, seed, thresh, dropout_scale, the rows' map (row_base,
        # row_period, row_stride, row_magic: common.cuh RowMap), dtype, stream
        [_P, _P, _P, _P, _P, _P, _LL, _LL, _P, _P, _P, _I, _I, _I, _I, _F, _I, _U, _U, _F, _U, _U,
         _U, _U, _I, _P],
    ),
    "fused_proj_attention_bwd": (
        "stlt_fused_proj_attention_bwd",
        # x, wqkv (f32: [H, 3Hq]; bf16: as the model stores it, [3Hq, H]),
        # bqkv, wo (out_proj.weight [H_out, Hq] in both), bias,
        # bias_row_stride, bias_q_stride, g, rows_live, dqkv, scratch (f32:
        # the attention output; bf16: the packed x/attn, g, qkv, do and
        # rows), partial [splits, Hq, H], partial_b [splits, H] (f32; in bf16
        # views of the scratch), dwo, dbo, rows, seq, hidden, inner (Hq: H in
        # one process, a model rank's q/k/v width), num_heads, scale,
        # dropout, seed, thresh, dropout_scale, the rows' map (row_base,
        # row_period, row_stride, row_magic), head0, heads (the launch's
        # first head and the whole N: 0 and num_heads in one process),
        # splits, chunk, dtype, stream
        [_P, _P, _P, _P, _P, _LL, _LL, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
         _I, _U, _U, _F, _U, _U, _U, _U, _U, _U, _I, _LL, _I, _P],
    ),
    "fused_layer_tail": (
        "stlt_fused_layer_tail",
        # x, a, n1s, n1b, w1 (stored [FF, H]), b1, w2 (stored [H, FF]), b2,
        # n2s, n2b, live, out, r2 (null in eval), scratch (bf16: u and h1;
        # null in f32), tokens, hidden, ff, eps, act, dropout, seed, thresh,
        # dropout_scale, the tokens' map (token_base, token_period,
        # token_stride, token_magic), dtype, stream
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I,
         _I, _U, _U, _F, _LL, _U, _U, _U, _I, _P],
    ),
    "fused_tail_train_bwd_row": (
        "stlt_tail_train_bwd_row",
        # r2, g, n2s, live, dr2, partial, out, tokens, hidden, eps, dropout,
        # seed, thresh, dropout_scale, the tokens' map, blocks, chunk,
        # dtype, stream
        [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _F, _I, _U, _U, _F, _LL, _U, _U, _U, _I, _LL, _I, _P],
    ),
    "fused_tail_train_bwd_input": (
        "stlt_tail_train_bwd_input",
        # x, a, dr2, n1s, n1b, w1 (stored [FF, H]), b1, w2 (W2^T stored
        # [H, FF]), live, dx, dattn, u, dh2, dh1, h1d, du (bf16), rows (bf16),
        # partial_ln, partial_b1, out, tokens, hidden, ff, eps, act, dropout,
        # seed, thresh, dropout_scale, the tokens' map, blocks, dtype, stream
        [*[_P] * 20, _LL, _I, _I, _F, _I, _I, _U, _U, _F, _LL, _U, _U, _U, _I, _I, _P],
    ),
    "fused_tail_train_bwd_weight": (
        "stlt_tail_train_bwd_weight",
        # u, dh1, h1d, dh2, count (bf16 with live flags), partial_b1,
        # b1_parts, partial, out_w, db1, tokens, chunk, splits, hidden, ff,
        # dtype, stream
        [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _LL, _LL, _I, _I, _I, _I, _P],
    ),
    "fused_cross_attention": (
        "stlt_fused_cross_attention",
        # x, ctx, wq, bq, wkv, bkv, wo, bo (f32: input-major; bf16: as the
        # model stores them, [N, K]), bias, bias_row_stride, bias_q_stride,
        # scratch (f32: kv; bf16: q, kv and o), out, rows, T, S, hidden,
        # num_heads, scale, dtype, stream
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
    ),
    # The model axis's partial modes (rows 1, 2 and 5) and their sum
    # epilogues, in the rows' own sources.
    "fused_proj_attention_partial": (
        "stlt_fused_proj_attention_partial",
        # x, wqkv, bqkv, wo (f32: [H, 3Hq], [Hq, H]; bf16: as stored, [3Hq, H],
        # [H, Hq]), bias, bias_row_stride, bias_q_stride, rows_live, out (f32
        # partial), scratch, rows, seq, hidden, inner (Hq), num_heads, scale,
        # dropout, seed, thresh, dropout_scale, the rows' map (4 words),
        # head0, heads (the rank's first head and the whole N), dtype, stream
        [_P, _P, _P, _P, _P, _LL, _LL, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _U, _U, _F, _U, _U, _U,
         _U, _U, _U, _I, _P],
    ),
    "fused_proj_attention_sum": (
        "stlt_fused_proj_attention_sum",
        # s (f32 sums), bo, rows_live, out, rows, seq, hidden, dtype, stream
        [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    ),
    "fused_cross_attention_partial": (
        "stlt_fused_cross_attention_partial",
        # x, ctx, wq, bq, wkv, bkv, wo, bias, bias_row_stride, bias_q_stride,
        # scratch, out (f32 partial), rows, T, S, hidden, inner (Hq),
        # num_heads, scale, dtype, stream
        [_P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    ),
    "fused_cross_attention_sum": (
        "stlt_fused_cross_attention_sum",
        [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    ),
    "fused_layer_tail_partial": (
        "stlt_fused_layer_tail_partial",
        # x, a, n1s, n1b, w1 (stored [FF/M, H]), b1, w2 (stored [H, FF/M]),
        # live, out (f32 partial), scratch (u's home), tokens, hidden, ff,
        # eps, act, dtype, stream
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
    ),
    "fused_layer_tail_sum": (
        "stlt_fused_layer_tail_sum",
        # s (f32 sums), u, b2, n2s, n2b, live, out, tokens, hidden, eps,
        # dtype, stream
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P],
    ),
    "flash_attention": (
        "stlt_flash_attention",
        # q, k, v, their (b, t, n) strides, bias, its (b, n, t) strides, out,
        # lse (or null), B, T, S, N, D, scale, dropout, seed, thresh,
        # dropout_scale, row_base, head0, heads (the launch's first head and
        # the whole N), mask (or null), its (b, n, t) strides, dtype, stream
        [_P, _P, _P, *[_LL] * 9, _P, _LL, _LL, _LL, _P, _P, _I, _I, _I, _I, _I, _F,
         _I, _U, _U, _F, _U, _U, _U, _P, _LL, _LL, _LL, _I, _P],
    ),
    "blockwise_attention": (
        "stlt_blockwise_attention",
        # q, k, v, their (b, t, n) strides, bias (or null), its (b, n, t)
        # strides, lengths (or null), causal, row0, col0 (ring offsets), out,
        # lse, B, T, S, N, D, scale, dropout, seed, thresh, dropout_scale,
        # row_base, mask (or null), its (b, n, t) strides, dtype, stream
        [_P, _P, _P, *[_LL] * 9, _P, _LL, _LL, _LL, _P, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I,
         _F, _I, _U, _U, _F, _U, _P, _LL, _LL, _LL, _I, _P],
    ),
    "flash_attention_bwd": (
        "stlt_flash_attention_bwd",
        # q, k, v, dO, their (b, t, n) strides, bias, its (b, n, t) strides,
        # lse, dsum, dq, dk, dv, B, T, S, N, D, scale, dropout, seed, thresh,
        # dropout_scale, row_base, head0, heads, mask (or null), its (b, n, t)
        # strides, dtype, stream
        [_P, _P, _P, _P, *[_LL] * 12, _P, _LL, _LL, _LL, _P, _P, _P, _P, _P,
         _I, _I, _I, _I, _I, _F, _I, _U, _U, _F, _U, _U, _U, _P, _LL, _LL, _LL, _I, _P],
    ),
    "blockwise_attention_bwd": (
        "stlt_blockwise_attention_bwd",
        # q, k, v, dO, their (b, t, n) strides, bias (or null), its (b, n, t)
        # strides, lengths (or null), causal, row0, col0 (ring offsets), lse,
        # dsum, dq, dk, dv, B, T, S, N, D, scale, dropout, seed, thresh,
        # dropout_scale, row_base, mask (or null), its (b, n, t) strides,
        # dtype, stream
        [_P, _P, _P, _P, *[_LL] * 12, _P, _LL, _LL, _LL, _P, _I, _I, _I, _P, _P, _P, _P, _P,
         _I, _I, _I, _I, _I, _F, _I, _U, _U, _F, _U, _P, _LL, _LL, _LL, _I, _P],
    ),
}

# Kernels (by their launch-count names) whose entry point lives in another
# source than csrc/<name>.cu: the train variants and the model axis's partial
# modes and sum epilogues share their eval sources, the
# blockwise forward's and backward's dense-bias and ring-offset modes their
# lengths modes', and the attention kernels' mask modes their own sources.
SOURCES = {
    "flash_attention_mask": "flash_attention",
    "flash_attention_bwd_mask": "flash_attention_bwd",
    "blockwise_attention_mask": "blockwise_attention",
    "blockwise_attention_bwd_mask": "blockwise_attention_bwd",
    "blockwise_attention_dense": "blockwise_attention",
    "blockwise_attention_offsets": "blockwise_attention",
    "blockwise_attention_bwd_dense": "blockwise_attention_bwd",
    "blockwise_attention_bwd_offsets": "blockwise_attention_bwd",
    "fused_proj_attention_train": "fused_proj_attention",
    "fused_proj_attention_train_bwd": "fused_proj_attention_bwd",
    "fused_layer_tail_train": "fused_layer_tail",
    "fused_proj_attention_partial": "fused_proj_attention",
    "fused_proj_attention_sum": "fused_proj_attention",
    "fused_cross_attention_partial": "fused_cross_attention",
    "fused_cross_attention_sum": "fused_cross_attention",
    "fused_layer_tail_partial": "fused_layer_tail",
    "fused_layer_tail_sum": "fused_layer_tail",
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
        "--split-compile=0",
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
    """Call kernel ``name``'s C entry point; raise if it did not launch (or
    was given another count of arguments than its signature's: ctypes would
    pass them unchecked)."""
    symbol, argtypes = SIGNATURES[name]
    if len(args) != len(argtypes):
        raise TypeError(f"{name}: {len(args)} arguments for the {len(argtypes)} of {symbol}")
    err = getattr(library(name), symbol)(*args)
    if err == -1:
        raise ValueError(f"{name}: shape not supported by the CUDA kernel")
    if err == -3:
        raise RuntimeError(f"{name}: the TMA cannot map an operand (its base or strides); nothing launched")
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
