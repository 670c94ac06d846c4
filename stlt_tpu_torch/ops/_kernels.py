"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C entry point. At first use it is compiled
by ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into
``stlt_tpu_torch/_build/`` (listed in ``.gitignore``) and loaded with
``ctypes``. The library's file name carries a hash of its sources, so an
edited source is rebuilt and a built one is reused. :func:`build_all` starts
one ``nvcc`` per source at once.

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

# C entry point and argument types of each kernel library.
SIGNATURES = {
    "fused_proj_attention": (
        "stlt_fused_proj_attention",
        # x, wqkv, bqkv, wo, bo, bias, bias_row_stride, bias_q_stride,
        # rows_live, out, rows, seq, hidden, num_heads, scale, dtype, stream
        [_P, _P, _P, _P, _P, _P, _LL, _LL, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    ),
    "fused_layer_tail": (
        "stlt_fused_layer_tail",
        # x, a, n1s, n1b, w1, b1, w2, b2, n2s, n2b, live, out,
        # tokens, hidden, ff, eps, act, dtype, stream
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
    ),
}

_libs: Dict[str, ctypes.CDLL] = {}


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


def build_all(verbose: bool = False) -> Dict[str, Path]:
    """Compile every kernel library that is not built yet, one ``nvcc`` per
    source, all started together. Returns {name: library path}; raises with
    the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _library_path(name) for name in SIGNATURES}
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
    """The loaded library of kernel ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        path = _library_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s C entry point; raise if it did not launch."""
    symbol, _ = SIGNATURES[name]
    err = getattr(library(name), symbol)(*args)
    if err == -1:
        raise ValueError(f"{name}: shape not supported by the CUDA kernel")
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
