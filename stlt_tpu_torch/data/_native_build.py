"""g++ build and load of the port's C++ host stages (``native/*.cpp``).

After ``stlt_tpu/data/_native_build.py``, with three differences:

- the library is built into ``stlt_tpu_torch/_build/`` (listed in
  ``.gitignore``) under a name that carries a hash of the source, the flags,
  the compiler's version and what ``-march=native`` means on this host, so an
  edited source is rebuilt, a built one reused, and a library built on
  another machine (a copied checkout) is never loaded here;
- a compile writes a file of its own (process and thread in its name) and
  publishes it with ``os.replace``, so loader threads, xdist workers and
  ranks that build at once each see a whole library;
- a failed build raises with the compiler's stderr: there is no Python or
  PIL fallback for a caller to route around.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-march=native")
COMPILER = "g++"


@functools.lru_cache(maxsize=None)
def _host_target() -> bytes:
    """The compiler's version and its target options under ``-march=native``
    on this host: part of the library's key."""
    try:
        version = subprocess.run([COMPILER, "--version"], capture_output=True, check=True).stdout
        target = subprocess.run([COMPILER, "-march=native", "-Q", "--help=target"],
                                capture_output=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        raise RuntimeError(f"cannot run {COMPILER} to build the native host stages: {e}") from e
    return version + target


def library_path(src, name: str, extra_flags: Sequence[str] = (), build_dir=BUILD_DIR) -> Path:
    """Where the library of ``src`` built with ``extra_flags`` lives."""
    key = hashlib.sha256()
    key.update(Path(src).read_bytes())
    key.update("\0".join(FLAGS + tuple(extra_flags)).encode())
    key.update(_host_target())
    return Path(build_dir) / f"{name}-{key.hexdigest()[:16]}.so"


def build_shared_library(src, name: str, extra_flags: Sequence[str] = (), *,
                         build_dir=BUILD_DIR, force: bool = False) -> Path:
    """Compile ``src`` unless its library is built; returns the library's
    path. Raises ``RuntimeError`` with the compiler's stderr on a failed
    build."""
    lib = library_path(src, name, extra_flags, build_dir)
    if lib.exists() and not force:
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.build.{os.getpid()}.{threading.get_ident()}")
    cmd = [COMPILER, *FLAGS, str(src), "-o", str(tmp), *extra_flags]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{COMPILER} failed to build {src} (exit {proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return lib


def load_shared_library(src, name: str, extra_flags: Sequence[str] = (), *,
                        build_dir=BUILD_DIR) -> ctypes.CDLL:
    """Build ``src`` if needed and load it."""
    return ctypes.CDLL(str(build_shared_library(src, name, extra_flags, build_dir=build_dir)))
