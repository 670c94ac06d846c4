"""The C++ JPEG stage (``native/jpeg_pipeline.cpp``): decode, resize and
colour jitter of the appearance frames, behind ``--native_decode``.

Own copy of ``stlt_tpu/data/native_jpeg.py``. The decode runs on the
system's libjpeg (optionally DCT-scaled, PIL's draft decode under
``--fast_decode``); the resize reimplements Pillow's fixed-point bilinear
resampler and the jitter Pillow's ``ImageEnhance`` and HSV chain, both bit
for bit. The decode equals PIL's where PIL's libjpeg is the system's.

The library is built with g++ and ``-ljpeg`` at first use
(``data/_native_build.py``). Where it does not build (no ``jpeglib.h`` or
no ``libjpeg``) :func:`load_library` raises with the compiler's words: the
port has no PIL route under ``--native_decode``. A frame the stage cannot
decode returns ``None`` from :func:`decode_resize`, for its caller to name.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from stlt_tpu_torch.data._native_build import load_shared_library

SRC = Path(__file__).resolve().parents[1] / "native" / "jpeg_pipeline.cpp"
LINK = ("-ljpeg",)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_IP = ctypes.POINTER(ctypes.c_int)

_lib = None
_lib_lock = threading.Lock()


def load_library() -> ctypes.CDLL:
    """The JPEG stage's library, built at first use; raises if it does not
    build (the compiler's stderr in the message)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = load_shared_library(SRC, "jpeg_pipeline", LINK)
            I, F, S = ctypes.c_int, ctypes.c_float, ctypes.c_size_t
            lib.jp_probe.restype = I
            lib.jp_probe.argtypes = [_U8P, S, I, I, _IP, _IP]
            lib.jp_decode_resize.restype = I
            lib.jp_decode_resize.argtypes = [_U8P, S, I, I, _U8P, I, I]
            lib.jp_resize_rgb.restype = I
            lib.jp_resize_rgb.argtypes = [_U8P, I, I, _U8P, I, I]
            lib.jp_jitter_rgb.restype = I
            # image, width, height, the four ops' order, brightness, contrast,
            # saturation, the hue shift and whether to apply it
            lib.jp_jitter_rgb.argtypes = [_U8P, I, I, _IP, F, F, F, I, I]
            _lib = lib
        return _lib


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(_U8P)


def decode_resize(jpeg_bytes: bytes, target_short: int, *, draft: bool = False
                  ) -> Optional[np.ndarray]:
    """JPEG bytes to a uint8 ``[H, W, 3]`` array whose shorter side is
    ``target_short``, as PIL's decode then ``resize_shorter_side``;
    ``draft`` decodes DCT-scaled as PIL's ``draft`` (``--fast_decode``).
    ``None`` for bytes the stage cannot decode."""
    lib = load_library()
    buf = np.frombuffer(jpeg_bytes, dtype=np.uint8)
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    if lib.jp_probe(_u8(buf), buf.size, target_short, int(draft), ctypes.byref(w),
                    ctypes.byref(h)) != 0:
        return None
    out = np.empty((h.value, w.value, 3), dtype=np.uint8)
    if lib.jp_decode_resize(_u8(buf), buf.size, target_short, int(draft), _u8(out), w.value,
                            h.value) != 0:
        return None
    return out


def jitter_rgb(image: np.ndarray, jitter) -> None:
    """Apply a ``transforms.VideoColorJitter``'s draw to a C-contiguous
    uint8 ``[H, W, 3]`` array in place, bit for bit the PIL op chain."""
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3 or (
            not image.flags.c_contiguous):
        raise ValueError(f"jitter_rgb takes a C-contiguous uint8 [H, W, 3] array, got "
                         f"{image.dtype} {image.shape}")
    order = (ctypes.c_int * 4)(*[int(o) for o in jitter.order])
    rc = load_library().jp_jitter_rgb(
        _u8(image), image.shape[1], image.shape[0], order, jitter.brightness, jitter.contrast,
        jitter.saturation, int(round(jitter.hue * 255)), int(abs(jitter.hue) >= 1e-9))
    if rc != 0:
        raise ValueError(f"the native colour jitter refused the draw (code {rc}): order "
                         f"{list(jitter.order)}")


def resize_rgb(image: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """Pillow's bilinear ``resize`` of a uint8 ``[H, W, 3]`` array, bit for
    bit."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"resize_rgb takes a uint8 [H, W, 3] array, got {image.shape}")
    out = np.empty((out_h, out_w, 3), dtype=np.uint8)
    rc = load_library().jp_resize_rgb(_u8(image), image.shape[1], image.shape[0], _u8(out),
                                      out_w, out_h)
    if rc != 0:
        raise ValueError(f"resize_rgb cannot resize {image.shape[:2]} to {(out_h, out_w)}")
    return out
