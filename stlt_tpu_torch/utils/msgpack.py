"""flax's ``.msgpack`` checkpoint format, read and written with the standard
library, numpy and torch (no ``msgpack``, no ``flax``).

The JAX package saves a parameter tree with ``flax.serialization.to_bytes``,
that is ``msgpack_serialize`` (``flax/serialization.py``): a msgpack map of
maps whose leaves are ext types,

- code 1, an array: the payload is itself msgpack, the array ``(shape,
  dtype name, C-order bytes)``;
- code 3, a numpy scalar: the same payload for a 0-d array;

and whose arrays over ``MAX_CHUNK_SIZE`` bytes are split into a map
``{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks": {"0":
flat part, ...}}``. :func:`restore` and :func:`serialize` cover exactly
that: maps, str, bin, arrays, ints, floats, bool and nil, ext codes 1 and 3
and the chunked leaves. Every array leaf is read as a CPU torch tensor, a
``bfloat16`` one by its name (the raw bytes as 16-bit words, viewed as
``torch.bfloat16``); a numpy scalar as a 0-d tensor. The writer takes torch
tensors and numpy arrays and picks msgpack's smallest encoding of every
item, as the ``msgpack`` package does. An ext code, dtype or msgpack type
outside the format raises ``ValueError``.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
CHUNKED = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2 ** 30

# The dtype names flax writes (numpy's ``dtype.name``) and their torch dtypes.
DTYPES = {
    "float32": torch.float32, "float64": torch.float64, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "uint8": torch.uint8, "uint16": torch.uint16,
    "uint32": torch.uint32, "uint64": torch.uint64, "bool": torch.bool,
    "complex64": torch.complex64, "complex128": torch.complex128,
}
_NAMES = {dtype: name for name, dtype in DTYPES.items()}


# --- reading ------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: the data ends inside an item")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def item(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
                 0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
                 0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
                 0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
                 0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
        if b in sized:
            kind, fmt = sized[b]
            return getattr(self, kind)(self.unpack(fmt))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f"msgpack: type byte 0x{b:02x} is not in flax's checkpoint format")

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            key = self.item()
            out[key] = self.item()
        return out

    def array(self, n: int) -> list:
        return [self.item() for _ in range(n)]

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def bin(self, n: int) -> bytes:
        return bytes(self.take(n))

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = self.take(n)
        if code == EXT_NDARRAY:
            return _array_from_bytes(payload)
        if code == EXT_NPSCALAR:
            return _array_from_bytes(payload).reshape(())
        raise ValueError(f"msgpack: ext code {code} is not in flax's checkpoint format "
                         f"(1: an array, 3: a numpy scalar)")


def unpackb(data: bytes) -> Any:
    """One msgpack item of ``data``, ext codes 1 and 3 as tensors; trailing
    bytes raise."""
    reader = _Reader(data)
    out = reader.item()
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} bytes after the item")
    return out


def _array_from_bytes(payload) -> torch.Tensor:
    shape, name, buffer = unpackb(payload)
    if isinstance(name, bytes):
        name = name.decode("ascii")
    if name not in DTYPES:
        raise ValueError(f"msgpack: array dtype {name!r} is not one the port reads "
                         f"({sorted(DTYPES)})")
    dtype = DTYPES[name]
    if dtype == torch.bfloat16:
        words = np.frombuffer(buffer, dtype=np.uint16).copy()
        flat = torch.from_numpy(words).view(torch.bfloat16)
    else:
        flat = torch.from_numpy(np.frombuffer(buffer, dtype=np.dtype(name)).copy())
    return flat.reshape(tuple(shape))


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def restore(data: bytes) -> Any:
    """The tree of a flax ``.msgpack`` file's bytes (``msgpack_restore``):
    nested dicts with CPU tensor leaves, chunked arrays joined."""
    return _unchunk(unpackb(data))


def read(path: str) -> Any:
    """:func:`restore` of the file at ``path``."""
    with open(path, "rb") as f:
        return restore(f.read())


# --- writing ------------------------------------------------------------------


def _header(n: int, fix: Tuple[int, int], sizes) -> bytes:
    """The header of an item of length ``n``: the fix form (base byte, limit)
    where it fits, else the first of ``sizes`` ((byte, struct format,
    limit), ...) that holds ``n``."""
    base, limit = fix
    if base is not None and n < limit:
        return bytes([base | n])
    for byte, fmt, most in sizes:
        if n < most:
            return bytes([byte]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: an item of length {n} is too long")


_U8, _U16, _U32 = 2 ** 8, 2 ** 16, 2 ** 32


def _pack_int(x: int) -> bytes:
    if 0 <= x < 0x80 or -32 <= x < 0:
        return struct.pack(">b" if x < 0 else ">B", x)
    if x >= 0:
        for byte, fmt, most in ((0xCC, ">B", _U8), (0xCD, ">H", _U16), (0xCE, ">I", _U32),
                                (0xCF, ">Q", 2 ** 64)):
            if x < most:
                return bytes([byte]) + struct.pack(fmt, x)
    else:
        for byte, fmt, least in ((0xD0, ">b", -2 ** 7), (0xD1, ">h", -2 ** 15),
                                 (0xD2, ">i", -2 ** 31), (0xD3, ">q", -2 ** 63)):
            if x >= least:
                return bytes([byte]) + struct.pack(fmt, x)
    raise ValueError(f"msgpack: integer {x} does not fit 64 bits")


def _pack_str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _header(len(raw), (0xA0, 32), ((0xD9, ">B", _U8), (0xDA, ">H", _U16),
                                          (0xDB, ">I", _U32))) + raw


def _pack_bin(b: bytes) -> bytes:
    return _header(len(b), (None, 0), ((0xC4, ">B", _U8), (0xC5, ">H", _U16),
                                       (0xC6, ">I", _U32))) + b


def _pack_ext(code: int, payload: bytes) -> bytes:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(payload)
    if n in fixext:
        head = bytes([fixext[n]])
    else:
        head = _header(n, (None, 0), ((0xC7, ">B", _U8), (0xC8, ">H", _U16), (0xC9, ">I", _U32)))
    return head + struct.pack(">b", code) + payload


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous()
    arr = np.array(x, order="C")
    if arr.dtype.name == "bfloat16":  # an ml_dtypes array (a JAX leaf)
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _array_payload(t: torch.Tensor) -> bytes:
    if t.dtype not in _NAMES:
        raise ValueError(f"msgpack: cannot write a {t.dtype} array")
    words = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return packb([list(t.shape), _NAMES[t.dtype], words.numpy().tobytes()])


def packb(obj: Any) -> bytes:
    """msgpack bytes of ``obj``: dict (str keys), list/tuple, str, bytes,
    bool, None, int, float, and tensor/ndarray leaves as ext code 1 (a numpy
    scalar as ext code 3)."""
    parts = []
    _pack_into(obj, parts)
    return b"".join(parts)


def _pack_into(obj: Any, parts: list) -> None:
    if obj is None:
        parts.append(b"\xc0")
    elif isinstance(obj, bool):
        parts.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        parts.append(_pack_int(obj))
    elif isinstance(obj, float):
        parts.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        parts.append(_pack_str(obj))
    elif isinstance(obj, (bytes, bytearray)):
        parts.append(_pack_bin(bytes(obj)))
    elif isinstance(obj, Mapping):
        parts.append(_header(len(obj), (0x80, 16), ((0xDE, ">H", _U16), (0xDF, ">I", _U32))))
        for key, value in obj.items():
            _pack_into(key, parts)
            _pack_into(value, parts)
    elif isinstance(obj, (list, tuple)):
        parts.append(_header(len(obj), (0x90, 16), ((0xDC, ">H", _U16), (0xDD, ">I", _U32))))
        for value in obj:
            _pack_into(value, parts)
    elif isinstance(obj, np.generic):
        parts.append(_pack_ext(EXT_NPSCALAR, _array_payload(_as_tensor(np.asarray(obj)))))
    elif isinstance(obj, (torch.Tensor, np.ndarray)):
        parts.append(_pack_ext(EXT_NDARRAY, _array_payload(_as_tensor(obj))))
    else:
        raise ValueError(f"msgpack: cannot write a {type(obj).__name__}")


def _chunk(tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: _chunk(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        t = _as_tensor(tree)
        if t.numel() * t.element_size() > MAX_CHUNK_SIZE:
            size = max(1, MAX_CHUNK_SIZE // t.element_size())
            flat = t.reshape(-1)
            return {CHUNKED: True,
                    "shape": {str(i): d for i, d in enumerate(t.shape)},
                    "chunks": {str(i): flat[j:j + size]
                               for i, j in enumerate(range(0, flat.numel(), size))}}
    return tree


def serialize(tree: Any) -> bytes:
    """flax ``msgpack_serialize`` bytes of ``tree`` (nested dicts of
    tensors or arrays): each map's keys sorted, as flax's copy of the tree
    (``jax.tree_util.tree_map``) sorts them, arrays over MAX_CHUNK_SIZE
    bytes chunked."""
    return packb(_chunk(tree))


def write(path: str, tree: Any) -> None:
    """:func:`serialize` ``tree`` into the file at ``path``, through a
    temporary file and ``os.replace``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(serialize(tree))
    os.replace(tmp, path)
