"""Counter-hashed dropout keep bits, bit for bit those of the JAX package.

Own copy of ``stlt_tpu/ops/flash.py`` (``_lowbias32`` :72,
``_dropout_thresh`` :81, ``_keep_block`` :87, ``hash_keep_mask`` :100) and
``stlt_tpu/ops/fused_tail_train.py`` (``TAG_*`` :90-92, ``_keep_rows`` :97,
``hash_keep_rows`` :109).

A keep bit is ``lowbias32(counter ^ lane) >= thresh`` with
``thresh = min(round(rate * 2**32), 2**32 - 1)``, all arithmetic mod 2**32:

- attention probabilities: lane ``lowbias32((b * N + n) ^ seed)`` for the
  global row ``b`` and the global head ``n`` of the N, counter ``t * S +
  s`` with the unpadded key count ``S`` (a model rank's N / M heads are
  heads ``n0 + n`` of the N, ``n0 = m N / M``: JAX's ``_keep_block_heads``);
- the layer tail's three sites: lane ``lowbias32(seed ^ tag)``, counter
  ``token * width + feature`` over the whole width (a model rank's FF / M
  hidden units are features ``f0 + c`` of the FF, ``f0 = m FF / M``).

The CUDA kernels hash the same bits in place (``csrc/common.cuh``). Here the
arithmetic runs in int64 masked to 32 bits after every multiply and xor
(torch's uint32 has no shifts on the CPU); a product of two 32-bit values
may pass 2**63 and wrap, which keeps its low 32 bits. The seed and the
lanes that depend on it alone stay Python ints, kernel arguments of the
tensor ops: no host-to-device copy, so a train step hashing its dropout
bits on the card never waits for it. The keep functions take
row and feature offsets, so a counter past 2**32 can be reached without a
tensor of 2**32 elements.

The global row (or token) of a local index i is a :class:`RowMap`:
``g(i) = (i // period) * stride + offset + i % period``. The affine map
(``period`` 0, or ``period == stride``) is ``offset + i``: a data rank's
contiguous rows of the global batch. A context rank of a C-ring holds t of
each clip's F frames, so its frame rows take ``period`` t and ``stride`` F
(``parallel/mesh.frame_rows``). Every keep function takes an int offset or
a map.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

MASK32 = 0xFFFFFFFF

# Stream tags of the tail's three dropout sites (fused_tail_train.py:90-92).
TAG_ATTN_DROP = 0x9E3779B9
TAG_MID_DROP = 0x85EBCA6B
TAG_OUT_DROP = 0xC2B2AE35


class RowMap(NamedTuple):
    """The global index ``g(i) = (i // period) * stride + offset + i % period``
    of a launch's local row (or token) i; ``period`` 0 is the affine map
    ``offset + i``."""

    offset: int = 0
    period: int = 0
    stride: int = 0

    @staticmethod
    def of(base: "Union[int, RowMap]") -> "RowMap":
        """A map as it is, an int ``base`` as the affine map from it."""
        return base if isinstance(base, RowMap) else RowMap(int(base))

    @property
    def affine(self) -> bool:
        return self.period in (0, self.stride)

    def rows(self, n: int, device=None) -> torch.Tensor:
        """g(i) for i < n, int64."""
        i = torch.arange(n, dtype=torch.int64, device=device)
        if self.affine:
            return i + self.offset
        frames = torch.div(i, self.period, rounding_mode="floor")
        return frames * self.stride + self.offset + i % self.period

    def scaled(self, k: int) -> "RowMap":
        """The map of the indices when each row holds k consecutive ones (a
        row's tokens): g'(r k + j) = g(r) k + j."""
        return RowMap(self.offset * k, self.period * k, self.stride * k)

    def kernel_args(self):
        """(base, period, stride, magic) of the CUDA kernels' map
        (``csrc/common.cuh::RowMap``): base and stride mod 2**32 where the
        counter wraps; the affine map as period = stride = 2**31, past any
        local index (the quotient is then 0); magic = ceil(2**(31 + l) /
        period) with l = ceil(log2 period), so that i // period is
        (i * magic) >> (31 + l) for every i < 2**31 (Granlund-Montgomery:
        magic * period - 2**(31 + l) < period <= 2**l)."""
        period, stride = (AFFINE_PERIOD, AFFINE_PERIOD) if self.affine else (self.period, self.stride)
        if not 0 < period <= AFFINE_PERIOD:
            raise ValueError(f"a row map's period must lie in [1, 2**31], got {period}")
        shift = 31 + (period - 1).bit_length()
        return self.offset & MASK32, int(period), stride & MASK32, -(-(1 << shift) // period)


# The kernels' period of an affine map (csrc/common.cuh::RowMap).
AFFINE_PERIOD = 2 ** 31

# A global index argument: an int offset (the affine map) or a RowMap.
Rows = Union[int, RowMap]


def lowbias32(x: torch.Tensor) -> torch.Tensor:
    """The lowbias32 mix of int64 values holding uint32s."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & MASK32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & MASK32
    return x ^ (x >> 16)


def dropout_thresh(rate: float) -> int:
    return min(int(round(rate * 2.0 ** 32)), 2 ** 32 - 1)


def keep_block(seed: int, b0: Rows, n: int, t0: int, s0: int, shape,
               num_heads: int, s_total: int, thresh: int, device=None) -> torch.Tensor:
    """Keep bits [rb, tb, sb] (bool) of head ``n`` for global offsets
    ``(b0, t0, s0)`` (``b0`` an offset or the rows' map): ``_keep_block``."""
    rb, tb, sb = shape
    b = RowMap.of(b0).rows(rb, device)[:, None, None]
    t = torch.arange(tb, dtype=torch.int64, device=device)[None, :, None] + t0
    s = torch.arange(sb, dtype=torch.int64, device=device)[None, None, :] + s0
    lane = lowbias32((((b & MASK32) * num_heads + n) & MASK32) ^ (int(seed) & MASK32))
    ctr = (((t & MASK32) * s_total) + s) & MASK32
    return lowbias32(ctr ^ lane) >= thresh


def hash_keep_mask(seed: int, B: int, N: int, T: int, S: int, rate: float,
                   device=None, b0: Rows = 0, n0: int = 0,
                   heads: Optional[int] = None) -> torch.Tensor:
    """Keep bits [B, N, T, S] (bool) of the attention-probability dropout:
    ``hash_keep_mask``; with ``b0`` the rows [b0, b0 + B) of a batch's
    bits (``hash_keep_mask(seed, b0 + B, ...)[b0:]``), with a map the rows
    g(0), ..., g(B - 1); with ``n0`` and ``heads`` (the whole N, default N)
    the heads [n0, n0 + N) of the ``heads`` (``hash_keep_mask(seed, B,
    heads, ...)[:, n0:n0 + N]``): a model rank's heads."""
    heads = N if heads is None else heads
    if not 0 <= n0 <= heads - N:
        raise ValueError(f"heads [{n0}, {n0 + N}) do not lie in the {heads}")
    thresh = dropout_thresh(rate)
    return torch.stack(
        [keep_block(seed, b0, n0 + n, 0, 0, (B, T, S), heads, S, thresh, device) for n in range(N)], dim=1
    )


def keep_rows(seed: int, tag: int, r0: Rows, f0: int, shape, width: int,
              thresh: int, device=None) -> torch.Tensor:
    """Keep bits [rows, fw] (bool) of one tail stream for global token rows
    from ``r0`` (or the tokens' map) and features from ``f0``:
    ``_keep_rows``."""
    rows, fw = shape
    r = RowMap.of(r0).rows(rows, device)[:, None]
    f = torch.arange(fw, dtype=torch.int64, device=device)[None, :] + f0
    lane = lowbias32((int(seed) & MASK32) ^ (tag & MASK32))  # a Python int
    ctr = (((r & MASK32) * width) + f) & MASK32
    return lowbias32(ctr ^ lane) >= thresh


def hash_keep_rows(seed: int, tag: int, rows: int, width: int, rate: float,
                   device=None, r0: Rows = 0) -> torch.Tensor:
    """Keep bits [rows, width] (bool) of one tail stream: ``hash_keep_rows``;
    with ``r0`` the token rows [r0, r0 + rows) of a batch's bits, with a
    map the token rows g(0), ..., g(rows - 1)."""
    return keep_rows(seed, tag, r0, 0, (rows, width), width, dropout_thresh(rate), device)


def hashed_dropout(v: torch.Tensor, seed: int, tag: int, rate: float,
                   token0: Rows = 0, f0: int = 0, width: Optional[int] = None) -> torch.Tensor:
    """One tail dropout site: ``(v.f32 * keep * 1/(1-rate)).to(v.dtype)`` with
    the stream of ``tag`` over ``v``'s tokens (all but the last dim), the
    first of them the global token ``token0`` (or their map); ``v``'s
    features are ``f0, ..., f0 + v.shape[-1] - 1`` of a stream ``width``
    wide (default: v's own; a model rank's columns of the mid site)."""
    fw = v.shape[-1]
    width = fw if width is None else width
    if not 0 <= f0 <= width - fw:
        raise ValueError(f"features [{f0}, {f0 + fw}) do not lie in the {width}")
    keep = keep_rows(seed, tag, token0, f0, (v.numel() // fw, fw), width, dropout_thresh(rate), v.device)
    keep = keep.reshape(v.shape).to(torch.float32)
    return (v.to(torch.float32) * keep * (1.0 / (1.0 - rate))).to(v.dtype)
