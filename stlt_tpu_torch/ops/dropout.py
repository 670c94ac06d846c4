"""Counter-hashed dropout keep bits, bit for bit those of the JAX package.

Own copy of ``stlt_tpu/ops/flash.py`` (``_lowbias32`` :72,
``_dropout_thresh`` :81, ``_keep_block`` :87, ``hash_keep_mask`` :100) and
``stlt_tpu/ops/fused_tail_train.py`` (``TAG_*`` :90-92, ``_keep_rows`` :97,
``hash_keep_rows`` :109).

A keep bit is ``lowbias32(counter ^ lane) >= thresh`` with
``thresh = min(round(rate * 2**32), 2**32 - 1)``, all arithmetic mod 2**32:

- attention probabilities: lane ``lowbias32((b * N + n) ^ seed)`` for the
  global row ``b`` and head ``n``, counter ``t * S + s`` with the unpadded
  key count ``S``;
- the layer tail's three sites: lane ``lowbias32(seed ^ tag)``, counter
  ``token * width + feature``.

The CUDA kernels hash the same bits in place (``csrc/common.cuh``). Here the
arithmetic runs in int64 masked to 32 bits after every multiply and xor
(torch's uint32 has no shifts on the CPU); a product of two 32-bit values
may pass 2**63 and wrap, which keeps its low 32 bits. The seed and the
lanes that depend on it alone stay Python ints, kernel arguments of the
tensor ops: no host-to-device copy, so a train step hashing its dropout
bits on the card never waits for it. The keep functions take
row and feature offsets, so a counter past 2**32 can be reached without a
tensor of 2**32 elements.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF

# Stream tags of the tail's three dropout sites (fused_tail_train.py:90-92).
TAG_ATTN_DROP = 0x9E3779B9
TAG_MID_DROP = 0x85EBCA6B
TAG_OUT_DROP = 0xC2B2AE35


def lowbias32(x: torch.Tensor) -> torch.Tensor:
    """The lowbias32 mix of int64 values holding uint32s."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & MASK32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & MASK32
    return x ^ (x >> 16)


def dropout_thresh(rate: float) -> int:
    return min(int(round(rate * 2.0 ** 32)), 2 ** 32 - 1)


def keep_block(seed: int, b0: int, n: int, t0: int, s0: int, shape, num_heads: int,
               s_total: int, thresh: int, device=None) -> torch.Tensor:
    """Keep bits [rb, tb, sb] (bool) of head ``n`` for global offsets
    ``(b0, t0, s0)``: ``_keep_block``."""
    rb, tb, sb = shape
    b = torch.arange(rb, dtype=torch.int64, device=device)[:, None, None] + b0
    t = torch.arange(tb, dtype=torch.int64, device=device)[None, :, None] + t0
    s = torch.arange(sb, dtype=torch.int64, device=device)[None, None, :] + s0
    lane = lowbias32((((b & MASK32) * num_heads + n) & MASK32) ^ (int(seed) & MASK32))
    ctr = (((t & MASK32) * s_total) + s) & MASK32
    return lowbias32(ctr ^ lane) >= thresh


def hash_keep_mask(seed: int, B: int, N: int, T: int, S: int, rate: float,
                   device=None) -> torch.Tensor:
    """Keep bits [B, N, T, S] (bool) of the attention-probability dropout:
    ``hash_keep_mask``."""
    thresh = dropout_thresh(rate)
    return torch.stack(
        [keep_block(seed, 0, n, 0, 0, (B, T, S), N, S, thresh, device) for n in range(N)], dim=1
    )


def keep_rows(seed: int, tag: int, r0: int, f0: int, shape, width: int, thresh: int,
              device=None) -> torch.Tensor:
    """Keep bits [rows, fw] (bool) of one tail stream for global token rows
    from ``r0`` and features from ``f0``: ``_keep_rows``."""
    rows, fw = shape
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None] + r0
    f = torch.arange(fw, dtype=torch.int64, device=device)[None, :] + f0
    lane = lowbias32((int(seed) & MASK32) ^ (tag & MASK32))  # a Python int
    ctr = (((r & MASK32) * width) + f) & MASK32
    return lowbias32(ctr ^ lane) >= thresh


def hash_keep_rows(seed: int, tag: int, rows: int, width: int, rate: float,
                   device=None) -> torch.Tensor:
    """Keep bits [rows, width] (bool) of one tail stream: ``hash_keep_rows``."""
    return keep_rows(seed, tag, 0, 0, (rows, width), width, dropout_thresh(rate), device)


def hashed_dropout(v: torch.Tensor, seed: int, tag: int, rate: float) -> torch.Tensor:
    """One tail dropout site: ``(v.f32 * keep * 1/(1-rate)).to(v.dtype)`` with
    the stream of ``tag`` over ``v``'s tokens (all but the last dim)."""
    width = v.shape[-1]
    keep = hash_keep_rows(seed, tag, v.numel() // width, width, rate, v.device)
    keep = keep.reshape(v.shape).to(torch.float32)
    return (v.to(torch.float32) * keep * (1.0 / (1.0 - rate))).to(v.dtype)
