"""Additive attention-mask helpers (port of ``stlt_tpu/ops/masks.py``).

Masks are finite additive f32 biases: 0 attends, ``MASK_VALUE`` masks. With
at least one unmasked key per row (pad frames carry a CLS token) the masked
terms underflow to exactly 0 after the max-subtracted exp, as with ``-inf``;
a fully masked row gives a uniform softmax instead of NaN. Boolean torch
masks and ``-inf`` are never used.
"""

from __future__ import annotations

import torch

MASK_VALUE = -1e9


def causal_bias(num_frames: int, device=None) -> torch.Tensor:
    """[T, T] additive bias allowing position t to attend to <= t."""
    allowed = torch.ones(num_frames, num_frames, dtype=torch.bool, device=device).tril()
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(allowed, zero, zero + MASK_VALUE)


def key_padding_bias(padding_mask: torch.Tensor) -> torch.Tensor:
    """[..., S] boolean (True = masked) -> [..., 1, 1, S] additive f32 bias."""
    zero = torch.zeros((), dtype=torch.float32, device=padding_mask.device)
    bias = torch.where(padding_mask, zero + MASK_VALUE, zero)
    return bias[..., None, None, :]


def boxes_padding_mask(categories: torch.Tensor) -> torch.Tensor:
    """True where the box slot is padding (``categories == 0``)."""
    return categories == 0


def frames_padding_mask(frame_types: torch.Tensor, pad_type: int = 0) -> torch.Tensor:
    """True where the frame is padding (``frame_types == pad``)."""
    return frame_types == pad_type
