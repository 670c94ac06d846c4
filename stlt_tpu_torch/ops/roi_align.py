"""ROI-Align and the multi-scale pooling chain of the per-box feature dump.

Own copy of ``stlt_tpu/ops/roi_align.py`` in plain torch ops (neither
machine has torchvision): the pooling stack of the reference's per-box dump
(``src/dump_perbox_features.py:18-39``: a MultiScaleRoIAlign with
``output_size=7, sampling_ratio=2``, then ``nn.AdaptiveAvgPool2d((3, 3))``
and ``flatten(1)``).

- Feature maps are channels-last, ``[H, W, C]``; boxes ``[K, 4]`` as
  ``(x1, y1, x2, y2)`` in input-image coordinates.
- Sampling follows torchvision's ``roi_align`` with ``aligned=False``: no
  half-pixel shift, ROI sizes floored at 1, samples outside ``[-1, size]``
  add zero, coordinates clamped to ``[0, size - 1]`` before the 2x2
  neighbourhood.
- Bilinear sampling is four gathers and a weighted sum over every (box,
  bin, sample) at once, in f32.

It is no Pallas kernel in JAX, so it has no hand-written kernel here.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch


def _bilinear_gather(features: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of ``features [H, W, C]`` at ``ys, xs [N]``:
    samples past ``[-1, size]`` are zero, the rest clamped into ``[0, size -
    1]`` and blended with weights from the clamped position."""
    h, w, c = features.shape
    dead = (ys < -1.0) | (ys > float(h)) | (xs < -1.0) | (xs > float(w))
    y = ys.clamp(0.0, float(h - 1))
    x = xs.clamp(0.0, float(w - 1))
    y0 = torch.floor(y).long()
    x0 = torch.floor(x).long()
    y1 = (y0 + 1).clamp(max=h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    ly = (y - y0.to(y.dtype))[:, None]
    lx = (x - x0.to(x.dtype))[:, None]
    flat = features.reshape(h * w, c)
    v00 = flat[y0 * w + x0]
    v01 = flat[y0 * w + x1]
    v10 = flat[y1 * w + x0]
    v11 = flat[y1 * w + x1]
    out = ((1 - ly) * (1 - lx) * v00 + (1 - ly) * lx * v01
           + ly * (1 - lx) * v10 + ly * lx * v11)
    return torch.where(dead[:, None], torch.zeros_like(out), out)


def roi_align(features: torch.Tensor, boxes: torch.Tensor, *, output_size: Tuple[int, int] = (7, 7),
              spatial_scale: float = 1.0, sampling_ratio: int = 2) -> torch.Tensor:
    """ROI-Align of one feature map ``[H, W, C]`` at ``boxes [K, 4]``:
    ``[K, out_h, out_w, C]`` f32, each bin the mean of an ``s x s`` grid of
    bilinear samples (``s = sampling_ratio``). The adaptive grid
    (``sampling_ratio <= 0``) depends on each box's size and is refused, as
    in JAX: the dump chain always takes 2."""
    if sampling_ratio <= 0:
        raise NotImplementedError(
            "adaptive sampling_ratio is data-dependent per box; the dump chain (reference "
            "dump_perbox_features.py:22) always uses 2")
    out_h, out_w = output_size
    s = sampling_ratio
    feats = features.float()
    b = boxes.float() * spatial_scale
    x1, y1, x2, y2 = b.unbind(-1)
    bin_h = (y2 - y1).clamp(min=1.0) / out_h  # [K]
    bin_w = (x2 - x1).clamp(min=1.0) / out_w

    def grid(n: int) -> torch.Tensor:  # bin index + the sample's offset in the bin, [n * s]
        i = torch.arange(n * s, dtype=torch.float32, device=feats.device)
        return torch.div(i, s, rounding_mode="floor") + (i % s + 0.5) / s

    ys = y1[:, None] + grid(out_h)[None, :] * bin_h[:, None]  # [K, out_h * s]
    xs = x1[:, None] + grid(out_w)[None, :] * bin_w[:, None]  # [K, out_w * s]
    k = boxes.shape[0]
    yy = ys[:, :, None].expand(k, out_h * s, out_w * s)
    xx = xs[:, None, :].expand(k, out_h * s, out_w * s)
    vals = _bilinear_gather(feats, yy.reshape(-1), xx.reshape(-1))
    return vals.reshape(k, out_h, s, out_w, s, feats.shape[-1]).mean(dim=(2, 4))


def _bins(n_in: int, n_out: int):
    """torch's adaptive-pool bins: ``[floor(i In / Out), ceil((i + 1) In /
    Out))``, overlapping where In is not a multiple of Out."""
    return [(math.floor(i * n_in / n_out), math.ceil((i + 1) * n_in / n_out)) for i in range(n_out)]


def adaptive_avg_pool2d(x: torch.Tensor, output_size: Tuple[int, int]) -> torch.Tensor:
    """``nn.AdaptiveAvgPool2d`` on channels-last ``[..., H, W, C]``."""
    out_h, out_w = output_size
    rows = torch.stack([x[..., lo:hi, :, :].mean(dim=-3) for lo, hi in _bins(x.shape[-3], out_h)],
                       dim=-3)
    return torch.stack([rows[..., lo:hi, :].mean(dim=-2) for lo, hi in _bins(x.shape[-2], out_w)],
                       dim=-2)


def fpn_level_for_boxes(boxes: torch.Tensor, *, k_min: int = 2, k_max: int = 5,
                        canonical_scale: int = 224, canonical_level: int = 4) -> torch.Tensor:
    """torchvision's ``LevelMapper``: each box's FPN level
    ``floor(k0 + log2(sqrt(area) / s0))``, clamped to ``[k_min, k_max]``,
    int32 ``[K]``."""
    b = boxes.float()
    area = ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])).clamp(min=1e-6)
    level = torch.floor(canonical_level + torch.log2(torch.sqrt(area) / canonical_scale + 1e-6))
    return level.clamp(k_min, k_max).to(torch.int32)


def multiscale_roi_align(feature_maps: Sequence[torch.Tensor], boxes: torch.Tensor, *,
                         spatial_scales: Sequence[float], output_size: Tuple[int, int] = (7, 7),
                         sampling_ratio: int = 2, canonical_scale: int = 224,
                         canonical_level: int = 4) -> torch.Tensor:
    """MultiScaleRoIAlign over a pyramid: every box pooled on every level,
    then each box's level kept (``fpn_level_for_boxes``).
    ``spatial_scales[i]`` is map i's resolution over the input image's, and
    level ``k_min = -log2(spatial_scales[0])``."""
    k_min = int(-math.log2(spatial_scales[0]) + 0.5)
    k_max = int(-math.log2(spatial_scales[-1]) + 0.5)
    levels = fpn_level_for_boxes(boxes, k_min=k_min, k_max=k_max, canonical_scale=canonical_scale,
                                 canonical_level=canonical_level)
    pooled = torch.stack([
        roi_align(fm, boxes, output_size=output_size, spatial_scale=sc,
                  sampling_ratio=sampling_ratio)
        for fm, sc in zip(feature_maps, spatial_scales)
    ])  # [L, K, oh, ow, C]
    keep = torch.arange(len(feature_maps), device=boxes.device)[:, None] == (levels - k_min)[None, :]
    return (pooled * keep[:, :, None, None, None]).sum(dim=0)
