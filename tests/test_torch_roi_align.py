"""The port's ROI-Align chain (``stlt_tpu_torch/ops/roi_align.py``, plain
torch ops) against JAX's (``stlt_tpu/ops/roi_align.py``, jitted) in f32:
``roi_align``, ``adaptive_avg_pool2d``, ``fpn_level_for_boxes`` and
``multiscale_roi_align`` on the same seeded inputs.

Tolerance atol 1e-5: both take the same f32 bilinear weights and the same
four taps; only the order of the bins' sums may differ. Levels are
integers and equal exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlt_tpu.ops import roi_align as jax_roi
from stlt_tpu_torch.ops import roi_align as port_roi

ATOL = 1e-5

# In bounds, sub-pixel (a ROI under one cell), zero-area, wholly outside,
# partly outside on each side, and the whole map.
BOXES = np.array([
    [1.3, 2.1, 10.7, 7.9],
    [3.20, 4.05, 3.45, 4.30],
    [4.0, 4.0, 4.0, 4.0],
    [-6.0, -6.0, -2.0, -2.0],
    [11.9, 7.7, 25.0, 30.0],
    [-3.5, 1.0, 5.0, 12.5],
    [0.0, 0.0, 13.0, 9.0],
], np.float32)


def _jax_roi_align(feat, boxes, **kw):
    return np.asarray(jax.jit(lambda f, b: jax_roi.roi_align(f, b, **kw))(feat, boxes))


@pytest.mark.parametrize("output_size,sampling_ratio", [((7, 7), 2), ((3, 3), 1), ((2, 5), 3)])
@pytest.mark.parametrize("scale", [1.0, 0.5, 0.25])
def test_roi_align_matches_jax(scale, output_size, sampling_ratio):
    rng = np.random.default_rng(0)
    feat = rng.normal(size=(9, 13, 5)).astype(np.float32)
    kw = dict(output_size=output_size, spatial_scale=scale, sampling_ratio=sampling_ratio)
    got = port_roi.roi_align(torch.from_numpy(feat), torch.from_numpy(BOXES), **kw)
    want = _jax_roi_align(feat, BOXES, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    if scale == 1.0:
        assert not got[3].any()  # every sample below -1: the box samples nothing


def test_roi_align_takes_bf16_maps_in_f32_and_refuses_the_adaptive_grid():
    feat = np.random.default_rng(1).normal(size=(6, 6, 4)).astype(np.float32)
    bf16 = torch.from_numpy(feat).to(torch.bfloat16)
    got = port_roi.roi_align(bf16, torch.from_numpy(BOXES[:3]), output_size=(7, 7))
    want = _jax_roi_align(jnp.asarray(bf16.float().numpy()), BOXES[:3], output_size=(7, 7))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    with pytest.raises(NotImplementedError, match="adaptive sampling_ratio"):
        port_roi.roi_align(bf16, torch.from_numpy(BOXES), sampling_ratio=0)


@pytest.mark.parametrize("in_hw,out_hw", [((7, 7), (3, 3)), ((7, 7), (7, 7)), ((5, 9), (2, 4))])
def test_adaptive_avg_pool2d_matches_jax(in_hw, out_hw):
    x = np.random.default_rng(2).normal(size=(2, 3, *in_hw, 4)).astype(np.float32)
    got = port_roi.adaptive_avg_pool2d(torch.from_numpy(x), out_hw)
    want = np.asarray(jax.jit(lambda a: jax_roi.adaptive_avg_pool2d(a, out_hw))(x))
    assert tuple(got.shape) == want.shape == (2, 3, *out_hw, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_fpn_level_for_boxes_matches_jax():
    rng = np.random.default_rng(3)
    corner = rng.uniform(0, 300, size=(64, 2))
    boxes = np.concatenate([corner, corner + rng.uniform(0, 900, size=(64, 2))], 1)
    boxes = np.concatenate([boxes, [[0, 0, 224, 224], [0, 0, 56, 56], [5, 5, 5, 5],
                                    [0, 0, 1e4, 1e4]]]).astype(np.float32)
    got = port_roi.fpn_level_for_boxes(torch.from_numpy(boxes))
    want = np.asarray(jax.jit(jax_roi.fpn_level_for_boxes)(boxes))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[-4:], [4, 2, 2, 5])


def test_multiscale_roi_align_matches_jax():
    rng = np.random.default_rng(4)
    maps = [rng.normal(size=(32 >> i, 24 >> i, 3)).astype(np.float32) for i in range(4)]
    scales = [0.25, 0.125, 0.0625, 0.03125]  # levels 2..5
    boxes = np.array([[0, 0, 50, 50], [0, 0, 200, 200], [10, 20, 500, 400], [-20, 30, 60, 90],
                      [3.2, 4.1, 3.9, 4.6], [90, 60, 130, 200]], np.float32)
    kw = dict(spatial_scales=scales, output_size=(7, 7), sampling_ratio=2)
    got = port_roi.multiscale_roi_align([torch.from_numpy(m) for m in maps],
                                        torch.from_numpy(boxes), **kw)
    want = np.asarray(jax.jit(lambda ms, b: jax_roi.multiscale_roi_align(ms, b, **kw))(maps, boxes))
    assert len(set(port_roi.fpn_level_for_boxes(torch.from_numpy(boxes), k_min=2,
                                                k_max=5).tolist())) >= 3
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
