"""``chip_smoke.py``'s phase 8 f32 check: the appearance encoder's ReLU gates
that the kernel and the plain run set differently are pinned to the kernel
run's (``pin_flipped_gates``, ``appearance_gates``) and checked
(``check_gate_flips``). On synthetic pre-activations and on a tiny encoder,
on the CPU."""

import numpy as np
import pytest
import torch

import chip_smoke
from stlt_tpu_torch.models.layers import TransformerEncoder


def _pair(seed, n=4096):
    """z_ref and z = z_ref moved by ~1e-6 (an f32 sum-order difference),
    with two elements of z_ref within that of 0 so that their gates flip."""
    rng = np.random.default_rng(seed)
    ref = rng.standard_normal(n).astype(np.float32)
    ref[[5, 77]] = [3e-7, -2e-7]
    z = ref + rng.uniform(-1e-6, 1e-6, n).astype(np.float32)
    z[[5, 77]] = [-4e-7, 6e-7]
    return torch.from_numpy(z), torch.from_numpy(ref)


def test_equal_signs_pass_untouched():
    z, ref = _pair(0)
    z[[5, 77]] = ref[[5, 77]]
    pinned, count, largest = chip_smoke.pin_flipped_gates(z, ref)
    assert count == 0 and largest == 0.0
    assert torch.equal(pinned, z)
    chip_smoke.check_gate_flips("equal", {0: (count, largest, 0.0, z.numel())})


def test_flip_within_the_distance_is_pinned_and_the_gradient_flows():
    z, ref = _pair(1)
    z.requires_grad_(True)
    pinned, count, largest = chip_smoke.pin_flipped_gates(z, ref)
    assert count == 2 and largest == pytest.approx(6e-7)
    assert torch.equal(pinned.detach()[[5, 77]], ref[[5, 77]])
    keep = torch.ones_like(ref, dtype=torch.bool)
    keep[[5, 77]] = False
    assert torch.equal(pinned.detach()[keep], z.detach()[keep])
    chip_smoke.check_gate_flips("pinned", {0: (count, largest, 0.0, z.numel())})
    torch.relu(pinned).sum().backward()
    # The gradient reaches z at every element, through the reference's gates.
    assert torch.equal(z.grad, (ref > 0).float())


def test_a_flip_beyond_the_distance_raises():
    z, ref = _pair(2)
    ref[9], z[9] = 10 * chip_smoke.GATE_PIN_ABS, -1e-7
    _, count, largest = chip_smoke.pin_flipped_gates(z, ref)
    assert count == 3 and largest == pytest.approx(10 * chip_smoke.GATE_PIN_ABS)
    with pytest.raises(AssertionError, match="ReLU gates flipped"):
        chip_smoke.check_gate_flips("far", {0: (count, largest, 0.0, z.numel())})


def test_too_many_flips_raise():
    n = chip_smoke.GATE_PIN_MAX + 1
    ref = torch.full((n,), 1e-7)
    _, count, largest = chip_smoke.pin_flipped_gates(-ref, ref)
    assert count == n and largest <= chip_smoke.GATE_PIN_ABS
    # Spread over layers, the count is the step's total.
    flips = {0: (count - 1, largest, 0.0, n), 1: (1, largest, 0.0, n)}
    with pytest.raises(AssertionError, match="ReLU gates flipped"):
        chip_smoke.check_gate_flips("many", flips)


def test_appearance_gates_record_then_pin_each_relu_layer():
    """On a tiny two-layer ReLU encoder in train mode (the plain train-tail
    chain): a first run records each layer's pre-activations, a second from
    slightly moved inputs takes them as reference, counts its flips per
    layer and pins them, and the gradient still reaches the input."""
    gen = torch.Generator().manual_seed(0)
    encoder = TransformerEncoder(2, 32, 4, 64, activation="relu", layer_norm_eps=1e-5,
                                 dtype=torch.float32, generator=gen).train()
    model = torch.nn.Module()  # named as in a fusion model: backbone.appearance_branch.transformer
    model.backbone = torch.nn.Module()
    model.backbone.appearance_branch = torch.nn.Module()
    model.backbone.appearance_branch.transformer = encoder
    x = torch.randn(3, 5, 32, generator=gen)
    with chip_smoke.appearance_gates(model) as first:
        encoder(x)
    assert sorted(first.z) == [0, 1] and first.z[0].shape == (3, 5, 64)
    # Move the inputs so that a few gates flip.
    moved = (x + 3e-2 * torch.randn(x.shape, generator=gen)).requires_grad_(True)
    with chip_smoke.appearance_gates(model, first.z) as second:
        encoder(moved).sum().backward()
    assert sorted(second.flips) == [0, 1]
    for count, largest, diff, numel in second.flips.values():
        # A flipped element lies on both sides of 0, so within diff of it.
        assert numel == 3 * 5 * 64 and diff > 0 and largest <= diff
    assert second.flips[0][0] >= 1
    # Layer 0's pinned pre-activations carry the reference's gates exactly.
    assert torch.equal(second.z[0] > 0, first.z[0] > 0)
    assert moved.grad is not None and torch.isfinite(moved.grad).all()
    # The hooks and the activation are restored.
    assert not encoder.layers[0]._forward_pre_hooks
    from stlt_tpu_torch.models import layers
    assert layers.activation_fn is first.saved
