"""``--remat``: each encoder layer under ``torch.utils.checkpoint``
(``stlt_tpu_torch/models/layers.py::TransformerEncoder``), on the CPU (the
kernels' plain versions inside the same autograd Functions the card runs).

One AdamW step at dropout 0.1 from the same seeded weights, batch and step
generator, with and without remat: the loss, every gradient and every
updated parameter equal bit for bit, and every encoder layer's forward ran
twice with remat (the forward and the backward's recompute) and once
without. Cases: STLT at 17 frames (the train op ``_ProjAttentionTrain``
and the plain train tail), at 257 frames (the temporal attention through
``ops/flash.py``'s ``_Attention`` and, from 256 frames on, the fused train
tail's ``_TailTrain``), and CACNF, whose appearance encoder (ReLU, eps
1e-5, torch's default dropout 0.1) takes remat as the layout branch's
encoders do while its fusion layers take none, as in JAX. The layer's
dropout seeds are drawn before the checkpointed call, so the recompute
hashes the same keep bits: a recompute that drew its own seeds would not
be bit-identical.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_layout_batch
from stlt_tpu_torch.configs import StltModelConfig
from stlt_tpu_torch.models import layers, models_factory
from stlt_tpu_torch.ops import fused_tail_train as ftt
from stlt_tpu_torch.training.criterion import make_criterion
from stlt_tpu_torch.training.loop import make_train_step, step_generator
from stlt_tpu_torch.training.optimizer import make_optimizer
from tests.test_torch_fusion import model_inputs, port_config
from tests.test_torch_appearance_train import jax_train_model

DROPOUT = 0.1
STLT_KW = dict(num_classes=7, unique_categories=4, hidden_size=32, num_attention_heads=4,
               num_spatial_layers=1, num_temporal_layers=2, hidden_dropout_prob=DROPOUT)


def _stlt(frames: int, remat: bool):
    cfg = StltModelConfig(layout_num_frames=frames + 1, remat=remat, **STLT_KW)
    model = models_factory["stlt"](cfg, torch.Generator().manual_seed(0))
    batch = _synthetic_layout_batch(2, frames, 4, 4, seed=3, length_range=(3, frames))
    batch["labels"] = np.array([1, 5], np.int32)
    batch["valid"] = np.array([True, True])
    return model, batch


def _cacnf(remat: bool):
    cfg, _ = jax_train_model("cacnf", hidden_dropout_prob=DROPOUT)
    model = models_factory["cacnf"](dataclasses.replace(port_config("cacnf", cfg), remat=remat),
                                    torch.Generator().manual_seed(0))
    batch = model_inputs(7, (3, 7), seed=2, clips=2)
    batch["labels"] = np.array([0, 3], np.int32)
    batch["valid"] = np.array([True, True])
    return model, batch


def _step(model, batch):
    """One AdamW step: (loss, gradients, parameters after the step, the
    number of forward calls of each encoder layer, the calls of the fused
    train tail's plain forward and backward)."""
    from stlt_tpu_torch.training import loop

    calls, tail = {}, {"fwd": 0, "bwd": 0}
    hooks = [m.register_forward_pre_hook(lambda mod, args, n=name: calls.__setitem__(
                 n, calls.get(n, 0) + 1))
             for name, m in model.named_modules() if isinstance(m, layers.TransformerEncoderLayer)]
    optimizer, scheduler = make_optimizer(model, learning_rate=1e-3, weight_decay=1e-3,
                                          num_warmup_steps=0, num_training_steps=10)
    grads = {}
    clip_by_global_norm_ = loop.clip_by_global_norm_
    tail_fwd, tail_bwd = ftt.fused_layer_tail_train_plain, ftt.fused_layer_tail_train_bwd_plain

    def keep_grads(params, clip):  # the gradients as the clip sees them
        grads.update({n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None})
        return clip_by_global_norm_(params, clip)

    def count(key, fn):
        def wrapped(*args, **kw):
            tail[key] += 1
            return fn(*args, **kw)
        return wrapped

    loop.clip_by_global_norm_ = keep_grads
    ftt.fused_layer_tail_train_plain = count("fwd", tail_fwd)
    ftt.fused_layer_tail_train_bwd_plain = count("bwd", tail_bwd)
    try:
        step = make_train_step(model, optimizer, scheduler, make_criterion("something"), 5.0)
        loss, _ = step({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
                       step_generator(0, 3))
    finally:
        loop.clip_by_global_norm_ = clip_by_global_norm_
        ftt.fused_layer_tail_train_plain, ftt.fused_layer_tail_train_bwd_plain = tail_fwd, tail_bwd
        for h in hooks:
            h.remove()
    return loss, grads, {k: v.clone() for k, v in model.state_dict().items()}, calls, tail


@functools.lru_cache(maxsize=None)
def _stlt_steps(frames: int):
    """``_step`` of the seeded STLT at ``frames`` frames without and with
    remat (one pair for the tests that read it)."""
    return _step(*_stlt(frames, False)), _step(*_stlt(frames, True))


def _check(plain, remat):
    loss, grads, params, calls, _ = plain
    loss_r, grads_r, params_r, calls_r, _ = remat
    assert calls and set(calls.values()) == {1}
    assert calls_r == {name: 2 for name in calls}, calls_r
    assert torch.equal(loss, loss_r)
    assert set(grads) == set(grads_r) and grads
    for name in grads:
        assert torch.equal(grads[name], grads_r[name]), name
    for name in params:
        assert torch.equal(params[name], params_r[name]), name
    return calls


@pytest.mark.parametrize("frames", [16, 256])
def test_remat_step_equals_plain_step_bit_for_bit(frames):
    calls = _check(*_stlt_steps(frames))
    assert len(calls) == STLT_KW["num_spatial_layers"] + STLT_KW["num_temporal_layers"]


def test_remat_runs_the_fused_train_tail_twice_at_256_frames():
    """At 256 frames the train tail is ``_TailTrain``: its forward runs in the
    step's forward and again in the recompute, its backward once."""
    plain, remat = _stlt_steps(256)
    layers_total = STLT_KW["num_spatial_layers"] + STLT_KW["num_temporal_layers"]
    assert plain[4] == {"fwd": layers_total, "bwd": layers_total}
    assert remat[4] == {"fwd": 2 * layers_total, "bwd": layers_total}


def test_remat_covers_cacnf_appearance_encoder_not_its_fusion_layers():
    calls = _check(_step(*_cacnf(False)), _step(*_cacnf(True)))
    assert any("appearance_branch.transformer.layers" in n for n in calls)
    assert not any("mm_fusion" in n for n in calls)


def test_remat_is_off_in_eval_and_without_grad():
    model, batch = _stlt(16, remat=True)
    inputs = {k: torch.from_numpy(v) for k, v in batch.items() if k not in ("labels", "valid")}
    calls = []
    layer = next(m for n, m in model.named_modules()
                 if isinstance(m, layers.TransformerEncoderLayer) and ".layers." in n)
    layer.register_forward_pre_hook(lambda mod, args: calls.append(1))
    with torch.no_grad():
        model.train()(inputs, step_generator(0, 0))
    model.eval()(inputs)
    assert len(calls) == 2
