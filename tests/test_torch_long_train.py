"""Long-clip training through the port (plain versions on the CPU) against
the JAX package: the STLT's loss and every parameter gradient at 257 and
513 frames (the temporal attention's backward on the short and the
blockwise path), and the train CLI at ``--layout_num_frames 256`` with
``--live_prefix --use_pallas``.

Same numpy-seeded batches and the same weights (carried by
``stlt_tpu_torch.utils.convert``) through both; JAX runs ``use_pallas=True``
with its Pallas kernels in interpret mode and ``jax.grad``. Tolerances, f32,
dropout 0:

- loss atol 2e-5 (the logits' tolerance); gradients atol = rtol = 1e-4,
  the train layer's (both compute the same f32 function, in another order of
  sums over every token of the batch);
- the train CLI with ``--live_prefix --use_pallas`` against the run
  without: parameters after two AdamW steps at atol = rtol = 1e-5.

Both packages pick the train tail by JAX's default gate on the model's clip
length (``TAIL_TRAIN_MIN_FRAMES = 256``): at 257 and 513 frames every tail
runs the fused train-tail op (in JAX its Pallas kernels, TPU kernels 11-14;
in the port ``ops/fused_tail_train``'s plain versions), which a spy on each
side counts. One case turns JAX's gate off (the threshold above the frame
count), so JAX runs its XLA chain against the port's fused op: the same
gradients show that the two tails are one function in f32.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_layout_batch
from stlt_tpu import configs as jax_configs
from stlt_tpu.models import models_factory as jax_models
from stlt_tpu.ops import fused_tail_train as jax_ftt
from stlt_tpu.training.criterion import make_criterion as jax_make_criterion
from stlt_tpu_torch import configs
from stlt_tpu_torch import train as port_train
from stlt_tpu_torch.models import models_factory
from stlt_tpu_torch.ops import flash
from stlt_tpu_torch.ops import fused_encoder as fe
from stlt_tpu_torch.ops import fused_tail_train as ftt
from stlt_tpu_torch.training.criterion import make_criterion
from stlt_tpu_torch.utils.convert import jax_params_to_state_dict
from tests.fixtures import make_something_fixture

LOSS_ATOL = 2e-5
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
PARAM_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_KW = dict(num_classes=5, unique_categories=4, hidden_size=16, num_attention_heads=2,
                num_spatial_layers=1, num_temporal_layers=1, use_pallas=True,
                hidden_dropout_prob=0.0)


def _inputs(frames, length_range, seed):
    batch = _synthetic_layout_batch(2, frames, 4, 4, seed=seed, length_range=length_range)
    labels = np.array([1, 3], np.int32)
    return {k: v for k, v in batch.items() if k != "labels"}, labels


@pytest.fixture(scope="module")
def params():
    """JAX STLT parameters with a 513-row position table, initialised on a
    3-frame batch and shared by every model of this file."""
    cfg = jax_configs.StltModelConfig(layout_num_frames=513, **MODEL_KW)
    return jax.jit(jax_models["stlt"](cfg).init)(jax.random.PRNGKey(0), _inputs(3, None, 0)[0])["params"]


def _jax_loss_and_grads(params, inputs, labels):
    cfg = jax_configs.StltModelConfig(layout_num_frames=513, **MODEL_KW)
    model, criterion = jax_models["stlt"](cfg), jax_make_criterion("something")

    def loss_fn(p):
        return criterion(model.apply({"params": p}, inputs, deterministic=False), labels)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), jax_params_to_state_dict(grads)


def _port_loss_and_grads(params, inputs, labels):
    fields = {f.name for f in dataclasses.fields(configs.StltModelConfig)}
    cfg = configs.StltModelConfig(layout_num_frames=513, **{k: v for k, v in MODEL_KW.items()
                                                           if k in fields})
    model = models_factory["stlt"](cfg)
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    model.train()
    loss = make_criterion("something")(
        model({k: torch.from_numpy(v) for k, v in inputs.items()}), torch.from_numpy(labels))
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("frames,length_range,gate", [
    (257, (60, 257), "default"),
    (513, (200, 513), "default"),
    (257, (60, 257), "off"),
])
def test_long_clip_gradients_match_jax(params, frames, length_range, gate, monkeypatch):
    """Loss and every gradient of one train-mode forward and backward. The
    port runs its fused train tail in both layers; JAX runs its fused train
    tail (interpret mode) under the default gate, its XLA chain with the
    gate off."""
    inputs, labels = _inputs(frames, length_range, seed=frames + 1)
    assert (inputs["lengths"] < frames).any()  # ragged
    calls, port_calls = [], []
    if gate == "off":
        monkeypatch.setattr(jax_ftt, "TAIL_TRAIN_MIN_FRAMES", frames + 1)
    else:
        assert frames >= jax_ftt.TAIL_TRAIN_MIN_FRAMES
    real = jax_ftt.fused_layer_tail_train
    monkeypatch.setattr(jax_ftt, "fused_layer_tail_train",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    want_loss, want = _jax_loss_and_grads(params, inputs, labels)
    assert len(calls) == (2 if gate == "default" else 0)  # the spatial and the temporal tail
    port_real = ftt.fused_layer_tail_train
    monkeypatch.setattr(ftt, "fused_layer_tail_train",
                        lambda *a, **k: port_calls.append(a[0].shape) or port_real(*a, **k))
    flash.reset_launches()
    loss, got = _port_loss_and_grads(params, inputs, labels)
    assert not any(flash.LAUNCHES.values())
    assert port_calls == [(2 * frames, 4, 16), (2, frames, 16)], port_calls
    assert abs(loss - want_loss) <= LOSS_ATOL, (loss, want_loss)
    assert set(got) <= set(want) and len(got) > 20
    for name, grad in got.items():
        np.testing.assert_allclose(grad.numpy(), want[name].numpy(), err_msg=name, **GRAD_TOL)


def _cli_argv(paths, root, *extra):
    return [
        "--dataset_name", "something", "--dataset_type", "layout", "--model_name", "stlt",
        "--train_dataset_path", paths["dataset_path"], "--val_dataset_path", paths["dataset_path"],
        "--labels_path", paths["labels_path"], "--videoid2size_path", paths["videoid2size_path"],
        "--layout_num_frames", "256", "--batch_size", "4", "--hidden_size", "16",
        "--num_attention_heads", "2", "--num_spatial_layers", "1", "--num_temporal_layers", "1",
        "--hidden_dropout_prob", "0", "--epochs", "1", "--platform", "cpu",
        "--save_model_path", str(root / "best.pt"), *extra,
    ]


def test_train_cli_live_prefix_takes_safe_capacities_and_keeps_the_result(tmp_path, monkeypatch):
    """train --layout_num_frames 256 --live_prefix --use_pallas. Capacities
    that hold for the train and the validation set cut nothing: on the
    validation set alone (the eval sampler keeps each clip's length) they
    equal JAX's ``_live_prefix_caps`` and cut both levers, but the jittered
    train sampler fills all 257 slots of every clip, so the train set allows
    no cut, where JAX's capacity from the longest clip would drop sampled
    frames. The CLI therefore leaves the model uncapped and logs that the
    flag has no effect. The run with the flags equals the run without: the
    same train-attention shapes (4 x 257 spatial rows, the 257-frame stage
    on the flash path) and the same parameters after two AdamW steps."""
    from stlt_tpu.data.layout import LayoutDataset as JaxLayoutDataset
    from stlt_tpu.parser import build_parser as jax_build_parser
    from stlt_tpu.train import _live_prefix_caps as jax_live_prefix_caps

    paths, *_ = make_something_fixture(str(tmp_path), num_videos=8, num_frames_range=(4, 40))
    argv = _cli_argv(paths, tmp_path, "--use_pallas", "--live_prefix")
    args, jax_args = port_train.build_parser("test").parse_args(argv), jax_build_parser("test").parse_args(argv)
    sets, jax_sets = {}, {}
    for train in (True, False):
        cfg = configs.DataConfig(dataset_name="something", layout_num_frames=256, train=train, **paths)
        sets[train] = (port_train.datasets_factory["layout"](cfg), cfg)
        jcfg = jax_configs.DataConfig(dataset_name="something", layout_num_frames=256, train=train, **paths)
        jax_sets[train] = (JaxLayoutDataset(jcfg), jcfg)
    val_caps = configs.live_prefix_caps(args, sets[False])
    assert val_caps == jax_live_prefix_caps(jax_args, jax_sets[False])
    assert None not in val_caps and val_caps[1] < 257
    assert configs.live_prefix_caps(args, sets[True], sets[False]) == (None, None)
    train_sample = sets[True][0][0]
    assert int((train_sample["frame_types"] != 0).sum()) == 257  # every slot sampled
    assert jax_live_prefix_caps(jax_args, jax_sets[True], jax_sets[False])[1] < 257

    shapes = []
    real = fe.fused_proj_attention_train

    def spy(x, *args, **kwargs):
        shapes.append(tuple(x.shape[:2]))
        return real(x, *args, **kwargs)

    monkeypatch.setattr(fe, "fused_proj_attention_train", spy)
    results = {}
    for levers in (False, True):
        shapes.clear()
        extra = ("--use_pallas", "--live_prefix") if levers else ()
        result = port_train.main(_cli_argv(paths, tmp_path / str(levers), *extra))
        assert result.step == 2 and result.model.config.temporal_frame_capacity is None
        assert result.model.config.spatial_live_capacity is None
        assert set(shapes) == {(4 * 257, sets[True][1].num_total_boxes)}, (levers, shapes)
        results[levers] = result.model.state_dict()
    for name, value in results[False].items():
        torch.testing.assert_close(results[True][name], value, **PARAM_TOL, msg=name)
