"""Long clips through the port (plain versions on the CPU) against the JAX
package: the STLT at 257 frames (the temporal attention on the short flash
kernel) and 513 frames (the blockwise kernel in lengths mode), the ragged
levers (frame-capacity truncation and the spatial live-prefix fold), their
capacity helpers, and the evaluation CLI ``stlt_tpu_torch.inference``.

Same numpy-seeded batches and the same weights (carried by
``stlt_tpu_torch.utils.convert``) through both; JAX runs ``use_pallas=True``
with its Pallas kernels in interpret mode. Tolerances, f32:

- logits, port against JAX: atol 2e-5, rtol 1e-5 (the golden test's); both
  compute the same f32 function, in another order of sums;
- logits with the levers against the uncapped port: atol 1e-5, rtol 1e-5;
  the capped model runs the same rows in another order and fewer frame
  slots, so only sums over other block shapes differ;
- metrics of the two CLIs: atol 1e-9 (counts of hits over the same clips).
"""

import dataclasses
import logging

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_layout_batch
from stlt_tpu import configs as jax_configs
from stlt_tpu.models import models_factory as jax_models
from stlt_tpu.ops import fused_encoder as jax_fe
from stlt_tpu_torch import configs
from stlt_tpu_torch import inference as port_inference
from stlt_tpu_torch.models import models_factory
from stlt_tpu_torch.ops import flash
from stlt_tpu_torch.ops import fused_encoder as fe
from stlt_tpu_torch.utils.convert import jax_params_to_state_dict
from tests.fixtures import make_something_fixture

LOGITS_TOL = dict(atol=2e-5, rtol=1e-5)
CAP_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_KW = dict(num_classes=5, unique_categories=4, hidden_size=16, num_attention_heads=2,
                num_spatial_layers=1, num_temporal_layers=1, use_pallas=True)
NUM_BOXES = 4


def _jax_config(frames, **kw):
    return jax_configs.StltModelConfig(layout_num_frames=frames, **MODEL_KW, **kw)


def _port_model(jax_cfg, params):
    fields = {f.name for f in dataclasses.fields(configs.StltModelConfig)}
    cfg = configs.StltModelConfig(**{k: v for k, v in dataclasses.asdict(jax_cfg).items() if k in fields})
    model = models_factory["stlt"](cfg).eval()
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return model


def _port_logits(model, inputs):
    with torch.inference_mode():
        return model({k: torch.from_numpy(v) for k, v in inputs.items()})["stlt"].numpy()


def _inputs(frames, length_range, seed):
    batch = _synthetic_layout_batch(2, frames, NUM_BOXES, 4, seed=seed, length_range=length_range)
    return {k: v for k, v in batch.items() if k != "labels"}


@pytest.fixture(scope="module")
def params():
    """JAX STLT parameters with a 513-row position table, initialised on a
    3-frame batch (the tree does not depend on the clip length) and shared by
    every model of this file: the 257-frame models use the first 257 rows
    of the table."""
    cfg = _jax_config(513)
    return jax_models["stlt"](cfg).init(jax.random.PRNGKey(0), _inputs(3, None, 0))["params"]


@pytest.mark.parametrize("frames,length_range,kernel", [
    (257, (60, 257), "flash_attention"),
    (513, (200, 513), "blockwise_attention"),
])
def test_long_clip_logits_match_jax(params, frames, length_range, kernel, monkeypatch):
    cfg = _jax_config(513)
    inputs = _inputs(frames, length_range, seed=frames)
    assert (inputs["lengths"] < frames).any()  # ragged
    want = np.asarray(jax_models["stlt"](cfg).apply({"params": params}, inputs)["stlt"])
    model = _port_model(cfg, params)
    # The temporal attention takes the kernel of its length: spy on the two
    # wrappers (on the CPU they run their plain versions and launch nothing).
    calls = []
    for name in ("fused_attention", "blockwise_attention"):
        real = getattr(flash, name)
        monkeypatch.setattr(flash, name, lambda *a, _n=name, _f=real, **k: calls.append(_n) or _f(*a, **k))
    flash.reset_launches()
    fe.reset_launches()
    got = _port_logits(model, inputs)
    assert not any(flash.LAUNCHES.values()) and not any(fe.LAUNCHES.values())
    want_call = "fused_attention" if kernel == "flash_attention" else "blockwise_attention"
    assert calls == [want_call] * MODEL_KW["num_temporal_layers"]
    assert got.shape == (2, MODEL_KW["num_classes"]) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **LOGITS_TOL)


def test_temporal_bias_is_not_built_from_513_frames(params, monkeypatch):
    """From 513 frames on the temporal attention masks from kv_lengths: the
    dense [B, 1, F, F] bias is never built."""
    from stlt_tpu_torch.ops import masks

    def no_causal_bias(*args, **kwargs):
        raise AssertionError("causal_bias built at 513 frames")

    monkeypatch.setattr(masks, "causal_bias", no_causal_bias)
    logits = _port_logits(_port_model(_jax_config(513), params), _inputs(513, (40, 513), seed=2))
    assert np.isfinite(logits).all()


def _capacities(inputs):
    """(spatial_live_capacity, temporal_frame_capacity) from the batch's
    host lengths, as bench.py's ragged workload derives them."""
    live_per_clip = (inputs["frame_types"] != 0).sum(axis=1)
    frames = inputs["frame_types"].shape[1]
    fcap = fe.frame_capacity(int(live_per_clip.max()), frames)
    axis = frames if fcap is None else fcap
    return fe.live_prefix_capacity(int(live_per_clip.sum()), inputs["frame_types"].shape[0] * axis), fcap


def test_ragged_levers_equal_the_uncapped_model(params):
    inputs = _inputs(513, (32, 140), seed=4)
    live_cap, frame_cap = _capacities(inputs)
    assert frame_cap is not None and frame_cap < 513 and live_cap is not None and live_cap < 2 * frame_cap
    cfg = _jax_config(513)
    capped = dataclasses.replace(cfg, spatial_live_capacity=live_cap, temporal_frame_capacity=frame_cap)
    uncapped = _port_logits(_port_model(cfg, params), inputs)
    got = _port_logits(_port_model(capped, params), inputs)
    want = np.asarray(jax_models["stlt"](capped).apply({"params": params}, inputs)["stlt"])
    np.testing.assert_allclose(got, uncapped, **CAP_TOL)
    np.testing.assert_allclose(want, uncapped, **CAP_TOL)
    for name, value in (("spatial_live_capacity", 8), ("temporal_frame_capacity", 16)):
        too_small = _port_model(dataclasses.replace(cfg, **{name: value}), params)
        with pytest.raises(ValueError, match=name):
            _port_logits(too_small, inputs)


def test_ragged_levers_keep_train_gradients(params):
    """Train mode (dropout 0) through both levers: the loss and every
    parameter's gradient equal the uncapped model's (the fold's gather and
    scatter carry the gradients of the live rows; dead rows get none)."""
    from stlt_tpu_torch.training.criterion import make_criterion

    inputs = _inputs(40, (6, 20), seed=8)
    live_cap, frame_cap = _capacities(inputs)
    assert live_cap is not None and frame_cap is not None
    cfg = dataclasses.replace(_jax_config(513), hidden_dropout_prob=0.0)
    labels = torch.tensor([1, 3])
    grads = []
    for jax_cfg in (cfg, dataclasses.replace(cfg, spatial_live_capacity=live_cap,
                                             temporal_frame_capacity=frame_cap)):
        model = _port_model(jax_cfg, params).train()
        loss = make_criterion("something")(
            model({k: torch.from_numpy(v) for k, v in inputs.items()}), labels)
        loss.backward()
        grads.append((loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()
                                    if p.grad is not None}))
    (loss, want), (capped_loss, got) = grads
    assert abs(loss - capped_loss) <= 1e-6 and set(got) == set(want)
    for name, grad in want.items():
        torch.testing.assert_close(got[name], grad, **CAP_TOL, msg=name)


def test_capacity_helpers_match_jax(tmp_path):
    from stlt_tpu.data.layout import LayoutDataset as JaxLayoutDataset

    paths, *_ = make_something_fixture(str(tmp_path), num_videos=7, num_frames_range=(4, 40))
    for layout_frames in (4, 32, 64, 512):
        port_cfg = configs.DataConfig(dataset_name="something", layout_num_frames=layout_frames, **paths)
        jax_cfg = jax_configs.DataConfig(dataset_name="something", layout_num_frames=layout_frames, **paths)
        port_ds = port_inference.datasets_factory["layout"](port_cfg)
        jax_ds = JaxLayoutDataset(jax_cfg)
        assert port_ds.max_video_frames() == jax_ds.max_video_frames()
        fcap = configs.frame_capacity_for(port_ds, port_cfg)
        assert fcap == jax_configs.frame_capacity_for(jax_ds, jax_cfg)
        for batch_size in (1, 4, 32):
            for axis in (None, fcap):
                assert (configs.spatial_live_capacity_for(port_ds, port_cfg, batch_size, frame_axis=axis)
                        == jax_configs.spatial_live_capacity_for(jax_ds, jax_cfg, batch_size, frame_axis=axis))
    for live, total in ((300, 1024), (1, 1024), (1024, 1024), (1000, 1024), (5, 100), (0, 64), (130, 4104)):
        assert fe.live_prefix_capacity(live, total) == jax_fe.live_prefix_capacity(live, total)
        assert fe.frame_capacity(live, total) == jax_fe.frame_capacity(live, total)


def _cli_argv(paths, checkpoint, *extra):
    return [
        "--dataset_name", "something", "--dataset_type", "layout", "--model_name", "stlt",
        "--test_dataset_path", paths["dataset_path"], "--labels_path", paths["labels_path"],
        "--videoid2size_path", paths["videoid2size_path"], "--checkpoint_path", checkpoint,
        "--layout_num_frames", "64", "--batch_size", "4", "--hidden_size", "16",
        "--num_attention_heads", "2", "--num_spatial_layers", "1", "--num_temporal_layers", "1",
        *extra,
    ]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A something fixture of 6 clips (4-29 frames, so 65 frame slots hold
    them with room: both levers cut) and a random port STLT saved as .pt."""
    root = tmp_path_factory.mktemp("port_inference")
    paths, *_ = make_something_fixture(str(root), num_videos=6)
    data_cfg = configs.DataConfig(dataset_name="something", layout_num_frames=64, **paths)
    model = models_factory["stlt"](
        configs.make_model_config("stlt", **dict(MODEL_KW, num_classes=4),
                                  layout_num_frames=configs.position_table_rows(data_cfg)),
        torch.Generator().manual_seed(6),
    )
    checkpoint = str(root / "random.pt")
    torch.save(model.state_dict(), checkpoint)
    return paths, checkpoint


@pytest.mark.parametrize("levers", [False, True])
def test_inference_cli_matches_jax_inference(served, levers, caplog):
    from stlt_tpu.inference import inference as jax_inference
    from stlt_tpu.parser import build_parser as jax_build_parser

    paths, checkpoint = served
    argv = _cli_argv(paths, checkpoint, "--platform", "cpu",
                     *(("--use_pallas", "--live_prefix") if levers else ()))
    with caplog.at_level(logging.INFO):
        got = port_inference.main(argv)
    assert "strict=False" not in caplog.text
    want = jax_inference(jax_build_parser("test").parse_args(argv))
    assert set(got) == set(want) == {"stlt_top1_accuracy", "stlt_top5_accuracy"}
    for name in want:
        assert abs(got[name] - want[name]) <= 1e-9, (name, got, want)


def test_inference_cli_caps_only_with_live_prefix_and_use_pallas(served, monkeypatch):
    """--live_prefix takes effect under --use_pallas, as in JAX: the model
    then runs the dataset's frame capacity and the spatial encoder the live
    capacity's rows, in place of 4 x 65 rows and a 65-frame temporal stage
    (which takes the short flash kernel, not the fused projection)."""
    paths, checkpoint = served
    data_cfg = configs.DataConfig(dataset_name="something", layout_num_frames=64, **paths)
    dataset = port_inference.datasets_factory["layout"](data_cfg)
    frame_cap = configs.frame_capacity_for(dataset, data_cfg)
    live_cap = configs.spatial_live_capacity_for(dataset, data_cfg, 4, frame_axis=frame_cap)
    boxes = data_cfg.num_total_boxes
    assert frame_cap is not None and live_cap is not None and live_cap < 4 * frame_cap
    shapes = []
    real = fe.fused_proj_attention

    def spy(x, *args, **kwargs):
        shapes.append(tuple(x.shape[:2]))
        return real(x, *args, **kwargs)

    monkeypatch.setattr(fe, "fused_proj_attention", spy)
    for extra, want in ((("--live_prefix",), {(4 * 65, boxes)}),
                        (("--live_prefix", "--use_pallas"), {(live_cap, boxes), (4, frame_cap)})):
        shapes.clear()
        port_inference.main(_cli_argv(paths, checkpoint, "--platform", "cpu", *extra))
        assert set(shapes) == want, (extra, shapes)


def test_inference_without_a_gpu_raises_and_does_not_fall_back(served):
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU: the default platform runs there")
    paths, checkpoint = served
    for extra in ((), ("--platform", "cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_inference.main(_cli_argv(paths, checkpoint, *extra))
