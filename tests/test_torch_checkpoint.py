"""The port's step checkpoints (``train --resume_dir``,
``stlt_tpu_torch/training/checkpoint.py``), the train CLI's
``--profile_dir`` and its ``.msgpack`` defaults, on the CPU.

- An interrupted-then-resumed train run (``--resume_dir``, with
  ``--grad_accum_steps 2 --remat`` at dropout 0.1) equals an uninterrupted
  one bit for bit: weights, AdamW state, learning rate and epoch 2's loss;
  the newest three step checkpoints are kept, and a failed write leaves the
  previous ones whole.
- ``--profile_dir`` writes a Chrome trace of steps START..STOP-1; a bad
  ``--profile_window`` is refused in JAX's words.
- The train CLI runs with the parser's ``.msgpack`` defaults, JAX's
  ``load_params`` takes the model and the backbone it wrote, ``predict``
  serves the model with its own default ``--checkpoint_path``, and the
  backbone fine-tunes frozen from its ``.msgpack``.
(The ``.msgpack`` format itself: ``tests/test_torch_msgpack.py``.)
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from stlt_tpu.configs import StltModelConfig as JaxStltConfig
from stlt_tpu.models import models_factory as jax_models
from stlt_tpu.training.checkpoint import load_params as jax_load_params
from stlt_tpu_torch import predict as port_predict
from stlt_tpu_torch import train as port_train
from stlt_tpu_torch.configs import DataConfig, StltModelConfig, position_table_rows
from stlt_tpu_torch.models import models_factory
from stlt_tpu_torch.training import checkpoint as ckpt
from stlt_tpu_torch.utils.convert import jax_params_to_state_dict, read_state_dict
from tests.fixtures import make_something_fixture
from tests.test_torch_model import _inputs as stlt_inputs


# --- step checkpoints ------------------------------------------------------------


def _argv(paths, root, *extra):
    return [
        "--dataset_name", "something", "--dataset_type", "layout", "--model_name", "stlt",
        "--train_dataset_path", paths["dataset_path"], "--val_dataset_path", paths["dataset_path"],
        "--labels_path", paths["labels_path"], "--videoid2size_path", paths["videoid2size_path"],
        "--layout_num_frames", "8", "--batch_size", "4", "--hidden_size", "32",
        "--num_attention_heads", "4", "--num_spatial_layers", "1", "--num_temporal_layers", "1",
        "--epochs", "2", "--warmup_epochs", "1", "--learning_rate", "1e-3", "--platform", "cpu",
        *extra,
    ]


class Interrupted(Exception):
    pass


def test_resumed_run_equals_an_uninterrupted_one(tmp_path, monkeypatch):
    root = str(tmp_path)
    paths, *_ = make_something_fixture(root, num_videos=10)
    levers = ["--grad_accum_steps", "2", "--remat"]
    whole = port_train.main(_argv(paths, root, *levers, "--resume_dir", f"{root}/whole",
                                  "--save_model_path", f"{root}/whole.msgpack"))
    assert [r["epoch"] for r in whole.epochs] == [1, 2] and whole.step == 6

    resume = ["--resume_dir", f"{root}/cut", "--save_model_path", f"{root}/cut.msgpack"]
    save = ckpt.save_train_state

    def save_then_stop(*args, **kw):
        path = save(*args, **kw)
        raise Interrupted(path)

    monkeypatch.setattr(ckpt, "save_train_state", save_then_stop)
    with pytest.raises(Interrupted):
        port_train.main(_argv(paths, root, *levers, *resume))
    monkeypatch.setattr(ckpt, "save_train_state", save)
    assert ckpt.steps(f"{root}/cut") == [3]
    resumed = port_train.main(_argv(paths, root, *levers, *resume))
    assert [r["epoch"] for r in resumed.epochs] == [2] and resumed.step == 6
    assert ckpt.steps(f"{root}/cut") == [3, 6]

    assert resumed.epochs[0]["train_loss"] == whole.epochs[1]["train_loss"]
    for key, value in whole.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[key], value), key
    want, got = whole.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert [g["lr"] for g in got["param_groups"]] == [g["lr"] for g in want["param_groups"]]
    assert set(got["state"]) == set(want["state"])
    for index, state in want["state"].items():
        for slot, value in state.items():
            mine = got["state"][index][slot]
            assert mine.device == value.device and torch.equal(mine, value), (index, slot)


def test_step_checkpoints_keep_the_newest_three_and_survive_a_failed_write(tmp_path, monkeypatch):
    model = torch.nn.Linear(3, 2)
    optimizer = torch.optim.AdamW(model.parameters(), lr=1.0)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda s: 1.0)
    for step in range(1, 6):
        ckpt.save_train_state(str(tmp_path), step, step, model, optimizer, scheduler)
    assert ckpt.steps(str(tmp_path)) == [3, 4, 5]
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(ckpt.path_of(str(tmp_path), s))
                                            for s in (3, 4, 5)]
    want = {k: v.clone() for k, v in model.state_dict().items()}

    def torn_write(obj, path):
        with open(path, "wb") as f:
            f.write(b"torn")
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.torch, "save", torn_write)
    with torch.no_grad():
        model.weight.add_(1.0)
    with pytest.raises(OSError):
        ckpt.save_train_state(str(tmp_path), 6, 6, model, optimizer, scheduler)
    monkeypatch.undo()
    assert ckpt.steps(str(tmp_path)) == [3, 4, 5]
    assert ckpt.restore_train_state(str(tmp_path), model, optimizer, scheduler) == 5
    assert all(torch.equal(model.state_dict()[k], v) for k, v in want.items())
    assert ckpt.restore_train_state(str(tmp_path / "none"), model, optimizer, scheduler) is None


# --- the profiler ------------------------------------------------------------------


def test_profile_dir_writes_a_trace_of_the_window(tmp_path):
    root = str(tmp_path)
    paths, *_ = make_something_fixture(root, num_videos=10)
    port_train.main(_argv(paths, root, "--epochs", "1", "--profile_dir", f"{root}/trace",
                          "--profile_window", "1,3", "--save_model_path", f"{root}/best.pt"))
    files = os.listdir(f"{root}/trace")
    assert files == ["train_steps_1_3.json"]
    with open(f"{root}/trace/{files[0]}") as f:
        events = json.load(f)["traceEvents"]
    assert sum(e.get("name") == "train_step" for e in events) == 2


@pytest.mark.parametrize("window", ["3,3", "-1,2", "4,1"])
def test_a_bad_profile_window_is_refused_in_jax_words(window):
    args = port_train.build_parser("test").parse_args(
        ["--dataset_name", "something", "--dataset_type", "layout", "--model_name", "stlt",
         "--profile_dir", "trace", f"--profile_window={window}"])
    with pytest.raises(ValueError, match="--profile_window must be START,STOP with 0 <= START < STOP"):
        port_train.check_flags(args)


# --- the CLIs with the parser's defaults --------------------------------------------


def test_train_cli_with_msgpack_defaults_writes_what_jax_and_predict_read(tmp_path, monkeypatch):
    root = str(tmp_path)
    paths, *_ = make_something_fixture(root, num_videos=10)
    monkeypatch.chdir(root)
    argv = _argv(paths, root, "--save_backbone_path", "models/backbone.msgpack")
    result = port_train.main(argv)
    assert result.epochs[0]["is_best"] and os.path.exists("models/best.msgpack")

    data_cfg = DataConfig(dataset_name="something", layout_num_frames=8, **paths)
    jax_cfg = JaxStltConfig(num_classes=4, unique_categories=4, hidden_size=32,
                            num_attention_heads=4, num_spatial_layers=1, num_temporal_layers=1,
                            layout_num_frames=position_table_rows(data_cfg))
    shapes = jax.eval_shape(lambda: jax_models["stlt"](jax_cfg).init(
        jax.random.PRNGKey(0), stlt_inputs(False)))["params"]
    template = jax.tree_util.tree_map(lambda t: np.zeros(t.shape, t.dtype), shapes)
    params = jax_load_params("models/best.msgpack", template)
    backbone = jax_load_params("models/backbone.msgpack", template["backbone"])
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(backbone), jax.tree_util.tree_leaves(params["backbone"])))
    port = models_factory["stlt"](StltModelConfig(**dataclasses.asdict(jax_cfg)))
    port.load_state_dict(jax_params_to_state_dict(params), strict=True)

    rows = port_predict.main([
        "--dataset_name", "something", "--dataset_type", "layout", "--model_name", "stlt",
        "--test_dataset_path", paths["dataset_path"], "--labels_path", paths["labels_path"],
        "--videoid2size_path", paths["videoid2size_path"], "--layout_num_frames", "8",
        "--batch_size", "4", "--hidden_size", "32", "--num_attention_heads", "4",
        "--num_spatial_layers", "1", "--num_temporal_layers", "1", "--platform", "cpu",
        "--output", "predictions.jsonl",
    ])
    assert len(rows) == 10

    # The saved backbone fine-tunes frozen from its .msgpack.
    frozen = port_train.main(_argv(paths, root, "--epochs", "1", "--save_model_path",
                                   "models/tuned.msgpack", "--load_backbone_path",
                                   "models/backbone.msgpack", "--freeze_backbone"))
    want = read_state_dict("models/backbone.msgpack", frozen.model.backbone)
    for key, value in frozen.model.backbone.state_dict().items():
        assert torch.equal(value, want[key]), key
