"""The port's train step and train CLI (plain versions on the CPU) against
the JAX package's.

- Four-step dynamics against ``stlt_tpu.training.loop.make_train_step``
  (``use_pallas=False``, dropout 0) from the same weights on the same batch,
  under CE (Something) and BCE (Action Genome), with the hyperparameters of
  ``tests/test_reference_parity.py::TRAIN_HP``: a learning rate large enough
  that one schedule step of difference moves the parameters far past the
  tolerance, and a clip small enough that it engages (asserted). Losses at
  atol 2e-5 / rtol 1e-5 (the logits' tolerance), parameters at atol 1e-5:
  both sides compute the same f32 functions, in another order of sums.
- The weight-decay mask against JAX's on the converted names.
- The CLI at a tiny width: two epochs, their records, and a best ``.pt``
  that the port's ``predict`` loads with ``strict=True``.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_layout_batch
from stlt_tpu.configs import StltModelConfig as JaxStltConfig
from stlt_tpu.models import models_factory as jax_models
from stlt_tpu.training.criterion import make_criterion as jax_make_criterion
from stlt_tpu.training.loop import create_train_state, make_train_step as jax_make_train_step
from stlt_tpu.training.optimizer import make_optimizer as jax_make_optimizer
from stlt_tpu.training.optimizer import weight_decay_mask as jax_weight_decay_mask
from stlt_tpu_torch import predict as port_predict
from stlt_tpu_torch import train as port_train
from stlt_tpu_torch.configs import StltModelConfig, make_model_config, position_table_rows
from stlt_tpu_torch.configs import DataConfig
from stlt_tpu_torch.models import models_factory
from stlt_tpu_torch.training.criterion import make_criterion
from stlt_tpu_torch.training.loop import make_train_step, step_generator
from stlt_tpu_torch.training.optimizer import make_optimizer, weight_decay_mask
from stlt_tpu_torch.utils.convert import jax_params_to_state_dict, read_state_dict
from tests.fixtures import make_something_fixture

TRAIN_HP = dict(lr=1e-3, weight_decay=0.1, clip_val=0.01, warmup=2, total=8, steps=4)
MODEL_KW = dict(hidden_size=32, num_attention_heads=4, num_spatial_layers=1,
                num_temporal_layers=1, layout_num_frames=16, hidden_dropout_prob=0.0)
NUM_CLASSES = {"something": 7, "action_genome": 6}
CATEGORIES = {"something": 4, "action_genome": 38}


def _no_jax_twin(name: str, dataset: str) -> bool:
    """Parameters without a JAX counterpart, which get no gradient and never
    move: the dead encoder_layer prototype, and score_embeddings when the
    batch has no scores (Something)."""
    return ".encoder_layer." in name or (dataset == "something" and "score_embeddings" in name)


def _batch(dataset: str):
    batch = _synthetic_layout_batch(4, 9, 4, CATEGORIES[dataset], seed=3, length_range=(3, 9))
    rng = np.random.default_rng(4)
    C = NUM_CLASSES[dataset]
    if dataset == "something":
        batch["labels"] = rng.integers(0, C, 4).astype(np.int32)
    else:
        batch["labels"] = (rng.random((4, C)) < 0.4).astype(np.float32)
        batch["scores"] = rng.uniform(0.3, 1.0, batch["categories"].shape).astype(np.float32)
    batch["valid"] = np.array([True, True, True, False])
    return batch


@functools.lru_cache(maxsize=None)
def _jax_run(dataset: str):
    """(initial params, per-step losses, final params) of JAX's train step."""
    cfg = JaxStltConfig(num_classes=NUM_CLASSES[dataset], unique_categories=CATEGORIES[dataset],
                        **MODEL_KW)
    model = jax_models["stlt"](cfg)
    batch = _batch(dataset)
    inputs = {k: v for k, v in batch.items() if k not in ("labels", "valid")}
    params = model.init(jax.random.PRNGKey(0), inputs)["params"]
    hp = TRAIN_HP
    tx = jax_make_optimizer(params, learning_rate=hp["lr"], weight_decay=hp["weight_decay"],
                            clip_val=hp["clip_val"], num_warmup_steps=hp["warmup"],
                            num_training_steps=hp["total"])
    state = create_train_state(params, tx)
    step = jax.jit(jax_make_train_step(model, tx, jax_make_criterion(dataset)))
    losses = []
    for _ in range(hp["steps"]):
        state, loss = step(state, batch, np.uint32(7))
        losses.append(float(loss))
    return params, losses, state.params


def _port_run(dataset: str, warmup: int):
    params, _, _ = _jax_run(dataset)
    cfg = StltModelConfig(num_classes=NUM_CLASSES[dataset], unique_categories=CATEGORIES[dataset],
                          **MODEL_KW)
    model = models_factory["stlt"](cfg)
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    hp = TRAIN_HP
    optimizer, scheduler = make_optimizer(
        model, learning_rate=hp["lr"], weight_decay=hp["weight_decay"],
        num_warmup_steps=warmup, num_training_steps=hp["total"])
    step = make_train_step(model, optimizer, scheduler, make_criterion(dataset), hp["clip_val"])
    batch = {k: torch.from_numpy(v) for k, v in _batch(dataset).items()}
    losses, norms = [], []
    for i in range(hp["steps"]):
        loss, norm = step(batch, step_generator(0, i))
        losses.append(float(loss))
        norms.append(float(norm))
    return model, before, losses, norms


@pytest.mark.parametrize("dataset", ["something", "action_genome"])
def test_train_dynamics_match_jax(dataset):
    _, jax_losses, jax_params = _jax_run(dataset)
    model, before, losses, norms = _port_run(dataset, TRAIN_HP["warmup"])
    assert max(norms) > TRAIN_HP["clip_val"], "the clip never engaged"
    np.testing.assert_allclose(losses, jax_losses, atol=2e-5, rtol=1e-5)
    want = jax_params_to_state_dict(jax_params)
    state = model.state_dict()
    for name, value in state.items():
        if _no_jax_twin(name, dataset):
            torch.testing.assert_close(value, before[name], atol=0, rtol=0, msg=name)
            continue
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)


def test_a_schedule_off_by_one_is_caught():
    _, _, jax_params = _jax_run("something")
    model, _, _, _ = _port_run("something", TRAIN_HP["warmup"] + 1)
    want = jax_params_to_state_dict(jax_params)
    moved = max((model.state_dict()[k] - want[k]).abs().max().item()
                for k in want if not _no_jax_twin(k, "something"))
    assert moved > 1e-4


def test_weight_decay_mask_matches_jax():
    params, _, _ = _jax_run("action_genome")
    mask = jax_weight_decay_mask(params)
    as_arrays = jax.tree_util.tree_map(lambda p, m: np.full(np.shape(p), m, np.float32), params, mask)
    want = {k: bool(v.all()) for k, v in jax_params_to_state_dict(as_arrays).items()
            if not _no_jax_twin(k, "action_genome") and not k.endswith("position_ids")}
    cfg = StltModelConfig(num_classes=6, unique_categories=38, **MODEL_KW)
    got = weight_decay_mask(models_factory["stlt"](cfg))
    assert {k: got[k] for k in want} == want
    assert any(want.values()) and not all(want.values())


def _cli_argv(paths, root, *extra):
    return [
        "--dataset_name", "something", "--dataset_type", "layout", "--model_name", "stlt",
        "--train_dataset_path", paths["dataset_path"], "--val_dataset_path", paths["dataset_path"],
        "--labels_path", paths["labels_path"], "--videoid2size_path", paths["videoid2size_path"],
        "--layout_num_frames", "8", "--batch_size", "4", "--hidden_size", "32",
        "--num_attention_heads", "4", "--num_spatial_layers", "1", "--num_temporal_layers", "1",
        "--epochs", "2", "--warmup_epochs", "1", "--learning_rate", "1e-3",
        "--save_model_path", os.path.join(root, "best.pt"), *extra,
    ]


def test_train_cli_writes_a_strict_checkpoint(tmp_path):
    root = str(tmp_path)
    paths, *_ = make_something_fixture(root, num_videos=10)
    result = port_train.main(_cli_argv(paths, root, "--platform", "cpu"))
    assert result.step == 2 * 3 and [r["epoch"] for r in result.epochs] == [1, 2]
    for record in result.epochs:
        assert record["steps"] == 3 and np.isfinite(record["train_loss"])
        assert set(record["metrics"]) == {"stlt_top1_accuracy", "stlt_top5_accuracy"}
    assert result.epochs[0]["is_best"]

    data_cfg = DataConfig(dataset_name="something", layout_num_frames=8, **paths)
    model = models_factory["stlt"](make_model_config(
        "stlt", num_classes=4, unique_categories=4, hidden_size=32, num_attention_heads=4,
        num_spatial_layers=1, num_temporal_layers=1,
        layout_num_frames=position_table_rows(data_cfg)))
    model.load_state_dict(read_state_dict(os.path.join(root, "best.pt")), strict=True)
    rows = port_predict.main([
        "--dataset_name", "something", "--dataset_type", "layout", "--model_name", "stlt",
        "--test_dataset_path", paths["dataset_path"], "--labels_path", paths["labels_path"],
        "--videoid2size_path", paths["videoid2size_path"],
        "--checkpoint_path", os.path.join(root, "best.pt"), "--layout_num_frames", "8",
        "--batch_size", "4", "--hidden_size", "32", "--num_attention_heads", "4",
        "--num_spatial_layers", "1", "--num_temporal_layers", "1", "--platform", "cpu",
        "--output", os.path.join(root, "predictions.jsonl"),
    ])
    assert len(rows) == 10


@pytest.mark.parametrize("flag", [
    ["--context_parallel", "2"], ["--model_parallel", "2"],
    ["--context_parallel", "4", "--num_processes", "2"], ["--native_decode"],
])
def test_train_cli_refuses_later_slices(tmp_path, flag):
    """What waits raises naming its ROADMAP item. ``--native_decode``
    (A10), the context ring from fewer processes than ranks (A9, ranks per
    process: each process starts its share of the ring's ranks) and
    ``--model_parallel 2`` at 17 frames (A9, model axis: its training half)
    have landed and keep their cases: the CLI's checks now take them (the
    runs themselves are held in ``tests/test_torch_model_axis_cli.py``)."""
    root = str(tmp_path)
    paths, *_ = make_something_fixture(root, num_videos=4)
    argv = _cli_argv(paths, root, "--platform", "cpu", *flag)
    if flag == ["--native_decode"] or "--context_parallel" in flag or "--model_parallel" in flag:
        port_train.check_flags(port_train.build_parser("test").parse_args(argv))
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md item"):
        port_train.main(argv)


def test_train_cli_needs_a_gpu_without_platform(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the CLI would train on it")
    root = str(tmp_path)
    paths, *_ = make_something_fixture(root, num_videos=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train.main(_cli_argv(paths, root))
