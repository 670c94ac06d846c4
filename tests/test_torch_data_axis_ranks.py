"""The data axis on two gloo ranks, on the CPU (``tests/ring_worker.py``).

- (b) four AdamW steps of a tiny f32 STLT at dropout 0 on two data ranks
  (``data_train``: each rank its two rows of a batch of four, the last one
  padding) against JAX's step on a two-device data mesh
  (``stlt_tpu.training.loop.compile_steps`` over ``make_mesh(model_parallel=1,
  devices=jax.devices()[:2])``, ``use_pallas=False``), with
  ``tests/test_torch_ring_train_model.py``'s limits: losses at 1e-5,
  parameters after the four steps at 1e-5, the first step's gradients as
  the clip sees them (after the all-reduce) at 1e-4; both ranks' weights
  equal bit for bit after every step and their losses equal;
- (c) ``train --num_processes 2 --platform cpu`` at dropout 0.1 (one epoch
  of two steps, ``--grad_accum_steps 2`` too) against one process: the
  epoch loss within 1e-5, the coordinator's ``best.msgpack`` within 1e-5
  of the one process's (the key projection's bias, ``k_proj/bias``, within
  ``KEY_BIAS_ATOL``, as in ``tests/test_torch_ring_train_cli.py``), the
  coordinator alone writing the checkpoint and the log; ``predict
  --num_processes 2`` writes the one process's JSON lines; ``inference
  --num_processes 2`` returns the one process's metrics on the
  coordinator;
- the loader's rows: every rank's rows of each global batch concatenate to
  the one process's batch, a rank whose whole slice is padding still gets
  a batch, and every rank carries the global batch's valid count.
"""

import dataclasses
import json
import os
import re

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from stlt_tpu.configs import StltModelConfig as JaxStltConfig
from stlt_tpu.models import models_factory as jax_models
from stlt_tpu.parallel.mesh import make_mesh as jax_make_mesh
from stlt_tpu.parallel.mesh import set_active_mesh as jax_set_active_mesh
from stlt_tpu.training.criterion import make_criterion as jax_make_criterion
from stlt_tpu.training.loop import compile_steps, create_train_state
from stlt_tpu.training.optimizer import make_optimizer as jax_make_optimizer
from stlt_tpu_torch import inference as port_inference
from stlt_tpu_torch import predict as port_predict
from stlt_tpu_torch import train as port_train
from stlt_tpu_torch.configs import DataConfig
from stlt_tpu_torch.data import collaters_factory, datasets_factory
from stlt_tpu_torch.data.loader import VALID_TOTAL, Loader
from stlt_tpu_torch.models import models_factory
from stlt_tpu_torch.parser import build_parser
from stlt_tpu_torch.utils.convert import jax_params_to_state_dict
from tests.fixtures import make_something_fixture
from tests.test_torch_ring import _run_ranks
from tests.test_torch_ring_train_cli import KEY_BIAS_ATOL
from tests.test_torch_ring_train_model import (
    GRAD_TOL,
    HEAD,
    LOSS_TOL,
    PARAM_ATOL,
    _batch,
    _check_against_jax,
    _inputs,
    _jax_run,
    _port_config,
)
from tests.test_torch_train import TRAIN_HP

SLOTS = 18


def _jax_data_mesh_run(slots: int):
    """(per-step losses, final params) of JAX's train step jitted over a
    two-device data mesh, from ``_jax_run``'s initial params."""
    # Host copies: the jitted step donates its state, which must not take
    # _jax_run's cached arrays with it.
    params = jax.tree_util.tree_map(np.array, _jax_run(slots)[0])
    cfg = _port_config(slots)
    fields = {f.name for f in dataclasses.fields(JaxStltConfig)}
    model = jax_models["stlt"](JaxStltConfig(**{k: v for k, v in dataclasses.asdict(cfg).items()
                                                if k in fields}))
    criterion = jax_make_criterion("something")
    hp = TRAIN_HP
    tx = jax_make_optimizer(params, learning_rate=hp["lr"], weight_decay=hp["weight_decay"],
                            clip_val=hp["clip_val"], num_warmup_steps=hp["warmup"],
                            num_training_steps=hp["total"])
    batch = _batch(slots)
    mesh = jax_make_mesh(model_parallel=1, devices=jax.devices()[:2])
    assert dict(mesh.shape) == {"data": 2, "model": 1, "context": 1}
    losses = []
    try:
        state = create_train_state(params, tx)
        steps = compile_steps(mesh, model, tx, criterion, state=state, batch_template=batch)
        state = jax.device_put(state, steps.state_sharding)
        for _ in range(hp["steps"]):
            state, loss = steps.train_step(state, batch, np.uint32(7))
            losses.append(float(loss))
        final = jax_params_to_state_dict(jax.device_get(state.params))
    finally:
        jax_set_active_mesh(None)
    return losses, final


def test_two_data_ranks_match_jax_data_mesh(tmp_path):
    params, want_grads, _, _ = _jax_run(SLOTS)
    want_losses, want_final = _jax_data_mesh_run(SLOTS)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(dataclasses.asdict(_port_config(SLOTS)), f)
    with open(tmp_path / "hp.json", "w") as f:
        json.dump({**TRAIN_HP, "probe_seed": 12345}, f)
    torch.save(jax_params_to_state_dict(params), tmp_path / "state.pt")
    np.savez(tmp_path / "batch.npz", **_batch(SLOTS))
    _run_ranks("data_train", tmp_path)
    ranks = [np.load(tmp_path / f"data_train_{r}.npz") for r in range(2)]
    for i in range(TRAIN_HP["steps"]):
        np.testing.assert_array_equal(ranks[0][f"params_{i}"], ranks[1][f"params_{i}"],
                                      err_msg=f"the ranks' parameters after step {i + 1}")
    np.testing.assert_array_equal(ranks[0]["losses"], ranks[1]["losses"])
    names = [k[len("grad_"):] for k in ranks[0].files if k.startswith("grad_")]
    finals = [k[len("final_"):] for k in ranks[0].files if k.startswith("final_")]
    assert any(n.startswith(HEAD) for n in names)
    for r, rank in enumerate(ranks):
        _check_against_jax(f"data rank {r}", rank["losses"], {n: rank[f"grad_{n}"] for n in names},
                           {n: rank[f"final_{n}"] for n in finals}, want_grads, want_losses,
                           want_final)
    assert LOSS_TOL and GRAD_TOL and PARAM_ATOL  # the limits of the context-axis test


# --- (c) the CLIs on two ranks -------------------------------------------------------


def _train_argv(paths, *extra):
    return [
        "--dataset_name", "something", "--dataset_type", "layout", "--model_name", "stlt",
        "--train_dataset_path", paths["dataset_path"], "--val_dataset_path", paths["dataset_path"],
        "--labels_path", paths["labels_path"], "--videoid2size_path", paths["videoid2size_path"],
        "--layout_num_frames", "8", "--batch_size", "4", "--hidden_size", "32",
        "--num_attention_heads", "4", "--num_spatial_layers", "1", "--num_temporal_layers", "1",
        "--hidden_dropout_prob", "0.1", "--epochs", "1", "--learning_rate", "1e-3",
        "--platform", "cpu", *extra,
    ]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("levers", [[], ["--grad_accum_steps", "2"]])
def test_train_cli_on_two_data_ranks_writes_the_single_process_checkpoint(tmp_path, levers):
    paths, *_ = make_something_fixture(str(tmp_path), num_videos=8)
    single = port_train.main(_train_argv(paths, *levers, "--save_model_path",
                                         str(tmp_path / "one.msgpack")))
    assert single.step == 2 and single.epochs[0]["is_best"]
    with open(tmp_path / "argv.json", "w") as f:
        json.dump(_train_argv(paths, *levers, "--num_processes", "2", "--save_model_path",
                              str(tmp_path / "best_{rank}.msgpack")), f)
    outs = _run_ranks("train_cli", tmp_path)
    with open(tmp_path / "log_0.txt") as f:
        logged = {0: f.read(), 1: outs[1]}
    for r in range(2):
        assert f"rank {r} of 2 on cpu, backend gloo" in logged[r], logged[r]
    assert os.path.exists(tmp_path / "best_0.msgpack") and not os.path.exists(tmp_path / "best_1.msgpack")
    assert not os.path.exists(tmp_path / "log_1.txt")
    loss = float(re.search(r"Epoch 1: train loss ([0-9.]+)", logged[0]).group(1))
    assert abs(loss - single.epochs[0]["train_loss"]) < 1e-5
    with open(tmp_path / "one.msgpack", "rb") as f:
        want = dict(_leaves(serialization.msgpack_restore(f.read())))
    with open(tmp_path / "best_0.msgpack", "rb") as f:
        got = dict(_leaves(serialization.msgpack_restore(f.read())))
    assert set(got) == set(want)
    for name, value in got.items():
        # The key projection's bias (flax's k_proj/bias): see KEY_BIAS_ATOL.
        atol = KEY_BIAS_ATOL if name.endswith("k_proj/bias") else 1e-5
        np.testing.assert_allclose(value, want[name], atol=atol, rtol=1e-5, err_msg=name)


def _serving_argv(paths, ckpt, *extra):
    return ["--dataset_name", "something", "--dataset_type", "layout", "--model_name", "stlt",
            "--test_dataset_path", paths["dataset_path"], "--labels_path", paths["labels_path"],
            "--videoid2size_path", paths["videoid2size_path"], "--layout_num_frames", "8",
            "--batch_size", "4", "--hidden_size", "32", "--num_attention_heads", "4",
            "--num_spatial_layers", "1", "--num_temporal_layers", "1", "--platform", "cpu",
            "--checkpoint_path", ckpt, *extra]


def test_predict_and_inference_on_two_data_ranks(tmp_path):
    """Seven clips in batches of four: the second global batch has three
    real rows, rank 1 one of them and a padding row."""
    paths, *_ = make_something_fixture(str(tmp_path), num_videos=7)
    ckpt = str(tmp_path / "random.pt")
    args = build_parser("test").parse_args(_serving_argv(paths, ckpt))
    data_cfg = port_predict.build_data_config(args, train=False, dataset_path=paths["dataset_path"])
    model_cfg = port_predict.build_model_config(args, datasets_factory["layout"](data_cfg), data_cfg)
    torch.save(models_factory["stlt"](model_cfg, torch.Generator().manual_seed(5)).state_dict(), ckpt)
    single = port_predict.main(_serving_argv(paths, ckpt, "--output", str(tmp_path / "one.jsonl")))
    metrics = port_inference.main(_serving_argv(paths, ckpt))
    with open(tmp_path / "argv.json", "w") as f:
        json.dump(_serving_argv(paths, ckpt, "--output", str(tmp_path / "two.jsonl"),
                                "--num_processes", "2"), f)
    outs = _run_ranks("predict", tmp_path)
    for r, out in enumerate(outs):
        assert f"rank {r} of 2 on cpu, backend gloo" in out, out
    with open(tmp_path / "one.jsonl") as f:
        one = f.read()
    with open(tmp_path / "two.jsonl") as f:
        two = f.read()
    assert len(single) == 7 and len(two.splitlines()) == 7
    assert two == one
    with open(tmp_path / "argv.json", "w") as f:
        json.dump(_serving_argv(paths, ckpt, "--num_processes", "2"), f)
    outs = _run_ranks("inference", tmp_path)
    got = [json.loads((tmp_path / f"inference_{r}.json").read_text()) for r in range(2)]
    assert got[1] == {} and got[0] == {k: float(v) for k, v in metrics.items()}


def test_loader_rows_are_the_single_process_batches(tmp_path):
    paths, *_ = make_something_fixture(str(tmp_path), num_videos=9)
    cfg = DataConfig(dataset_name="something", train=True, layout_num_frames=8, **paths)
    dataset = datasets_factory["layout"](cfg)
    collate = collaters_factory["layout"](cfg)
    one = list(Loader(dataset, 8, collate, shuffle=True, seed=3, prefetch=0))
    ranks = [list(Loader(dataset, 8, collate, shuffle=True, seed=3, prefetch=0, rows=(r * 2, r * 2 + 2)))
             for r in range(4)]
    assert len(one) == 2 and all(len(batches) == 2 for batches in ranks)
    for b, whole in enumerate(one):
        for key, value in whole.items():
            got = np.concatenate([ranks[r][b][key] for r in range(4)])
            if key == "valid":
                np.testing.assert_array_equal(got, value)
            else:  # pad rows repeat a real sample of the batch, not row 0 of the rank
                np.testing.assert_array_equal(got[whole["valid"]], value[whole["valid"]], err_msg=key)
        for r in range(4):
            assert int(ranks[r][b][VALID_TOTAL]) == int(whole["valid"].sum())
    # The last global batch holds one real clip: ranks 1-3 hold padding alone.
    assert [bool(ranks[r][1]["valid"].any()) for r in range(4)] == [True, False, False, False]
