"""STLT on a data x context grid (D = 2 rings of C = 2 ranks), on the CPU.

Four gloo ranks, each a subprocess of ``tests/ring_worker.py`` (torch and
the port only), rank g at (data g // 2, context g % 2):

- ``ring_attention`` in the seed mode (lengths, causal, dropout 0.1) on the
  grid, forward and gradients, against JAX's ``ring_attention`` on a
  (2, 1, 2) mesh (``make_mesh(1, context_parallel=2, devices=devs[:4])``)
  within 1e-5: the bits match once the ring's seeds fold the same
  coordinates (``ops/ring._device_seed``);
- four AdamW steps of a tiny f32 STLT at dropout 0 on the grid against
  JAX's one-device ``make_train_step``, at
  ``tests/test_torch_ring_train_model.py``'s limits; the four ranks'
  weights and losses equal bit for bit after every step, and the head's
  gradients are the one process's (summed over the whole grid they would
  be doubled);
- ``predict --num_processes 4 --context_parallel 2 --platform cpu``
  against one process;
- the serving and train CLIs' checks take the grid for STLT and CACNF and
  still refuse what waits, naming its item (CACNF on the grid:
  ``tests/test_torch_grid_fusion.py``).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlt_tpu.ops.ring import ring_attention as jax_ring_attention
from stlt_tpu.parallel.mesh import make_mesh as jax_make_mesh
from stlt_tpu_torch import predict as port_predict
from stlt_tpu_torch import train as port_train
from stlt_tpu_torch.models import models_factory
from stlt_tpu_torch.parser import build_parser
from stlt_tpu_torch.utils.convert import jax_params_to_state_dict
from tests.fixtures import make_something_fixture
from tests.jax_reference import jit_vjp
from tests.test_torch_ring import _run_ranks
from tests.test_torch_ring_train_model import (HEAD, _batch, _check_against_jax, _jax_run,
                                               _port_config)
from tests.test_torch_train import TRAIN_HP

WORLD = 4
OP_TOL = dict(atol=1e-5, rtol=1e-5)


def test_ring_attention_on_the_grid_matches_jax(tmp_path):
    rng = np.random.default_rng(17)
    B, T, N, D, rate, seed = 4, 16, 2, 8, 0.1, 4321
    q, k, v, g = (rng.normal(0, 1, (B, T, N, D)).astype(np.float32) for _ in range(4))
    lengths = np.array([16, 11, 9, 3], np.int32)
    dead = np.arange(T)[None, :] >= lengths[:, None]
    g = np.where(dead[:, :, None, None], 0.0, g).astype(np.float32)  # dead rows: zero cotangent
    np.savez(tmp_path / "inputs.npz", q=q, k=k, v=v, g=g, lengths=lengths, seed=seed, rate=rate)
    _run_ranks("grid_op", tmp_path, world=WORLD)
    parts = [np.load(tmp_path / f"grid_op_{r}.npz") for r in range(WORLD)]
    got = {key: np.concatenate([np.concatenate([parts[2 * d + c][key] for c in range(2)], axis=1)
                                for d in range(2)]) for key in ("out", "dq", "dk", "dv")}

    mesh = jax_make_mesh(1, context_parallel=2, devices=jax.devices()[:4])
    assert dict(mesh.shape) == {"data": 2, "model": 1, "context": 2}
    kw = dict(kv_lengths=jnp.asarray(lengths), causal=True, dropout_seed=jnp.uint32(seed),
              dropout_rate=rate)
    want, grads = jit_vjp(lambda *a: jax_ring_attention(*a, None, mesh, **kw),
                          [jnp.asarray(a) for a in (q, k, v)], jnp.asarray(g))
    want = np.asarray(want)
    live = ~dead
    np.testing.assert_allclose(got["out"][live], want[live], **OP_TOL, err_msg="out")
    for name, w in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(got[name], np.asarray(w), **OP_TOL, err_msg=name)
    # Dropout acted: the output is not the undropped causal attention's.
    logits = np.einsum("btnd,bsnd->bnts", q, k) / np.sqrt(D)
    keys = np.arange(T)
    masked = (keys[None, None, :] > keys[None, :, None]) | (keys[None, None, :] >= lengths[:, None, None])
    p = np.exp(logits - logits.max(-1, keepdims=True)) * ~masked[:, None]
    plain = np.einsum("bnts,bsnd->btnd", p / p.sum(-1, keepdims=True), v)
    assert not np.allclose(got["out"][live], plain[live], atol=1e-3)


def test_grid_train_steps_match_jax_and_stay_equal(tmp_path, monkeypatch):
    slots = 18  # 16 layout frames, the extract frame, one slot of padding
    params, want_grads, want_losses, want_final = _jax_run(slots)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(dataclasses.asdict(_port_config(slots)), f)
    with open(tmp_path / "hp.json", "w") as f:
        json.dump({**TRAIN_HP, "probe_seed": 12345}, f)
    torch.save(jax_params_to_state_dict(params), tmp_path / "state.pt")
    np.savez(tmp_path / "batch.npz", **_batch(slots))
    _run_ranks("grid_train", tmp_path, world=WORLD)
    ranks = [np.load(tmp_path / f"grid_train_{r}.npz") for r in range(WORLD)]
    for r in range(1, WORLD):
        for i in range(TRAIN_HP["steps"]):
            np.testing.assert_array_equal(ranks[r][f"params_{i}"], ranks[0][f"params_{i}"],
                                          err_msg=f"rank {r}'s parameters after step {i + 1}")
        np.testing.assert_array_equal(ranks[r]["losses"], ranks[0]["losses"])
    grads = [n[len("grad_"):] for n in ranks[0].files if n.startswith("grad_")]
    final = [n[len("final_"):] for n in ranks[0].files if n.startswith("final_")]
    _check_against_jax("grid rank 0", ranks[0]["losses"], {n: ranks[0][f"grad_{n}"] for n in grads},
                       {n: ranks[0][f"final_{n}"] for n in final}, want_grads, want_losses, want_final)
    head = [n for n in grads if n.startswith(HEAD)]
    assert head
    for name in head:  # the whole batch's head gradient, not twice it
        np.testing.assert_allclose(ranks[0][f"grad_{name}"], want_grads[name].numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


def test_predict_on_the_grid_writes_the_single_process_output(tmp_path):
    paths, *_ = make_something_fixture(str(tmp_path), num_videos=8)
    common = ["--dataset_name", "something", "--dataset_type", "layout", "--model_name", "stlt",
              "--test_dataset_path", paths["dataset_path"], "--labels_path", paths["labels_path"],
              "--videoid2size_path", paths["videoid2size_path"], "--layout_num_frames", "8",
              "--batch_size", "4", "--hidden_size", "32", "--num_attention_heads", "4",
              "--num_spatial_layers", "1", "--num_temporal_layers", "1", "--platform", "cpu"]
    args = build_parser("test").parse_args(common)
    from stlt_tpu_torch.data import datasets_factory

    data_cfg = port_predict.build_data_config(args, train=False, dataset_path=paths["dataset_path"])
    model_cfg = port_predict.build_model_config(args, datasets_factory["layout"](data_cfg), data_cfg)
    ckpt = str(tmp_path / "random.pt")
    torch.save(models_factory["stlt"](model_cfg, torch.Generator().manual_seed(9)).state_dict(), ckpt)
    common += ["--checkpoint_path", ckpt]
    single = port_predict.main(common + ["--output", str(tmp_path / "one.jsonl")])
    with open(tmp_path / "argv.json", "w") as f:
        json.dump(common + ["--output", str(tmp_path / "grid.jsonl"), "--context_parallel", "2",
                            "--num_processes", str(WORLD)], f)
    _run_ranks("predict", tmp_path, world=WORLD)
    with open(tmp_path / "grid.jsonl") as f:
        grid = [json.loads(line) for line in f]
    assert len(grid) == len(single) == 8
    for a, b in zip(grid, single):
        assert a["video_id"] == b["video_id"]
        assert [t["label_id"] for t in a["top_k"]] == [t["label_id"] for t in b["top_k"]]
        np.testing.assert_allclose([t["score"] for t in a["top_k"]], [t["score"] for t in b["top_k"]],
                                   atol=1e-5)


COMMON = ["--dataset_name", "something", "--dataset_type", "layout", "--coordinator_address",
          "localhost:1", "--save_model_path", "best.pt"]


@pytest.mark.parametrize("check", [port_predict.check_flags, port_train.check_flags])
def test_cli_checks_take_the_grid_for_stlt(check):
    check(build_parser("test").parse_args(
        COMMON + ["--model_name", "stlt", "--context_parallel", "2", "--num_processes", "4",
                  "--batch_size", "4"]))


@pytest.mark.parametrize("extra,item", [
    pytest.param(["--model_name", "cacnf", "--dataset_type", "multimodal"], None,
                 id="extra0-A9 \\(fusion models under the ring\\)"),
    (["--model_name", "stlt", "--model_parallel", "2"], "A9 \\(model axis\\)"),
    (["--model_name", "stlt", "--native_decode"], "A10"),
])
@pytest.mark.parametrize("check", [port_predict.check_flags, port_train.check_flags])
def test_cli_checks_on_the_grid_refuse_what_waits(check, extra, item):
    """What waits raises naming its item; the case whose item is None (CACNF
    on the grid) waited for A9 (fusion models under the ring), which has
    landed, and keeps its id: both checks now take it."""
    args = build_parser("test").parse_args(COMMON + ["--context_parallel", "2", "--num_processes", "4",
                                                     "--batch_size", "4", *extra])
    if item is None:
        check(args)
        return
    with pytest.raises(NotImplementedError, match=f"waits for ROADMAP.md item {item}"):
        check(args)


def test_grid_batch_must_divide_the_data_axis():
    """D = 2 rings of a batch of 3: the data axis does not divide it."""
    args = build_parser("test").parse_args(COMMON + ["--model_name", "stlt", "--context_parallel", "2",
                                                     "--num_processes", "4", "--batch_size", "3"])
    with pytest.raises(ValueError, match="does not divide the data axis"):
        port_predict.check_flags(args)
