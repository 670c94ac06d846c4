"""Training STLT under a context of 2 against the JAX package, on the CPU.

A tiny f32 STLT (hidden 32, 4 heads, one spatial and one temporal layer) at
dropout 0 on a layout batch of 16 layout frames (and of 512 in
``tests/test_torch_ring_train_long.py``; 18 and 514 frame slots, the frame axis padded to a multiple of 2, clips of ragged lengths,
some held by rank 0 alone, some spanning both ranks): four AdamW steps on
two gloo ranks (``tests/ring_worker.py train``), each rank running
``training.loop.make_train_step`` on its frames, against JAX's one-device
``make_train_step`` (``use_pallas=False``) from the same weights on the same
batch, with ``tests/test_torch_train.py``'s hyperparameters (the clip
engages). The port's one-process step is held to JAX the same way.

- losses at atol = rtol = 1e-5 and parameters after the four steps at atol
  1e-5 (both sides compute the same f32 function in another order of sums);
- the first step's gradients as the clip sees them (after the sum over the
  ring) at atol = rtol = 1e-4, the long-clip train tests' gradient limit;
- both ranks' parameters equal bit for bit after every step, and the head's
  gradients equal on both ranks and equal to the one process's (summed
  over the ring they would be doubled).

At dropout 0.1 two ranks take two steps: finite losses, parameters equal
bit for bit, and each rank's frames embeddings in train mode (the two
embedding dropouts and the spatial encoder's attention and tail dropout,
the sites off the ring) equal one process's on its frames within 1e-6:
the sites hash (or draw) at the global coordinates, as JAX's GSPMD step
does (``parallel/mesh.frame_rows``).
"""

import dataclasses
import functools
import json

import jax
import numpy as np
import torch

from __graft_entry__ import _synthetic_layout_batch
from stlt_tpu.configs import StltModelConfig as JaxStltConfig
from stlt_tpu.models import models_factory as jax_models
from stlt_tpu.training.criterion import make_criterion as jax_make_criterion
from stlt_tpu.training.loop import create_train_state, make_train_step as jax_make_train_step
from stlt_tpu.training.optimizer import make_optimizer as jax_make_optimizer
from stlt_tpu_torch.configs import StltModelConfig
from stlt_tpu_torch.models import models_factory
from stlt_tpu_torch.training import loop
from stlt_tpu_torch.training.criterion import make_criterion
from stlt_tpu_torch.training.optimizer import make_optimizer
from stlt_tpu_torch.utils.convert import jax_params_to_state_dict
from tests.test_torch_ring import _run_ranks
from tests.test_torch_train import TRAIN_HP, _no_jax_twin

MODEL_KW = dict(num_classes=7, unique_categories=4, hidden_size=32, num_attention_heads=4,
                num_spatial_layers=1, num_temporal_layers=1)
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
PARAM_ATOL = 1e-5
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
HEAD = "prediction_head."


def _batch(slots: int):
    """B = 4 clips over ``slots`` frame slots (the last one padding), with
    lengths that leave clips on rank 0 alone and clips across both ranks."""
    batch = _synthetic_layout_batch(4, slots, 4, 4, seed=slots, length_range=(3, slots - 1))
    t = slots // 2
    assert (batch["lengths"] <= t).any() and (batch["lengths"] > t).any()
    batch["labels"] = np.random.default_rng(4).integers(0, 7, 4).astype(np.int32)
    batch["valid"] = np.array([True, True, True, False])
    return batch


def _inputs(batch):
    return {k: v for k, v in batch.items() if k not in ("labels", "valid")}


@functools.lru_cache(maxsize=None)
def _jax_run(slots: int):
    """(initial params, first-step gradients, per-step losses, final params)
    of JAX's train step on one device."""
    cfg = JaxStltConfig(layout_num_frames=slots, hidden_dropout_prob=0.0, **MODEL_KW)
    model, criterion = jax_models["stlt"](cfg), jax_make_criterion("something")
    batch = _batch(slots)
    params = model.init(jax.random.PRNGKey(0), _inputs(batch))["params"]
    grads = jax.jit(jax.grad(lambda p: criterion(model.apply({"params": p}, _inputs(batch)),
                                                 batch["labels"], batch["valid"])))(params)
    hp = TRAIN_HP
    tx = jax_make_optimizer(params, learning_rate=hp["lr"], weight_decay=hp["weight_decay"],
                            clip_val=hp["clip_val"], num_warmup_steps=hp["warmup"],
                            num_training_steps=hp["total"])
    state = create_train_state(params, tx)
    step = jax.jit(jax_make_train_step(model, tx, criterion))
    losses = []
    for _ in range(hp["steps"]):
        state, loss = step(state, batch, np.uint32(7))
        losses.append(float(loss))
    return params, jax_params_to_state_dict(grads), losses, jax_params_to_state_dict(state.params)


def _port_config(slots: int, dropout: float = 0.0) -> StltModelConfig:
    return StltModelConfig(layout_num_frames=slots, hidden_dropout_prob=dropout, **MODEL_KW)


def _one_process(slots: int, monkeypatch):
    """(losses, first-step gradients as the clip sees them, final state) of
    the port's step in one process."""
    params, *_ = _jax_run(slots)
    model = models_factory["stlt"](_port_config(slots))
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    first, clip = {}, loop.clip_by_global_norm_

    def clip_spy(ps, clip_val):
        if not first:
            first.update({n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None})
        return clip(ps, clip_val)

    monkeypatch.setattr(loop, "clip_by_global_norm_", clip_spy)
    hp = TRAIN_HP
    optimizer, scheduler = make_optimizer(model, learning_rate=hp["lr"], weight_decay=hp["weight_decay"],
                                          num_warmup_steps=hp["warmup"], num_training_steps=hp["total"])
    step = loop.make_train_step(model, optimizer, scheduler, make_criterion("something"), hp["clip_val"])
    batch = {k: torch.from_numpy(v) for k, v in _batch(slots).items()}
    losses = [float(step(batch, loop.step_generator(0, i))[0]) for i in range(hp["steps"])]
    return losses, first, model.state_dict()


def _two_ranks(tmp_path, slots: int, state, dropout: float = 0.0, steps: int = TRAIN_HP["steps"]):
    """Run ``ring_worker.py train`` on two ranks; returns both ranks' npz."""
    with open(tmp_path / "config.json", "w") as f:
        json.dump(dataclasses.asdict(_port_config(slots, dropout)), f)
    with open(tmp_path / "hp.json", "w") as f:
        json.dump({**TRAIN_HP, "steps": steps, "probe_seed": 12345}, f)
    torch.save(state, tmp_path / "state.pt")
    np.savez(tmp_path / "batch.npz", **_batch(slots))
    _run_ranks("train", tmp_path)
    return [np.load(tmp_path / f"train_{r}.npz") for r in range(2)]


def _check_against_jax(label, losses, grads, final, want_grads, want_losses, want_final):
    np.testing.assert_allclose(losses, want_losses, **LOSS_TOL, err_msg=f"{label} losses")
    assert grads
    for name, g in grads.items():
        if _no_jax_twin(name, "something"):
            continue
        np.testing.assert_allclose(np.asarray(g), want_grads[name].numpy(), **GRAD_TOL,
                                   err_msg=f"{label} first-step gradient {name}")
    for name, w in want_final.items():
        if _no_jax_twin(name, "something"):
            continue
        np.testing.assert_allclose(np.asarray(final[name]), w.numpy(), atol=PARAM_ATOL, rtol=0,
                                   err_msg=f"{label} parameter {name} after {TRAIN_HP['steps']} steps")


def check_context_2_train_steps(tmp_path, monkeypatch, frames: int) -> None:
    """The two-rank steps and the one-process steps against JAX's at
    ``frames`` layout frames (see the module docstring)."""
    slots = frames + 2  # the extract frame, then one slot of padding to a multiple of 2
    params, want_grads, want_losses, want_final = _jax_run(slots)
    losses, grads, final = _one_process(slots, monkeypatch)
    _check_against_jax("one process", losses, grads, final, want_grads, want_losses, want_final)

    ranks = _two_ranks(tmp_path, slots, jax_params_to_state_dict(params))
    for i in range(TRAIN_HP["steps"]):
        np.testing.assert_array_equal(ranks[0][f"params_{i}"], ranks[1][f"params_{i}"],
                                      err_msg=f"the ranks' parameters after step {i + 1}")
    np.testing.assert_array_equal(ranks[0]["losses"], ranks[1]["losses"])
    for r, rank in enumerate(ranks):
        _check_against_jax(f"rank {r}", rank["losses"],
                           {n: rank[f"grad_{n}"] for n in grads},
                           {n: rank[f"final_{n}"] for n in final}, want_grads, want_losses, want_final)
    head = [n for n in grads if n.startswith(HEAD)]
    assert head
    for name in head:
        np.testing.assert_array_equal(ranks[0][f"grad_{name}"], ranks[1][f"grad_{name}"])
        np.testing.assert_allclose(ranks[0][f"grad_{name}"], grads[name].numpy(), **GRAD_TOL,
                                   err_msg=f"{name}: the head's gradient is not the one process's")


def test_context_2_train_steps_match_jax_and_one_process(tmp_path, monkeypatch):
    check_context_2_train_steps(tmp_path, monkeypatch, 16)


def test_context_2_dropout_steps_stay_equal_and_fold_the_rank(tmp_path):
    slots = 18
    state = models_factory["stlt"](_port_config(slots, 0.1), torch.Generator().manual_seed(3)).state_dict()
    ranks = _two_ranks(tmp_path, slots, state, dropout=0.1, steps=2)
    for i in range(2):
        assert np.isfinite(ranks[0][f"params_{i}"]).all()
        np.testing.assert_array_equal(ranks[0][f"params_{i}"], ranks[1][f"params_{i}"])
    assert np.isfinite(ranks[0]["losses"]).all()
    np.testing.assert_array_equal(ranks[0]["losses"], ranks[1]["losses"])
    model = models_factory["stlt"](_port_config(slots, 0.1))
    model.load_state_dict(state, strict=True)
    model.train()
    batch = {k: torch.from_numpy(v) for k, v in _batch(slots).items()}
    with torch.no_grad():
        whole = model.backbone.frames_embeddings(batch, torch.Generator().manual_seed(12345)).numpy()
        model.eval()
        undropped = model.backbone.frames_embeddings(batch).numpy()
    t = slots // 2
    for r, rank in enumerate(ranks):
        np.testing.assert_allclose(rank["probe"], whole[:, r * t:(r + 1) * t], atol=1e-6, rtol=0,
                                   err_msg=f"rank {r}'s frames embeddings at dropout 0.1")
    assert not np.allclose(whole, undropped)  # the sites dropped something
