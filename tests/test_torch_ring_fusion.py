"""The fusion and appearance models under a context ring of two ranks, on
the CPU.

Two gloo ranks, each a subprocess of ``tests/ring_worker.py fusion`` (torch
and the port only), run every case below in one process group, at
``tests/test_torch_appearance_train.py``'s tiny sizes (H 32, 4 heads, one
layer a stage, one fusion layer, R3D depth 10) with 8 layout frames (4 a
rank) and 4 appearance frames of 64 px (4 appearance tokens), as
``tests/test_parallel_fusion.py:60-70`` runs JAX's CACNF on a context
mesh. The layout branch runs on the ring; CAF and CACNF gather its frames
and run the rest replicated (``models/fusion.py``).

- CACNF, CAF and LCF eval logits, every head, against JAX's meshless
  ``apply`` (jitted, ``use_pallas=False``) on weights carried from a seeded
  port model (``tests/test_torch_fusion.py::carried_params``): f32 atol 2e-5,
  rtol 1e-5 (``tests/test_torch_fusion.py``).
- one CACNF train step at dropout 0 on a ragged batch (lengths 3-7 of 8:
  the second shard mostly dead), the gradients after the ring sum against
  ``jax.value_and_grad`` of JAX's meshless loss: loss atol 2e-5, every
  gradient atol = rtol 1e-4 (``tests/test_torch_ring_train_model.py``).
  Summed over the ring, the appearance branch's, the fusion blocks' and the
  heads' gradients would be doubled; read on the gathered axis as a ring
  rank's slice (at its offset, summed over the ring), the extract frame
  would send its cotangent to rank 0 alone, and the ranks' replicated
  gradients would part.
- a CACNF step at dropout 0.1 (the appearance encoder's too) against the
  port's one process on the same batch and seed: train-mode logits atol
  1e-6, gradients atol 1e-5 (``tests/test_torch_data_axis.py``'s limits:
  the same f32 function, the layout branch's gradients summed in another
  order). The layout branch's temporal attention, the one dropout site on
  the ring, hashes with the ring's own seeds as JAX's does (``ops/ring.py``;
  held against JAX's ring in ``tests/test_torch_ring_train.py``), so its
  rate is 0 on both sides here; every other site drops at 0.1.
- two AdamW steps of CACNF at dropout 0.1: both ranks' weights and losses
  equal bit for bit.
- a loaded, frozen CACNF backbone (``load_backbone_path`` with
  ``freeze_backbone``) under the ring: two steps move the three heads
  alone, the backbone stays bit-unchanged, the ranks equal.
- ``resnet3d-transformer`` under the ring (no frame axis: every rank runs
  the whole model): eval logits and a dropout-0.1 step against one process.
- ``training/loop.sync_over_ring_`` on gradients that differ by rank: the
  layout branch's summed, the rest rank 0's on both ranks.
- in one process: ``training/loop.ring_sharded_parameters`` of every
  factory model is its layout branch's parameters, and ``gather_frames``'
  backward on one rank is its slice of the cotangent.

The appearance encoder's torch-default dropout is set per case inside each
worker (0 where JAX is the reference; JAX runs its references
deterministically).
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_layout_batch
from stlt_tpu import configs as jax_configs
from stlt_tpu.models import models_factory as jax_models
from stlt_tpu.training.criterion import make_criterion as jax_make_criterion
from stlt_tpu_torch.configs import make_model_config
from stlt_tpu_torch.models import models_factory
from stlt_tpu_torch.ops import ring
from stlt_tpu_torch.parallel.mesh import Mesh
from stlt_tpu_torch.training.loop import ring_sharded_parameters
from stlt_tpu_torch.utils.convert import jax_params_to_state_dict
from tests.ring_worker import run_fusion_case
from tests.test_torch_fusion import carried_params
from tests.test_torch_ring import _run_ranks
from tests.test_torch_train import TRAIN_HP

RANKS = 2
FRAMES, CLIPS, NUM_CLASSES = 8, 4, 5
KW = dict(num_classes=NUM_CLASSES, unique_categories=4, hidden_size=32, num_attention_heads=4,
          num_spatial_layers=1, num_temporal_layers=1, num_appearance_layers=1,
          num_fusion_layers=1, appearance_num_frames=4, resnet_depth=10, use_pallas=False,
          layout_num_frames=FRAMES, hidden_dropout_prob=0.0)
LOGITS_TOL = dict(atol=2e-5, rtol=1e-5)
LOSS_ATOL = 2e-5
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
ONE_PROCESS_LOGITS_ATOL = 1e-6
ONE_PROCESS_GRAD_ATOL = 1e-5
EVAL_MODELS = ("cacnf", "caf", "lcf")
HEADS = ("layout_classifier.", "appearance_classifier.", "fusion_classifier.")


def fusion_batch(seed: int, length_range):
    """CLIPS clips of FRAMES layout frames (ragged lengths in
    ``length_range``), 4 RGB frames of 64 px, labels, the last row padding."""
    batch = _synthetic_layout_batch(CLIPS, FRAMES, 4, 4, seed=seed, length_range=length_range)
    rng = np.random.default_rng(seed + 1)
    batch["labels"] = rng.integers(0, NUM_CLASSES, CLIPS).astype(np.int32)
    batch["valid"] = np.arange(CLIPS) < CLIPS - 1
    batch["video_frames"] = rng.standard_normal((CLIPS, 4, 64, 64, 3)).astype(np.float32)
    return batch


def _inputs(batch):
    return {k: v for k, v in batch.items() if k not in ("labels", "valid")}


def _jax_model(name, dropout=0.0):
    cls = (jax_configs.AppearanceModelConfig if name.startswith("resnet3d")
           else jax_configs.MultimodalModelConfig)
    fields = {f.name for f in dataclasses.fields(cls)}
    cfg = cls(**{k: v for k, v in dict(KW, hidden_dropout_prob=dropout).items() if k in fields})
    return cfg, jax_models[name](cfg)


def port_state(name, seed, batch):
    """(JAX parameters, the port state_dict of the same weights) of a seeded
    port model (``carried_params``: JAX's tree from ``jax.eval_shape``)."""
    cfg, model = _jax_model(name)
    params = carried_params(name, cfg, model, _inputs(batch), seed)
    return model, params, jax_params_to_state_dict(params)


def fusion_cases(root, seed_state):
    """The cases of ``ring_worker.py fusion`` (and their states and batches
    under ``root``), and for each JAX-held case its JAX model and
    parameters."""
    batches = {"eval": fusion_batch(3, (3, FRAMES)), "ragged": fusion_batch(5, (3, 7)),
               "step": fusion_batch(7, (3, FRAMES))}
    for key, batch in batches.items():
        np.savez(root / f"{key}.npz", **batch)
    jax_side, cases = {}, {}
    for name in EVAL_MODELS:
        model, params, state = port_state(name, seed_state, batches["eval"])
        torch.save(state, root / f"{name}.pt")
        jax_side[name] = (model, params)
        cases[f"eval_{name}"] = dict(kind="eval", model=name, config=KW, state=f"{name}.pt",
                                     batch="eval.npz")
    cases["step_jax"] = dict(kind="step", model="cacnf", config=KW, state="cacnf.pt",
                             batch="ragged.npz", encoder_dropout=0.0)
    dropout = dict(KW, hidden_dropout_prob=0.1)
    cases["step_dropout"] = dict(kind="step", model="cacnf", config=dropout, state="cacnf.pt",
                                 batch="step.npz", quiet_ring_attention=True)
    train_hp = {k: TRAIN_HP[k] for k in ("lr", "weight_decay", "clip_val", "warmup", "total")}
    cases["train"] = dict(kind="train", model="cacnf", config=dropout, state="cacnf.pt",
                          batch="step.npz", steps=2, hp=train_hp)
    cases["frozen"] = dict(kind="train", model="cacnf", state="cacnf.pt", batch="step.npz",
                           steps=2, hp=train_hp,
                           config=dict(dropout, load_backbone_path="loaded", freeze_backbone=True))
    r3d = models_factory["resnet3d-transformer"](make_model_config("resnet3d-transformer", **KW),
                                                 torch.Generator().manual_seed(seed_state))
    torch.save(r3d.state_dict(), root / "r3d.pt")
    for kind in ("eval", "step"):
        cases[f"r3d_{kind}"] = dict(kind=kind, model="resnet3d-transformer", config=dropout,
                                    state="r3d.pt", batch="step.npz")
    cases["sync"] = dict(kind="sync", model="cacnf", config=KW, state="cacnf.pt", batch="step.npz")
    return cases, jax_side, batches


@pytest.fixture(scope="module")
def ring_run(tmp_path_factory):
    """Every case on two ranks (one launch of each rank) and the one-process
    references: ({case: [rank 0's arrays, rank 1's]}, {case: one process's
    arrays}, the JAX side, the batches)."""
    root = tmp_path_factory.mktemp("ring_fusion")
    cases, jax_side, batches = fusion_cases(root, seed_state=13)
    with open(root / "fusion.json", "w") as f:
        json.dump(cases, f)
    _run_ranks("fusion", root, world=RANKS)
    ranks = {label: [dict(np.load(root / f"{label}_{r}.npz")) for r in range(RANKS)]
             for label in cases}
    one = {label: run_fusion_case(root, cases[label])
           for label in ("step_dropout", "r3d_eval", "r3d_step")}
    one["cacnf_state"] = torch.load(root / "cacnf.pt")
    return ranks, one, jax_side, batches


@pytest.mark.parametrize("name", EVAL_MODELS)
def test_fusion_eval_on_the_ring_matches_jax(ring_run, name):
    ranks, _, jax_side, batches = ring_run
    model, params = jax_side[name]
    want = jax.jit(lambda p, x: model.apply({"params": p}, x))(params, _inputs(batches["eval"]))
    heads = [k[len("logits_"):] for k in ranks[f"eval_{name}"][0]]
    assert heads == list(models_factory[name].logit_names)
    for r, got in enumerate(ranks[f"eval_{name}"]):
        for head in heads:
            np.testing.assert_allclose(got[f"logits_{head}"], np.asarray(want[head]), **LOGITS_TOL,
                                       err_msg=f"{name}:{head}, rank {r}")
    for key in ranks[f"eval_{name}"][0]:
        np.testing.assert_array_equal(ranks[f"eval_{name}"][1][key], ranks[f"eval_{name}"][0][key])


def test_cacnf_step_on_the_ring_matches_jax(ring_run):
    ranks, _, jax_side, batches = ring_run
    model, params = jax_side["cacnf"]
    batch = batches["ragged"]
    criterion = jax_make_criterion("something")
    loss, grads = jax.jit(jax.value_and_grad(lambda p: criterion(
        model.apply({"params": p}, _inputs(batch)), batch["labels"], batch["valid"])))(params)
    want = jax_params_to_state_dict(grads)
    for r, got in enumerate(ranks["step_jax"]):
        np.testing.assert_allclose(got["loss"], float(loss), atol=LOSS_ATOL, rtol=0,
                                   err_msg=f"rank {r}'s loss")
        names = [k[len("grad_"):] for k in got if k.startswith("grad_")]
        for name in names:
            np.testing.assert_allclose(got[f"grad_{name}"], want[name].numpy(), **GRAD_TOL,
                                       err_msg=f"rank {r}'s gradient {name}")
        # The layout branch (summed over the ring) and the replicated rest
        # (not summed: a sum would double it) are both there.
        for part in ("backbone.layout_branch.", "backbone.appearance_branch.",
                     "backbone.mm_fusion.", *HEADS):
            assert any(n.startswith(part) for n in names), part
    for key in ranks["step_jax"][0]:
        np.testing.assert_array_equal(ranks["step_jax"][1][key], ranks["step_jax"][0][key])


def test_cacnf_dropout_step_on_the_ring_is_the_one_process_step(ring_run):
    ranks, one, _, _ = ring_run
    want = one["step_dropout"]
    grads = [k for k in want if k.startswith("grad_")]
    named = ("grad_backbone.appearance_branch.transformer.layers.0.linear1.weight",
             "grad_backbone.mm_fusion.0.cross_attn.attn.in_proj_weight",
             "grad_fusion_classifier.fc1.weight")
    assert set(named) <= set(grads)
    for r, got in enumerate(ranks["step_dropout"]):
        assert sorted(k for k in got if k.startswith("grad_")) == sorted(grads)
        for key in (k for k in want if k.startswith("logits_")):
            np.testing.assert_allclose(got[key], want[key], atol=ONE_PROCESS_LOGITS_ATOL, rtol=0,
                                       err_msg=f"rank {r}'s {key} at dropout 0.1")
        np.testing.assert_allclose(got["loss"], want["loss"], atol=ONE_PROCESS_LOGITS_ATOL, rtol=0)
        for key in grads:
            np.testing.assert_allclose(got[key], want[key], atol=ONE_PROCESS_GRAD_ATOL, rtol=0,
                                       err_msg=f"rank {r}'s {key} at dropout 0.1")
    # Dropout acted: the train-mode logits are not the eval ones.
    assert not np.allclose(want["logits_caf"], ranks["eval_cacnf"][0]["logits_caf"], atol=1e-3)


def test_cacnf_ranks_stay_equal_after_two_adamw_steps(ring_run):
    ranks, *_ = ring_run
    a, b = ranks["train"]
    assert np.isfinite(a["losses"]).all()
    np.testing.assert_array_equal(a["losses"], b["losses"])
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert not np.array_equal(a["params_0"], a["params_1"])


def test_frozen_cacnf_backbone_on_the_ring_moves_only_the_heads(ring_run):
    ranks, one, _, _ = ring_run
    a, b = ranks["frozen"]
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    state = one["cacnf_state"]
    model = models_factory["cacnf"](make_model_config("cacnf", **KW))
    offset = 0
    moved = set()
    for name, p in model.named_parameters():
        after = a["params_1"][offset:offset + p.numel()]
        offset += p.numel()
        if not np.array_equal(after, state[name].reshape(-1).numpy()):
            moved.add(name)
    assert offset == a["params_1"].size
    assert not {n for n in moved if n.startswith("backbone.")}, "the frozen backbone moved"
    for head in HEADS:
        assert any(n.startswith(head) for n in moved), f"{head} did not move"


def test_resnet3d_transformer_on_the_ring_is_one_process(ring_run):
    ranks, one, _, _ = ring_run
    for label, atol in (("r3d_eval", ONE_PROCESS_LOGITS_ATOL), ("r3d_step", ONE_PROCESS_GRAD_ATOL)):
        want = one[label]
        for r, got in enumerate(ranks[label]):
            assert sorted(got) == sorted(want)
            for key in want:
                np.testing.assert_allclose(got[key], want[key], atol=atol, rtol=0,
                                           err_msg=f"{label}, rank {r}: {key}")


def test_sync_over_the_ring_sums_the_layout_branch_and_takes_rank_0s_rest(ring_run):
    """``sync_over_ring_`` on gradients that differ by rank, (r + 1)(i + 1)
    for the i-th parameter: the layout branch's summed over the ring (3 (i +
    1)), every other one rank 0's (i + 1), on both ranks. The CPU computes
    the replicated gradients to the same bits on every rank; the card does
    not always (``training/loop.py``), which this case stands in for."""
    ranks, *_ = ring_run
    model = models_factory["cacnf"](make_model_config("cacnf", **KW))
    for r, got in enumerate(ranks["sync"]):
        for i, (name, _) in enumerate(model.named_parameters()):
            factor = 3 if name.startswith("backbone.layout_branch.") else 1
            assert np.all(got[f"grad_{name}"] == factor * (i + 1)), f"rank {r}: {name}"


@pytest.mark.parametrize("name", ["stlt", "resnet3d", "resnet3d-transformer", "lcf", "caf", "cacnf"])
def test_ring_sharded_parameters_are_the_layout_branch(name):
    model = models_factory[name](make_model_config(name, **KW))
    branch = {"stlt": "backbone.", "lcf": "layout_branch.", "caf": "caf_backbone.layout_branch.",
              "cacnf": "backbone.layout_branch."}.get(name)
    want = [p for n, p in model.named_parameters() if branch and n.startswith(branch)]
    got = ring_sharded_parameters(model)
    assert len(got) == len(want) and all(a is b for a, b in zip(got, want))


def test_gathered_frames_backward_is_the_rank_slice(monkeypatch):
    """``gather_frames`` on rank 1 of a ring of 2 (the gather itself
    stubbed: rank 0's frames are zeros): the whole axis in ring order
    forward, and this rank's frames of the cotangent backward, unsummed."""
    mesh = Mesh((1, 1, 2), 1, "none", torch.device("cpu"))
    monkeypatch.setattr(ring, "all_gather", lambda x, mesh, group: torch.stack([torch.zeros_like(x), x]))
    x = torch.randn(3, 4, 5, requires_grad=True)
    y = ring.gather_frames(x, mesh)
    torch.testing.assert_close(y, torch.cat([torch.zeros(3, 4, 5), x.detach()], dim=1), atol=0, rtol=0)
    g = torch.randn(3, 8, 5)
    y.backward(g)
    torch.testing.assert_close(x.grad, g[:, 4:], atol=0, rtol=0)
