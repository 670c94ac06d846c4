"""Training under the model axis over gloo ranks on the CPU, against one
process and against the JAX package.

Each rank is a subprocess of ``tests/ring_worker.py model_axis`` (torch and
the port only, a ``file://`` store under ``tmp_path``): the full weights
loaded, cut to the rank's shards (``parallel/sharding.shard_model_``), then
``training.loop``'s step, its gradients and parameters gathered to full
tensors; tiny f32 models (``tests/test_torch_ring_fusion.py``'s sizes):

- (a) STLT on M = 2 model ranks at dropout 0.1: one step's gradients as the
  clip sees them within 1e-5 of one process's, two AdamW steps' parameters
  within 1e-6 (the key third of ``in_proj_bias`` within
  ``KEY_BIAS_ATOL``: its gradient is zero up to rounding, which AdamW's
  normalised step turns into moves of up to the learning rate), and the
  ranks' parameters (the replicated ones too) equal bit for bit;
- (b) STLT at dropout 0 against JAX's ``compile_steps`` train step on
  ``make_mesh(model_parallel=2)``: the loss within 1e-5 and the gradients
  (JAX's jitted ``value_and_grad`` on the same mesh) within 1e-4;
- (c) CACNF at dropout 0.1 (rows 3 and 4 in its encoders, rows 6 and 7 in
  its cross-attention, all at the head base): one step's loss and
  gradients within 1e-6 / 1e-5 of one process's, the ranks bit for bit;
  LCF, CAF, ``resnet3d`` and ``resnet3d-transformer`` likewise (the six
  factory models each take a model-axis step);
- (d) STLT on a data 2 x model 2 grid (four ranks) with ``grad_accum`` 2
  and ``remat``: two steps within 1e-6 of one process's.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import torch

from stlt_tpu.configs import StltModelConfig as JaxStltConfig
from stlt_tpu.models import models_factory as jax_models
from stlt_tpu.parallel.mesh import make_mesh as jax_make_mesh
from stlt_tpu.parallel.mesh import set_active_mesh as jax_set_active_mesh
from stlt_tpu.parallel.sharding import params_shardings
from stlt_tpu.training.criterion import make_criterion as jax_make_criterion
from stlt_tpu.training.loop import compile_steps, create_train_state
from stlt_tpu.training.optimizer import make_optimizer as jax_make_optimizer
from stlt_tpu_torch.configs import make_model_config
from stlt_tpu_torch.models import models_factory
from stlt_tpu_torch.utils.convert import jax_params_to_state_dict
from tests.ring_worker import run_fusion_case
from tests.test_torch_ring import ROOT, WORKER
from tests.test_torch_ring_fusion import KW, _inputs, fusion_batch
from tests.test_torch_ring_train_cli import KEY_BIAS_ATOL
from tests.test_torch_train import TRAIN_HP

STLT_KW = dict(num_classes=KW["num_classes"], unique_categories=4, hidden_size=32, num_attention_heads=4,
               num_spatial_layers=1, num_temporal_layers=1, layout_num_frames=KW["layout_num_frames"])
HP = dict(TRAIN_HP, steps=2)
ONE_PROCESS_PARAMS = dict(atol=1e-6, rtol=1e-6)
ONE_PROCESS_GRADS = dict(atol=1e-5, rtol=1e-5)
JAX_LOSS = dict(atol=1e-5, rtol=1e-5)
JAX_GRADS = dict(atol=1e-4, rtol=1e-4)


def _stlt_batch(tmp_path):
    batch = {k: v for k, v in fusion_batch(31, (3, KW["layout_num_frames"])).items() if k != "video_frames"}
    np.savez(tmp_path / "stlt_batch.npz", **batch)
    return batch


def _params(flat, config, name="stlt"):
    """A flat parameter vector as {name: array}, in the model's order."""
    model = models_factory[name](make_model_config(name, **config))
    out, offset = {}, 0
    for n, p in model.named_parameters():
        out[n] = flat[offset:offset + p.numel()].reshape(p.shape)
        offset += p.numel()
    assert offset == flat.size
    return out


def _check_params(got, want, label):
    for name, value in got.items():
        ref = want[name]
        if name.endswith("self_attn.in_proj_bias"):  # its key third: see KEY_BIAS_ATOL
            H = value.shape[0] // 3
            np.testing.assert_allclose(value[H:2 * H], ref[H:2 * H], atol=KEY_BIAS_ATOL, rtol=0,
                                       err_msg=f"{label} {name}")
            keep = np.r_[0:H, 2 * H:3 * H]
            value, ref = value[keep], ref[keep]
        np.testing.assert_allclose(value, ref, **ONE_PROCESS_PARAMS, err_msg=f"{label} {name}")


def _start_ranks(task, workdir, world):
    """``tests/test_torch_ring._run_ranks`` in two halves: the ranks start, the test computes its
    references meanwhile, then :func:`_wait_ranks`."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    return [subprocess.Popen([sys.executable, WORKER, task, str(workdir), str(r), str(world)], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _wait_ranks(procs, timeout=240):
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"


def _grads(npz):
    return {k[len("grad_"):]: npz[k] for k in npz.keys() if k.startswith("grad_")}


def _jax_reference(model, params, batch):
    """JAX's train-step loss and gradients of an STLT at dropout 0 on a
    model-2 mesh."""
    criterion = jax_make_criterion("something")
    jax_set_active_mesh(None)
    mesh = jax_make_mesh(model_parallel=2, devices=jax.devices()[:2])
    try:
        tx = jax_make_optimizer(params, learning_rate=HP["lr"], weight_decay=HP["weight_decay"],
                                clip_val=HP["clip_val"], num_warmup_steps=HP["warmup"],
                                num_training_steps=HP["total"])
        state = create_train_state(jax.tree_util.tree_map(np.array, params), tx)
        steps = compile_steps(mesh, model, tx, criterion, state=state)
        _, loss = steps.train_step(jax.device_put(state, steps.state_sharding), batch, np.uint32(7))
        inputs = _inputs(batch)
        grad_fn = jax.jit(jax.grad(lambda p: criterion(model.apply({"params": p}, inputs), batch["labels"],
                                                       batch["valid"])),
                          in_shardings=(params_shardings(mesh, params),))
        grads = grad_fn(jax.device_put(params, params_shardings(mesh, params)))
        return float(loss), jax_params_to_state_dict(jax.device_get(grads))
    finally:
        jax_set_active_mesh(None)


def test_model_axis_training_matches_one_process_and_jax(tmp_path):
    """(a), (b) and (c): one launch of two model ranks."""
    batch = _stlt_batch(tmp_path)
    stlt = dict(STLT_KW, hidden_dropout_prob=0.1)
    torch.save(models_factory["stlt"](make_model_config("stlt", **stlt), torch.Generator().manual_seed(32))
               .state_dict(), tmp_path / "stlt.pt")
    quiet_model = jax_models["stlt"](JaxStltConfig(hidden_dropout_prob=0.0, **STLT_KW))
    quiet_params = quiet_model.init(jax.random.PRNGKey(1), _inputs(batch))["params"]
    torch.save(jax_params_to_state_dict(quiet_params), tmp_path / "quiet.pt")
    fusion = dict(KW, hidden_dropout_prob=0.1)
    np.savez(tmp_path / "fusion_batch.npz", **fusion_batch(33, (3, KW["layout_num_frames"])))
    torch.save(models_factory["cacnf"](make_model_config("cacnf", **fusion), torch.Generator().manual_seed(34))
               .state_dict(), tmp_path / "cacnf.pt")
    base = {"model": "stlt", "config": stlt, "state": "stlt.pt", "batch": "stlt_batch.npz"}
    fusion_state = {}
    for name, seed in (("lcf", 36), ("caf", 37), ("resnet3d", 38), ("resnet3d-transformer", 39)):
        torch.save(models_factory[name](make_model_config(name, **fusion), torch.Generator().manual_seed(seed))
                   .state_dict(), tmp_path / f"{name}.pt")
        fusion_state[f"{name}_step"] = {"model": name, "config": fusion, "state": f"{name}.pt",
                                        "batch": "fusion_batch.npz", "kind": "step"}
    cases = {
        **fusion_state,
        "stlt_step": dict(base, kind="step"),
        "stlt_train": dict(base, kind="train", steps=HP["steps"], hp=HP),
        "quiet_step": dict(base, kind="step", config=dict(STLT_KW, hidden_dropout_prob=0.0), state="quiet.pt"),
        "cacnf_step": {"model": "cacnf", "config": fusion, "state": "cacnf.pt", "batch": "fusion_batch.npz",
                       "kind": "step"},
    }
    with open(tmp_path / "model_axis.json", "w") as f:
        json.dump({"model_parallel": 2, "context_parallel": 1, "cases": cases}, f)
    procs = _start_ranks("model_axis", tmp_path, 2)
    jax_loss, jax_grads = _jax_reference(quiet_model, quiet_params, batch)
    steps = [label for label in cases if label.endswith("_step") and label != "quiet_step"]
    ones = {label: run_fusion_case(str(tmp_path), cases[label]) for label in steps + ["stlt_train"]}
    _wait_ranks(procs)
    ranks = {label: [np.load(tmp_path / f"{label}_{r}.npz") for r in range(2)] for label in cases}
    for label, (a, b) in ranks.items():  # every array of the two ranks bit for bit
        assert a.files == b.files
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"{label} {key}")

    for label in steps:
        one = ones[label]
        got = ranks[label][0]
        np.testing.assert_allclose(got["loss"], one["loss"], **ONE_PROCESS_PARAMS, err_msg=label)
        grads, want = _grads(got), _grads(one)
        assert set(grads) == set(want) and grads
        for name, value in grads.items():
            np.testing.assert_allclose(value, want[name], **ONE_PROCESS_GRADS, err_msg=f"{label} {name}")

    one = ones["stlt_train"]
    got = ranks["stlt_train"][0]
    np.testing.assert_allclose(got["losses"], one["losses"], **ONE_PROCESS_PARAMS)
    for i in range(HP["steps"]):
        _check_params(_params(got[f"params_{i}"], stlt), _params(one[f"params_{i}"], stlt), f"step {i}")

    quiet = ranks["quiet_step"][0]
    np.testing.assert_allclose(float(quiet["loss"]), jax_loss, **JAX_LOSS)
    grads = _grads(quiet)
    assert set(grads) <= set(jax_grads) and grads  # JAX's tree also holds the unused prototype layer
    for name, value in grads.items():
        np.testing.assert_allclose(value, jax_grads[name].numpy(), **JAX_GRADS, err_msg=name)


def test_data_by_model_grid_with_accumulation_and_remat_matches_one_process(tmp_path):
    """(d) D = 2 x M = 2: four ranks, each its data rows in two
    microbatches, every encoder layer recomputed in the backward."""
    _stlt_batch(tmp_path)
    config = dict(STLT_KW, hidden_dropout_prob=0.1, remat=True)
    torch.save(models_factory["stlt"](make_model_config("stlt", **config), torch.Generator().manual_seed(35))
               .state_dict(), tmp_path / "stlt.pt")
    case = {"model": "stlt", "config": config, "state": "stlt.pt", "batch": "stlt_batch.npz", "kind": "train",
            "steps": HP["steps"], "hp": HP, "grad_accum": 2}
    with open(tmp_path / "model_axis.json", "w") as f:
        json.dump({"model_parallel": 2, "context_parallel": 1, "cases": {"grid": case}}, f)
    procs = _start_ranks("model_axis", tmp_path, 4)
    one = run_fusion_case(str(tmp_path), case)
    _wait_ranks(procs)
    ranks = [np.load(tmp_path / f"grid_{r}.npz") for r in range(4)]
    for r in range(1, 4):
        for key in ranks[0].files:
            np.testing.assert_array_equal(ranks[r][key], ranks[0][key], err_msg=f"rank {r} {key}")
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"], **ONE_PROCESS_PARAMS)
    for i in range(HP["steps"]):
        _check_params(_params(ranks[0][f"params_{i}"], config), _params(one[f"params_{i}"], config), f"step {i}")
