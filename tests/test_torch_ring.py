"""The port's context-parallel serving against the JAX package, on the CPU.

- the blockwise forward's ring-offset mode (``blockwise_attention_plain``
  with ``offsets``) against JAX's ``_blockwise_forward(..., kv_lengths,
  causal=True, offsets=...)``, Pallas in interpret mode;
- the port's ``ring_attention`` on two gloo ranks against JAX's
  ``ring_attention`` on a context-2 mesh (lengths, dense, seed and mask
  modes);
- STLT logits under a context of 2 against JAX's ``compile_steps`` eval under
  a context of 2 and against the port's single-rank logits, the weights
  carried with ``jax_params_to_state_dict``;
- ``predict --context_parallel 2 --num_processes 2 --platform cpu`` against
  the single-process run;
- the serving and train CLIs' refusals of what waits (ROADMAP.md A9), and
  what the ring now takes: ring offsets in the backward, ``train
  --context_parallel``, the fusion models under the ring, gradients
  through ``ring_attention`` (the ring's training is held against JAX in
  ``tests/test_torch_ring_train*.py``, the fusion models' in
  ``tests/test_torch_ring_fusion.py``).

The ranks run as subprocesses of ``tests/ring_worker.py``, which imports
torch and the port only; their process group starts from a ``file://``
store under ``tmp_path``. Inputs are seeded numpy arrays handed to both
packages; f32 throughout.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlt_tpu.configs import StltModelConfig as JaxStltConfig
from stlt_tpu.models import models_factory as jax_models
from stlt_tpu.ops.flash import _blockwise_forward
from stlt_tpu.ops.ring import ring_attention as jax_ring_attention
from stlt_tpu.parallel.mesh import make_mesh as jax_make_mesh
from stlt_tpu.parallel.mesh import set_active_mesh as jax_set_active_mesh
from stlt_tpu.training.loop import compile_steps
from stlt_tpu_torch import predict as port_predict
from stlt_tpu_torch import train as port_train
from stlt_tpu_torch.configs import StltModelConfig
from stlt_tpu_torch.models import models_factory
from stlt_tpu_torch.ops import flash, masks
from stlt_tpu_torch.parser import build_parser
from stlt_tpu_torch.utils.convert import jax_params_to_state_dict
from tests.fixtures import make_something_fixture

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ring_worker.py")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEG_INF = -1e30


def _run_ranks(task, workdir, world=2, timeout=240):
    """Start ``world`` ranks of ``ring_worker.py TASK`` and wait for all;
    any rank's failure fails the test with its output."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, WORKER, task, str(workdir), str(r), str(world)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {task} failed:\n{out}"
    return outs


# --- (a) the ring-offset mode of the blockwise forward ------------------------


@pytest.mark.parametrize("offsets,seed", [
    ((0, 0), None),      # the diagonal chunk of rank 0
    ((0, 40), None),     # past the diagonal: every live row merge-wiped
    ((40, 0), None),     # below the diagonal: every key a candidate
    ((40, 40), None),    # the diagonal chunk of rank 1
    ((20, 10), None),    # across the diagonal
    ((40, 0), 0x5EED),   # with hashed dropout (local coordinates)
])
def test_offsets_forward_matches_jax(offsets, seed):
    """T = S = 40 local rows and keys; lengths put dead rows, padded key
    columns and merge-wiped rows in the block. Live rows with a live key:
    out and lse within 1e-5 of JAX; merge-wiped rows: zeros with lse -1e30
    here, finite with lse <= -1e29 in JAX; no NaN."""
    rng = np.random.default_rng(sum(offsets) + (seed or 0))
    B, T, N, D, rate = 4, 40, 2, 16, 0.2
    q, k, v = (rng.normal(0, 1, (B, T, N, D)).astype(np.float32) for _ in range(3))
    lengths = np.array([80, 55, 30, 41], np.int32)
    drop = {}
    if seed is not None:
        drop = dict(dropout_scale=1.0 / (1.0 - rate), seed=jnp.uint32(seed), dropout_rate=rate)
    jt = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)
    want, want_lse = _blockwise_forward(jt(q), jt(k), jt(v), None, kv_lengths=jnp.asarray(lengths),
                                        causal=True, offsets=jnp.asarray(offsets, jnp.int32), **drop)
    want = np.asarray(want).transpose(0, 2, 1, 3)
    want_lse = np.asarray(want_lse)
    got, got_lse = flash.blockwise_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), kv_lengths=torch.from_numpy(lengths), causal=True,
        offsets=offsets, dropout_seed=seed, dropout_rate=rate if seed is not None else 0.0)
    got, got_lse = got.numpy(), got_lse.numpy()
    row0, col0 = offsets
    t = np.arange(T)[None, :] + row0
    live = t < lengths[:, None]
    wiped = live & ((col0 >= lengths[:, None]) | (col0 > t))
    keyed = live & ~wiped
    assert np.isfinite(got).all() and np.isfinite(got_lse).all()
    np.testing.assert_allclose(got[keyed], want[keyed], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_lse.transpose(0, 2, 1)[keyed], want_lse.transpose(0, 2, 1)[keyed],
                               atol=1e-5, rtol=1e-5)
    assert (got[wiped] == 0).all() and (got_lse.transpose(0, 2, 1)[wiped] == NEG_INF).all()
    assert np.isfinite(want[wiped]).all() and (want_lse.transpose(0, 2, 1)[wiped] <= -1e29).all()
    if offsets == (0, 40):
        assert wiped.sum() == live.sum() > 0
    if offsets == (20, 10):
        assert keyed.any() and (live & ~keyed).sum() == 0


def test_offsets_require_lengths_and_backward_offsets_still_wait():
    """Ring offsets need kv_lengths in the forward and in the backward; the
    backward takes them (held against JAX in test_torch_ring_train.py)."""
    q = torch.zeros(1, 4, 1, 32)
    with pytest.raises(ValueError, match="ring offsets require kv_lengths"):
        flash.blockwise_attention_plain(q, q, q, offsets=(0, 4))
    lse = dsum = torch.zeros(1, 1, 4)
    with pytest.raises(ValueError, match="ring offsets require kv_lengths"):
        flash.blockwise_attention_bwd(q, q, q, q, lse, dsum, offsets=(0, 4))
    grads = flash.blockwise_attention_bwd(q, q, q, q, lse, dsum, kv_lengths=torch.tensor([4]),
                                          causal=True, offsets=(0, 4))
    assert all(g.shape == q.shape and not g.any() for g in grads)  # every key past the clip


@pytest.mark.parametrize("causal", [True, False])
def test_offsets_bound_counts_at_global_indices(causal):
    """``chip_smoke.offsets_bound`` and ``offsets_bwd_bound`` (a ring step's
    forward and backward bounds on the card) count what the step needs at
    global indices: at offsets (0, 0) over the whole sequence they equal the
    lengths mode's ``blockwise_bound`` and ``attention_bwd_bound``, and a
    forward step whose query rows are all dead reads no q, k or v (only out,
    lse and the lengths are written or read)."""
    import chip_smoke

    rng = np.random.default_rng(7)
    B, T, N, D = 6, 40, 2, 32
    q = torch.zeros((B, T, N, D), dtype=torch.bfloat16)
    lengths = torch.from_numpy(rng.integers(1, T + 1, B))
    for dtype in (torch.bfloat16, torch.float32):
        assert chip_smoke.offsets_bound(q.to(dtype), lengths, causal, (0, 0), dtype) == \
            chip_smoke.blockwise_bound(q.to(dtype), lengths, causal, dtype)
        assert chip_smoke.offsets_bwd_bound(q.to(dtype), lengths, causal, (0, 0), dtype) == \
            chip_smoke.attention_bwd_bound(q.to(dtype), dtype, lengths, causal)
    ms, by = chip_smoke.offsets_bound(q, lengths, causal, (T, 0), torch.bfloat16)
    writes = B * T * N * D * q.element_size() + B * N * T * 4 + B * 4
    assert (ms, by) == (writes / chip_smoke.HBM_BYTES_PER_S * 1e3, "bytes")


# --- (b) ring attention on two ranks ---------------------------------------------


def test_ring_attention_on_two_ranks_matches_jax(tmp_path):
    rng = np.random.default_rng(7)
    B, T, N, D, rate, seed = 4, 16, 2, 8, 0.2, 1234
    q, k, v = (rng.normal(0, 1, (B, T, N, D)).astype(np.float32) for _ in range(3))
    lengths = np.array([16, 13, 7, 1], np.int32)
    pad = np.arange(T)[None, :] >= lengths[:, None]
    bias = (masks.causal_bias(T) + masks.key_padding_bias(torch.from_numpy(pad))).numpy()
    keep = (rng.random((B, N, T, T)) > rate).astype(np.float32)
    np.savez(tmp_path / "inputs.npz", q=q, k=k, v=v, lengths=lengths, bias=bias, keep=keep, seed=seed,
             rate=rate)
    _run_ranks("op", tmp_path)
    got = {mode: np.concatenate([np.load(tmp_path / f"op_{r}.npz")[mode] for r in range(2)], axis=1)
           for mode in ("lengths", "dense", "seed", "mask")}

    mesh = jax_make_mesh(model_parallel=1, context_parallel=2, devices=jax.devices()[:2])
    args = tuple(jnp.asarray(a) for a in (q, k, v))
    lens = jnp.asarray(lengths)
    want = {
        "lengths": jax_ring_attention(*args, None, mesh, kv_lengths=lens, causal=True),
        "dense": jax_ring_attention(*args, jnp.asarray(bias), mesh),
        "seed": jax_ring_attention(*args, None, mesh, kv_lengths=lens, causal=True,
                                   dropout_seed=jnp.uint32(seed), dropout_rate=rate),
        "mask": jax_ring_attention(*args, jnp.asarray(bias), mesh, dropout_mask=jnp.asarray(keep),
                                   dropout_rate=rate),
    }
    live = np.arange(T)[None, :] < lengths[:, None]  # the port's dead rows are zeros
    for mode in want:
        w = np.asarray(want[mode])
        rows = live if mode in ("lengths", "seed") else np.ones_like(live)
        np.testing.assert_allclose(got[mode][rows], w[rows], atol=1e-5, rtol=1e-5, err_msg=mode)
    assert not np.allclose(got["seed"][live], got["lengths"][live], atol=1e-3)  # dropout acted


# --- (c) STLT logits under a context of 2 ------------------------------------------


def _synthetic_batch(B, F, O, C, seed):
    """A layout batch with ragged clips (tail-contiguous pad frames, the
    extract frame at length - 1), numpy."""
    from __graft_entry__ import _synthetic_layout_batch

    batch = _synthetic_layout_batch(B, F, O, C, seed=seed, length_range=(3, F))
    return {k: v for k, v in batch.items() if k != "labels"}


def test_stlt_logits_under_context_2_match_jax_and_one_rank(tmp_path):
    cfg = JaxStltConfig(num_classes=7, unique_categories=4, hidden_size=32, num_attention_heads=4,
                        num_spatial_layers=1, num_temporal_layers=2)
    inputs = _synthetic_batch(4, 8, 4, 4, seed=3)
    jax_set_active_mesh(None)
    model = jax_models["stlt"](cfg)
    params = model.init(jax.random.PRNGKey(0), inputs)["params"]
    mesh = jax_make_mesh(model_parallel=2, context_parallel=2)
    batch = dict(inputs, labels=np.zeros((4,), np.int32), valid=np.ones((4,), bool))
    try:
        steps = compile_steps(mesh, model, params_template=params, batch_template=batch)
        want = np.asarray(steps.eval_step(jax.device_put(params, steps.params_sharding), batch)["stlt"])
    finally:
        jax_set_active_mesh(None)

    fields = {f.name for f in dataclasses.fields(StltModelConfig)}
    port_cfg = {k: v for k, v in dataclasses.asdict(cfg).items() if k in fields}
    state = jax_params_to_state_dict(params)
    port = models_factory["stlt"](StltModelConfig(**port_cfg)).eval()
    port.load_state_dict(state, strict=True)
    with torch.inference_mode():
        one = port({k: torch.from_numpy(v) for k, v in inputs.items()})["stlt"].numpy()
    torch.save(state, tmp_path / "state.pt")
    with open(tmp_path / "config.json", "w") as f:
        json.dump(port_cfg, f)
    np.savez(tmp_path / "batch.npz", **inputs)
    _run_ranks("stlt", tmp_path)
    ranks = [np.load(tmp_path / f"stlt_{r}.npy") for r in range(2)]
    np.testing.assert_array_equal(ranks[0], ranks[1])  # every rank runs the head
    np.testing.assert_allclose(ranks[0], want, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(ranks[0], one, atol=2e-5, rtol=1e-5)


# --- (d) the predict CLI on two ranks -------------------------------------------------


def test_predict_on_two_ranks_writes_the_single_process_output(tmp_path):
    paths, *_ = make_something_fixture(str(tmp_path), num_videos=6)
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
    torch.save(models_factory["stlt"](model_cfg, torch.Generator().manual_seed(5)).state_dict(), ckpt)
    common += ["--checkpoint_path", ckpt]
    single = port_predict.main(common + ["--output", str(tmp_path / "one.jsonl")])
    with open(tmp_path / "argv.json", "w") as f:
        json.dump(common + ["--output", str(tmp_path / "two.jsonl"), "--context_parallel", "2",
                            "--num_processes", "2"], f)
    outs = _run_ranks("predict", tmp_path)
    for r, out in enumerate(outs):
        assert f"rank {r} of 2 on cpu, backend gloo" in out, out
    with open(tmp_path / "two.jsonl") as f:
        two = [json.loads(line) for line in f]
    assert len(two) == len(single) == 6
    for a, b in zip(two, single):
        assert a["video_id"] == b["video_id"]
        assert [t["label_id"] for t in a["top_k"]] == [t["label_id"] for t in b["top_k"]]
        np.testing.assert_allclose([t["score"] for t in a["top_k"]], [t["score"] for t in b["top_k"]],
                                   atol=1e-5)


# --- (e) what waits -------------------------------------------------------------------


@pytest.mark.parametrize("extra,item", [
    pytest.param(["--model_parallel", "2"], None, id="extra0-A9 \\(model axis\\)"),
    pytest.param(["--context_parallel", "2", "--num_processes", "4", "--model_name", "lcf",
                  "--dataset_type", "multimodal"], None,
                 id="extra1-A9 \\(fusion models under the ring\\)"),
    pytest.param(["--context_parallel", "4", "--num_processes", "2"], None,
                 id="extra2-A9 \\(ranks per process\\)"),
    pytest.param(["--context_parallel", "2", "--num_processes", "2", "--model_name", "cacnf",
                  "--dataset_type", "multimodal"], None,
                 id="extra3-A9 \\(fusion models under the ring\\)"),
])
def test_serving_check_flags_refuses_what_waits(extra, item):
    """What waits raises naming its item; a case whose item is None waited
    for an item that has landed and keeps its id: the check now takes it
    (the fusion models on a ring and on a grid: A9 (fusion models under
    the ring); ``--model_parallel 2``: A9 (model axis); a ring of 4 over 2
    processes, each starting two ranks: A9 (ranks per process))."""
    args = build_parser("test").parse_args(
        ["--dataset_name", "something", "--dataset_type", "layout", "--model_name", "stlt", *extra])
    if item is None:
        port_predict.check_flags(args)
        return
    with pytest.raises(NotImplementedError, match=f"waits for ROADMAP.md item {item}"):
        port_predict.check_flags(args)


def test_serving_check_flags_takes_the_context_axis():
    port_predict.check_flags(build_parser("test").parse_args(
        ["--dataset_name", "something", "--dataset_type", "layout", "--model_name", "stlt",
         "--context_parallel", "2", "--num_processes", "2", "--coordinator_address", "localhost:1"]))


def test_serving_check_flags_takes_the_data_axis():
    """``--num_processes 2`` alone is the data axis, which every model now
    takes (it refused, naming A9 (data axis), before the axis was ported)."""
    port_predict.check_flags(build_parser("test").parse_args(
        ["--dataset_name", "something", "--dataset_type", "layout", "--model_name", "stlt",
         "--num_processes", "2", "--coordinator_address", "localhost:1"]))


def test_train_refuses_context_parallel():
    """``train`` takes STLT over a context axis of C processes and, as
    ``predict``, a fusion model under the ring, which it refused naming A9
    (fusion models under the ring) until that item landed (the refusals
    left: test_torch_ring_train_cli.py)."""
    common = ["--dataset_name", "something", "--dataset_type", "layout", "--context_parallel", "2",
              "--num_processes", "2", "--coordinator_address", "localhost:1",
              "--save_model_path", "best.pt"]
    port_train.check_flags(build_parser("test").parse_args(common + ["--model_name", "stlt"]))
    port_train.check_flags(build_parser("test").parse_args(
        common + ["--model_name", "caf", "--dataset_type", "multimodal"]))


def test_ring_refuses_gradients():
    """Gradients flow through ``ring_attention``: on a ring of one rank (no
    transfer) its custom backward gives the one-device attention's
    gradients, in the lengths and the dense mode."""
    from stlt_tpu_torch.ops.ring import ring_attention
    from stlt_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh((1, 1, 1), 0, "none", torch.device("cpu"))
    rng = np.random.default_rng(3)
    q, k, v, g = (torch.from_numpy(rng.normal(0, 1, (3, 8, 2, 16)).astype(np.float32)) for _ in range(4))
    lengths = torch.tensor([8, 5, 2])
    pad = torch.arange(8)[None, :] >= lengths[:, None]
    bias = masks.causal_bias(8) + masks.key_padding_bias(pad)
    live = ~pad[:, :, None, None]
    for ring_kw, kw in ((dict(kv_lengths=lengths, causal=True), dict(kv_lengths=lengths, causal=True)),
                        (dict(), dict(bias=bias))):
        grads = []
        for fn in (lambda *a: ring_attention(*a, bias if not ring_kw else None, mesh, **ring_kw),
                   lambda *a: flash.flash_attention(*a, **kw)):
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            (fn(*leaves) * g * live).sum().backward()
            grads.append([x.grad for x in leaves])
        for a, b in zip(*grads):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
