"""The port's context-parallel training ops against the JAX package, on the
CPU: the attention backward's ring-offset mode and the gradients of
``ring_attention`` on two ranks.

- ``blockwise_attention_bwd`` (the plain path) with ``offsets`` against
  JAX's ``_blockwise_backward(..., kv_lengths, causal=True, offsets=...)``,
  Pallas in interpret mode, at (row0, col0) = (0, 0), (0, 40), (40, 0),
  (40, 40) of an 80-frame clip cut in two chunks, with and without a
  dropout seed. Both take the lse and the output of the whole clip's
  forward, as a ring step does. The cotangent is zero on the dead rows
  (global indices): the port takes their p and dO as 0 where JAX's ring
  steps compute them in full, which agree there, as in the model, whose
  dead frames' cotangents are zero. f32 at atol = rtol = 1e-5.
- The port's ``ring_attention`` gradients on two gloo ranks
  (``tests/ring_worker.py op_grad``) against ``jax.grad`` of JAX's
  ``ring_attention`` on a context-2 CPU mesh: the lengths mode (causal), the
  dense mode and the lengths mode with ``dropout_seed`` (both fold the seed
  with the rank's context index and the chunk), and with one numpy-made
  ``dropout_mask`` in the dense and the lengths mode (each step reads the
  held chunk's columns of the rank's rows). atol 2e-4, rtol 1e-3, the
  limits of JAX's own ring gradient test (``tests/test_ring.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlt_tpu.ops.flash import _blockwise_backward
from stlt_tpu.ops.ring import ring_attention as jax_ring_attention
from stlt_tpu.parallel.mesh import make_mesh as jax_make_mesh
from stlt_tpu_torch.ops import flash, masks
from tests.test_torch_ring import _run_ranks

RING_GRAD_TOL = dict(atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("offsets", [(0, 0), (0, 40), (40, 0), (40, 40)])
@pytest.mark.parametrize("seed", [None, 0x5EED])
def test_offsets_backward_matches_jax(offsets, seed):
    """Lengths put dead rows, padded key columns and rows with no live key in
    the chunk (rank 0's rows against chunk 1) in the block: dq, dk and dv
    within 1e-5 of JAX, finite; the rows with no live key get dq = 0."""
    rng = np.random.default_rng(sum(offsets) + (seed or 0))
    B, T, N, D, rate = 4, 40, 2, 16, 0.2
    q, k, v = (rng.normal(0, 1, (B, 2 * T, N, D)).astype(np.float32) for _ in range(3))
    lengths = np.array([80, 55, 30, 41], np.int32)
    row0, col0 = offsets
    g = rng.normal(0, 1, (B, T, N, D)).astype(np.float32)
    live = np.arange(T)[None, :] + row0 < lengths[:, None]  # [B, T], global rows
    g[~live] = 0.0
    tq, tk, tg = (torch.from_numpy(a) for a in (q, k, g))
    out, lse = flash.blockwise_attention_plain(tq, tk, torch.from_numpy(v),
                                               kv_lengths=torch.from_numpy(lengths), causal=True)
    rows, cols = slice(row0, row0 + T), slice(col0, col0 + T)
    out, lse = out[:, rows], lse[:, :, rows].contiguous()
    drop = dict(dropout_seed=seed, dropout_rate=rate if seed is not None else 0.0)

    got = flash.blockwise_attention_bwd(
        tq[:, rows], tk[:, cols], torch.from_numpy(v[:, cols]), tg, lse,
        flash._dsum(tg, out, torch.from_numpy(lengths), row0), kv_lengths=torch.from_numpy(lengths),
        causal=True, offsets=offsets, **drop)
    jdrop = {}
    if seed is not None:
        jdrop = dict(dropout_scale=1.0 / (1.0 - rate), seed=jnp.uint32(seed), dropout_rate=rate)
    jt = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)
    want = _blockwise_backward(jt(q[:, rows]), jt(k[:, cols]), jt(v[:, cols]), None, None, jt(g),
                               jt(out.numpy()), jnp.asarray(lse.numpy()),
                               kv_lengths=jnp.asarray(lengths), causal=True,
                               offsets=jnp.asarray(offsets, jnp.int32), **jdrop)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = np.asarray(b).transpose(0, 2, 1, 3)
        assert np.isfinite(a.numpy()).all(), name
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5, rtol=1e-5, err_msg=name)
    t = np.arange(T)[None, :] + row0
    no_key = live & ((col0 >= lengths[:, None]) | (col0 > t))
    assert (got[0].numpy()[no_key] == 0).all() and (got[0].numpy()[~live] == 0).all()
    if offsets == (0, 40):
        assert no_key.sum() == live.sum() > 0
        assert all(not x.numpy().any() for x in got)


def test_ring_gradients_on_two_ranks_match_jax(tmp_path):
    rng = np.random.default_rng(11)
    B, T, N, D, rate, seed = 4, 16, 2, 8, 0.2, 1234
    q, k, v = (rng.normal(0, 1, (B, T, N, D)).astype(np.float32) for _ in range(3))
    lengths = np.array([16, 13, 7, 1], np.int32)
    pad = np.arange(T)[None, :] >= lengths[:, None]
    bias = (masks.causal_bias(T) + masks.key_padding_bias(torch.from_numpy(pad))).numpy()
    g = rng.normal(0, 1, (B, T, N, D)).astype(np.float32)
    keep = (rng.random((B, N, T, T)) > rate).astype(np.float32)
    np.savez(tmp_path / "inputs.npz", q=q, k=k, v=v, lengths=lengths, bias=bias, g=g, seed=seed,
             rate=rate, keep=keep)
    _run_ranks("op_grad", tmp_path)
    parts = [np.load(tmp_path / f"op_grad_{r}.npz") for r in range(2)]
    got = {key: np.concatenate([p[key] for p in parts], axis=1) for key in parts[0].files}

    mesh = jax_make_mesh(model_parallel=1, context_parallel=2, devices=jax.devices()[:2])
    lens = jnp.asarray(lengths)
    g_live = np.where(pad[:, :, None, None], 0.0, g).astype(np.float32)  # dead rows: zero cotangent
    modes = {
        "lengths": (dict(kv_lengths=lens, causal=True), None, g_live),
        "dense": ({}, jnp.asarray(bias), g),
        "seed": (dict(kv_lengths=lens, causal=True, dropout_seed=jnp.uint32(seed), dropout_rate=rate),
                 None, g_live),
        "mask": (dict(dropout_mask=jnp.asarray(keep), dropout_rate=rate), jnp.asarray(bias), g),
        "mask_lengths": (dict(kv_lengths=lens, causal=True, dropout_mask=jnp.asarray(keep),
                              dropout_rate=rate), None, g_live),
    }
    for mode, (kw, b, cot) in modes.items():
        def loss(q_, k_, v_):
            return (jax_ring_attention(q_, k_, v_, b, mesh, **kw) * jnp.asarray(cot)).sum()

        want = jax.jit(jax.grad(loss, (0, 1, 2)))(*(jnp.asarray(a) for a in (q, k, v)))
        for name, w in zip(("dq", "dk", "dv"), want):
            assert np.isfinite(got[f"{mode}_{name}"]).all()
            np.testing.assert_allclose(got[f"{mode}_{name}"], np.asarray(w), **RING_GRAD_TOL,
                                       err_msg=f"{mode} {name}")
    assert not np.allclose(got["seed_dk"], got["lengths_dk"], atol=1e-3)  # dropout acted
    assert not np.allclose(got["mask_dk"], got["dense_dk"], atol=1e-3)
