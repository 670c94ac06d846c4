"""The attention core's dropout-mask operand (``dropout_mask``) in the port
(``stlt_tpu_torch.ops.flash``, plain forward and backward on the CPU)
against the JAX package's ``stlt_tpu.ops.flash.flash_attention`` under
``jax.vjp`` (Pallas in interpret mode, as its own tests run it).

The same numpy-made Bernoulli keep mask, q, k, v and cotangent go through
both, f32, B = 2, N = 2, D = 8, rate 0.1: at 70 tokens (the short path,
causal plus padding bias), at 513 (the blockwise path in lengths mode,
causal, ragged; and in dense-bias mode), each with a per-head [B, N, T, S]
and a head-broadcast [B, 1, T, S] mask. Tolerances: the forward atol = rtol
= 1e-5, dq/dk/dv 1e-4 (the same f32 function with the same keep bits, the
sums in another order). In lengths mode the port's dead rows are exact
zeros, the cotangent is zero there (JAX's contract) and live rows are
compared. The gradients of ``ring_attention`` with a mask on two ranks are
in ``tests/test_torch_ring_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlt_tpu.ops import flash as jax_flash
from stlt_tpu_torch.ops import flash
from stlt_tpu_torch.parallel.mesh import make_mesh
from stlt_tpu_torch.ops.ring import ring_attention
from tests.jax_reference import jit_vjp

Y_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
B, N, D, RATE = 2, 2, 8, 0.1


def _case(route, shared, seed):
    """(q, k, v, g, keep, the flash_attention keyword arguments in numpy,
    the [B, T] rows compared)."""
    rng = np.random.default_rng(seed)
    T = 70 if route == "short" else 513
    q, k, v, g = (rng.standard_normal((B, T, N, D)).astype(np.float32) for _ in range(4))
    keep = (rng.random((B, 1 if shared else N, T, T)) >= RATE).astype(np.float32)
    lengths = np.array([T, T // 3 + 5], np.int32)
    live = np.arange(T)[None, :] < lengths[:, None]
    t = np.arange(T)
    masked = (t[None, :] > t[:, None])[None] | (t[None, None, :] >= lengths[:, None, None])
    bias = np.where(masked, -1e9, 0.0).astype(np.float32)[:, None]
    if route == "lengths":
        g[~live] = 0.0
        return q, k, v, g, keep, dict(kv_lengths=lengths, causal=True), live
    return q, k, v, g, keep, dict(bias=bias, causal=True), np.ones_like(live)


@pytest.mark.parametrize("route,shared", [
    ("short", False), ("short", True), ("lengths", False), ("lengths", True), ("dense", False),
])
def test_mask_forward_and_gradients_match_jax(route, shared):
    q, k, v, g, keep, kw, rows = _case(route, shared, seed=len(route) + shared)

    def jax_fn(q, k, v):
        return jax_flash.flash_attention(q, k, v, dropout_mask=jnp.asarray(keep), dropout_rate=RATE,
                                         **kw)

    out_j, grads_j = jit_vjp(jax_fn, [jnp.asarray(a) for a in (q, k, v)], jnp.asarray(g))

    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tkw = {key: torch.from_numpy(val) if isinstance(val, np.ndarray) else val for key, val in kw.items()}
    flash.reset_launches()
    out_t = flash.flash_attention(*leaves, dropout_mask=torch.from_numpy(keep) > 0,
                                  dropout_rate=RATE, **tkw)
    out_t.backward(torch.from_numpy(g))
    assert not any(flash.LAUNCHES.values())  # the CPU takes the plain versions

    np.testing.assert_allclose(out_t.detach().numpy()[rows], np.asarray(out_j)[rows], **Y_TOL)
    for name, leaf, want in zip(("dq", "dk", "dv"), leaves, grads_j):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want), err_msg=name, **GRAD_TOL)
    # the mask acted: without it the output differs
    undropped = flash.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), **tkw)
    assert not np.allclose(undropped.numpy()[rows], out_t.detach().numpy()[rows], atol=1e-3)


def test_head_broadcast_mask_equals_its_per_head_copy():
    """A [B, 1, T, S] mask is every head's: the same output as the mask
    repeated over the heads, bit for bit."""
    q, k, v, g, keep, kw, _ = _case("lengths", True, seed=3)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tkw = dict(kv_lengths=torch.from_numpy(kw["kv_lengths"]), causal=True, dropout_rate=RATE)
    shared = flash.flash_attention(tq, tk, tv, dropout_mask=torch.from_numpy(keep), **tkw)
    full = flash.flash_attention(tq, tk, tv, dropout_mask=torch.from_numpy(keep).expand(B, N, -1, -1),
                                 **tkw)
    torch.testing.assert_close(shared, full, atol=0, rtol=0)


def test_hashed_mask_gives_the_seed_mode():
    """``hash_keep_mask(seed, ...)`` as the mask reproduces ``dropout_seed``
    bit for bit, forward and gradients (the blockwise path)."""
    from stlt_tpu_torch.ops.dropout import hash_keep_mask

    q, k, v, g, _, kw, _ = _case("lengths", False, seed=4)
    T = q.shape[1]
    tkw = dict(kv_lengths=torch.from_numpy(kw["kv_lengths"]), causal=True, dropout_rate=RATE)
    results = []
    for drop in (dict(dropout_seed=0xC0FFEE), dict(dropout_mask=hash_keep_mask(0xC0FFEE, B, N, T, T, RATE))):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = flash.flash_attention(*leaves, **tkw, **drop)
        out.backward(torch.from_numpy(g))
        results.append([out.detach()] + [x.grad for x in leaves])
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_wrong_mask_shape_raises_in_the_wrappers_words():
    q, k, v, _, keep, kw, _ = _case("short", False, seed=5)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    T = q.shape[1]
    for bad in (keep[:, :, :-1], keep[:1], keep[:, :1, :, :, None], np.ones((B, 3, T, T), np.float32)):
        with pytest.raises(ValueError, match=r"flash_attention: dropout_mask must be \[B, 1 or N, T, S\]"):
            flash.flash_attention(tq, tk, tv, dropout_mask=torch.from_numpy(bad), dropout_rate=RATE)
    with pytest.raises(ValueError, match=r"dropout_mask must be \[B, 1 or N, T, S\] = \[2, 1 or 2, 70, 70\]"):
        flash.fused_attention(tq, tk, tv, dropout_mask=torch.from_numpy(keep[:, :, :, :-1]),
                              dropout_rate=RATE)
    mesh = make_mesh(1, 1)
    with pytest.raises(ValueError, match=r"ring_attention: dropout_mask must be"):
        ring_attention(tq, tk, tv, None, mesh, dropout_mask=torch.from_numpy(keep[:, :, :, :-1]),
                       dropout_rate=RATE)
