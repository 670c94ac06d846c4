"""The port's train-mode attention op and encoder layer (plain versions on
the CPU) against the JAX package's Pallas train path (interpret mode).

Same numpy-seeded inputs and the same uint32 dropout seeds through both, in
f32. Tolerances: the forward at atol 1e-5, every gradient at atol = rtol =
1e-4. The two compute the same f32 function with the same rounding points
and the same keep bits; only the order of f32 sums differs, and a gradient
sums over every token of the batch. Live rows are compared; the port's dead
rows are exact zeros. The output cotangent is zero on dead rows, as it is in
the model (dead rows reach later attention only as -1e9-masked keys).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlt_tpu.models.layers import TransformerEncoderLayer as JaxLayer
from stlt_tpu.ops import fused_encoder as jfe
from stlt_tpu_torch.models.layers import TransformerEncoderLayer
from stlt_tpu_torch.ops import fused_encoder as tfe
from stlt_tpu_torch.utils.convert import jax_params_to_state_dict
from tests.jax_reference import jit_vjp

SEED = 1234
Y_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _case(T: int, ragged: bool, seed: int = 0, B: int = 5, H: int = 64):
    """x [B, T, H], a bias (key padding for T = 8, causal plus padding
    otherwise), rows_live or None, a cotangent g zero on dead rows, and f32
    weights, all numpy."""
    rng = np.random.default_rng(seed + T)
    if T == 8:
        pad = rng.random((B, T)) < 0.3
        pad[:, 0] = False
        bias = np.where(pad, -1e9, 0.0).astype(np.float32)[:, None, None, :]
    else:
        lengths = rng.integers(T // 2, T + 1, B)
        pad = np.arange(T)[None, :] >= lengths[:, None]
        causal = np.where(np.tril(np.ones((T, T), bool)), 0.0, -1e9)
        bias = (causal[None, None] + np.where(pad, -1e9, 0.0)[:, None, None, :]).astype(np.float32)
    live = None
    if ragged:
        live = rng.random(B) < 0.6
        live[0], live[-1] = True, False
    x = rng.normal(0, 1, (B, T, H)).astype(np.float32)
    g = rng.normal(0, 1, (B, T, H)).astype(np.float32)
    if live is not None:
        g[~live] = 0.0
    w = lambda *s: rng.normal(0, 0.1, s).astype(np.float32)
    weights = [w(H, 3 * H), w(3 * H), w(H, H), w(H)]
    return x, bias, live, g, weights


def _live(live, B):
    return np.ones(B, bool) if live is None else live


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("T", [8, 17, 33])
def test_train_op_matches_jax(T, rate, ragged):
    x, bias, live, g, (wqkv, bqkv, wo, bo) = _case(T, ragged)
    B, _, H = x.shape
    N = 4
    rows_live = None if live is None else jnp.asarray(live)

    def jax_op(x, wqkv, bqkv, wo, bo):
        return jfe.fused_proj_attention_train(
            N, rate, x, wqkv, bqkv, wo, bo, jnp.asarray(bias), jnp.uint32(SEED), rows_live)

    y_j, grads_j = jit_vjp(jax_op, [jnp.asarray(a) for a in (x, wqkv, bqkv, wo, bo)],
                           jnp.asarray(g))

    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, wqkv, bqkv, wo, bo)]
    y_t = tfe.fused_proj_attention_train(
        *leaves, torch.from_numpy(bias), SEED, num_heads=N, dropout_rate=rate,
        compute_dtype=torch.float32,
        rows_live=None if live is None else torch.from_numpy(live))
    y_t.backward(torch.from_numpy(g))

    keep = _live(live, B)
    np.testing.assert_allclose(y_t.detach().numpy()[keep], np.asarray(y_j)[keep], **Y_TOL)
    assert not y_t.detach().numpy()[~keep].any()
    names = ("dx", "dwqkv", "dbqkv", "dwo", "dbo")
    for name, leaf, want in zip(names, leaves, grads_j):
        got, want = leaf.grad.numpy(), np.asarray(want)
        assert got.dtype == np.float32, name
        if name == "dx":
            assert not got[~keep].any()
            got, want = got[keep], want[keep]
        np.testing.assert_allclose(got, want, err_msg=name, **GRAD_TOL)


def test_dropout_reaches_the_output():
    """With the same seed the dropped forward differs from the undropped
    one, and a different seed gives other bits."""
    x, bias, _, _, weights = _case(17, False)
    args = [torch.from_numpy(a) for a in (x, *weights)] + [torch.from_numpy(bias)]
    run = lambda seed, rate: tfe.fused_proj_attention_train(
        *args, seed, num_heads=4, dropout_rate=rate, compute_dtype=torch.float32)
    base, a, b = run(SEED, 0.0), run(SEED, 0.25), run(SEED + 1, 0.25)
    assert not torch.allclose(a, base) and not torch.allclose(a, b)
    torch.testing.assert_close(run(SEED, 0.25), a, atol=0, rtol=0)


def test_eval_op_at_33_tokens_matches_jax():
    """T = 33 (the 32-frame temporal stage): the plain eval op agrees with
    the JAX kernel, which runs fused up to FUSED_PROJ_MAX_SEQ = 64."""
    x, bias, _, _, (wqkv, bqkv, wo, bo) = _case(33, False)
    assert 33 <= jfe.FUSED_PROJ_MAX_SEQ == tfe._KERNEL_MAX_SEQ
    want = jfe.fused_proj_attention(
        *(jnp.asarray(a) for a in (x, wqkv, bqkv, wo, bo)), jnp.asarray(bias),
        num_heads=4, compute_dtype=jnp.float32)
    got = tfe.fused_proj_attention(
        *(torch.from_numpy(a) for a in (x, wqkv, bqkv, wo, bo)), torch.from_numpy(bias),
        num_heads=4, compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **Y_TOL)


@pytest.mark.parametrize("T,ragged", [(8, True), (17, False)])
def test_train_layer_matches_jax(monkeypatch, T, ragged):
    """A JAX TransformerEncoderLayer(use_pallas=True) in train mode, f32,
    dropout 0.2, against the port's layer given the two seeds the JAX layer
    draws (recorded by wrapping jax.random.bits in an eager apply): outputs
    and every parameter gradient."""
    x, bias, live, g, _ = _case(T, ragged, seed=5)
    H, N, rate, eps = x.shape[-1], 4, 0.2, 1e-12
    jlayer = JaxLayer(hidden_size=H, num_heads=N, ff_size=4 * H, dropout_rate=rate,
                      activation="gelu", layer_norm_eps=eps, use_pallas=True)
    rows_live = None if live is None else jnp.asarray(live)
    params = jlayer.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(bias))["params"]
    rngs = {"dropout": jax.random.PRNGKey(11)}

    def apply(p, x):
        return jlayer.apply({"params": p}, x, jnp.asarray(bias), False, None, rows_live, rngs=rngs)

    drawn, bits = [], jax.random.bits

    def recording_bits(*args, **kwargs):
        out = bits(*args, **kwargs)
        drawn.append(int(out))
        return out

    monkeypatch.setattr(jax.random, "bits", recording_bits)
    apply(params, jnp.asarray(x))
    monkeypatch.setattr(jax.random, "bits", bits)
    assert len(drawn) == 2, drawn  # attention seed, tail seed
    y_j, (grads_j, dx_j) = jit_vjp(apply, (params, jnp.asarray(x)), jnp.asarray(g))

    layer = TransformerEncoderLayer(H, N, 4 * H, activation="gelu", layer_norm_eps=eps,
                                    dtype=torch.float32, generator=torch.Generator(),
                                    dropout_rate=rate)
    layer.load_state_dict(jax_params_to_state_dict(params), strict=True)
    layer.train()
    xt = torch.from_numpy(x).requires_grad_()
    y_t = layer(xt, torch.from_numpy(bias),
                rows_live=None if live is None else torch.from_numpy(live), seeds=tuple(drawn))
    y_t.backward(torch.from_numpy(g))

    keep = _live(live, x.shape[0])
    np.testing.assert_allclose(y_t.detach().numpy()[keep], np.asarray(y_j)[keep], **Y_TOL)
    np.testing.assert_allclose(xt.grad.numpy()[keep], np.asarray(dx_j)[keep], **GRAD_TOL)
    want = jax_params_to_state_dict(grads_j)
    for name, p in layer.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=name, **GRAD_TOL)
