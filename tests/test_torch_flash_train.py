"""The port's long-clip attention in training (``stlt_tpu_torch.ops.flash``'s
autograd Functions, plain forward and backward on the CPU) against the JAX
package's ``stlt_tpu.ops.flash.flash_attention`` under ``jax.vjp`` (Pallas in
interpret mode, as its own tests run it), and the train-mode encoder layer
at 257 and 513 tokens against JAX's.

Same numpy-seeded inputs and the same uint32 dropout seeds through both, f32.
Tolerances: outputs atol = rtol = 1e-5, dq/dk/dv and the layer's gradients
atol = rtol = 1e-4. Both compute the same f32 function with the same keep
bits; only the order of f32 sums differs (online over key blocks in JAX's
blockwise kernels, whole rows here), and a gradient sums over up to 513
rows. In lengths mode the port's dead query rows are exact zeros and the
output cotangent is zero there, as in the model (JAX's contract: dead rows'
cotangents count as zero); live rows are compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlt_tpu.models.layers import TransformerEncoderLayer as JaxLayer
from stlt_tpu.ops import flash as jax_flash
from stlt_tpu_torch.models.layers import TransformerEncoderLayer
from stlt_tpu_torch.ops import flash
from stlt_tpu_torch.utils.convert import jax_params_to_state_dict
from tests.jax_reference import jit_vjp

Y_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
B, N, D = 2, 2, 8
SEED = 0x1234ABCD


def _case(T, seed):
    """q, k, v, a cotangent g (zero on dead rows), the clips' live lengths
    and the [B, 1, T, T] causal plus padding bias of the masks (-1e9)."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, T, N, D)).astype(np.float32) for _ in range(4))
    lengths = np.array([T, T // 3 + 5], np.int32)
    live = np.arange(T)[None, :] < lengths[:, None]  # [B, T]
    g[~live] = 0.0
    t = np.arange(T)
    masked = (t[None, :] > t[:, None])[None] | (t[None, None, :] >= lengths[:, None, None])
    bias = np.where(masked, -1e9, 0.0).astype(np.float32)[:, None]
    return q, k, v, g, lengths, live, bias


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("T", [70, 257, 513])
def test_attention_gradients_match_jax(T, rate):
    """T = 70 and 257: the short path with the causal plus padding bias;
    T = 513: the blockwise path in lengths mode, causal, ragged."""
    q, k, v, g, lengths, live, bias = _case(T, seed=T)
    kw = dict(causal=True, dropout_rate=rate)
    kw.update(kv_lengths=lengths) if T >= 513 else kw.update(bias=bias)

    def jax_fn(q, k, v):
        return jax_flash.flash_attention(q, k, v, dropout_seed=jnp.uint32(SEED) if rate else None, **kw)

    out_j, grads_j = jit_vjp(jax_fn, [jnp.asarray(a) for a in (q, k, v)], jnp.asarray(g))

    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tkw = {key: torch.from_numpy(val) if isinstance(val, np.ndarray) else val for key, val in kw.items()}
    out_t = flash.flash_attention(*leaves, dropout_seed=SEED if rate else None, **tkw)
    out_t.backward(torch.from_numpy(g))

    np.testing.assert_allclose(out_t.detach().numpy()[live], np.asarray(out_j)[live], **Y_TOL)
    for name, leaf, want in zip(("dq", "dk", "dv"), leaves, grads_j):
        assert leaf.grad.dtype == torch.float32, name
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want), err_msg=name, **GRAD_TOL)
    if T >= 513:
        assert not out_t.detach().numpy()[~live].any() and not leaves[0].grad.numpy()[~live].any()


def test_attention_dropout_reaches_the_gradients():
    """With the same seed the dropped gradients differ from the undropped
    ones and repeat exactly; another seed gives other bits."""
    q, k, v, g, lengths, _, _ = _case(513, seed=3)

    def grads(seed, rate):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        flash.flash_attention(*leaves, kv_lengths=torch.from_numpy(lengths), causal=True,
                              dropout_seed=seed, dropout_rate=rate).backward(torch.from_numpy(g))
        return torch.cat([t.grad.flatten() for t in leaves])

    base, a = grads(None, 0.0), grads(SEED, 0.3)
    assert not torch.allclose(a, base) and not torch.allclose(a, grads(SEED + 1, 0.3))
    torch.testing.assert_close(grads(SEED, 0.3), a, atol=0, rtol=0)


def _rel(got, want):
    return ((got.double() - want).norm() / want.norm()).item()


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_dead_rows_get_the_exact_vjp_under_a_large_cotangent(rate):
    """Lengths mode at 513 tokens with large logits (q scaled by 30, so
    exp(z - 0) of a dead row would overflow) and a cotangent of 1e30 on the
    dead rows: the gradients stay finite, dq is exactly zero on dead rows,
    and every gradient equals the exact VJP of the port's forward, whose dead
    rows are constants (autograd through the same function in f64), within
    a relative norm of 1e-5 (f32 rounding of logits up to ~100)."""
    q, k, v, g, lengths, live, _ = _case(513, seed=5)
    lengths[1] = 1
    live = np.arange(513)[None, :] < lengths[:, None]
    q = q * 30.0
    g[~live] = 1e30
    tl = torch.from_numpy(lengths)
    seed = SEED if rate else None
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    flash.flash_attention(*leaves, kv_lengths=tl, causal=True, dropout_seed=seed,
                          dropout_rate=rate).backward(torch.from_numpy(g))

    exact = [torch.from_numpy(a).double().requires_grad_() for a in (q, k, v)]
    qt, kt, vt = (x.transpose(1, 2) for x in exact)
    z = qt @ kt.transpose(-1, -2) / D ** 0.5 + flash._lengths_dense_bias(tl, 513, 513, True).double()
    p = torch.softmax(z, dim=-1)
    if rate:
        p = p * flash.hash_keep_mask(seed, B, N, 513, 513, rate).double() / (1 - rate)
    out = torch.where(torch.from_numpy(live)[:, :, None, None], (p @ vt).transpose(1, 2), 0.0)
    out.backward(torch.from_numpy(g).double())
    for name, got, want in zip(("dq", "dk", "dv"), leaves, exact):
        assert torch.isfinite(got.grad).all(), name
        assert _rel(got.grad, want.grad) < 1e-5, (name, _rel(got.grad, want.grad))
    assert not leaves[0].grad.numpy()[~live].any()


@pytest.mark.parametrize("T", [257, 513])
def test_train_layer_at_long_clips_matches_jax(monkeypatch, T):
    """A JAX TransformerEncoderLayer(use_pallas=True, causal) in train mode,
    f32, dropout 0.2, at T tokens (the temporal stage of a 256- or 512-frame
    clip), against the port's layer given the two seeds the JAX layer draws
    (recorded by wrapping jax.random.bits in an eager apply): outputs and
    every parameter gradient. JAX's layer has clip_frames = 0, so its tail
    is the XLA chain: the configuration the port runs."""
    rng = np.random.default_rng(T + 1)
    H, heads, rate, eps = 16, 2, 0.2, 1e-12
    x = rng.normal(0, 1, (B, T, H)).astype(np.float32)
    g = rng.normal(0, 1, (B, T, H)).astype(np.float32)
    lengths = np.array([T, T // 2 + 3], np.int32)
    live = np.arange(T)[None, :] < lengths[:, None]
    g[~live] = 0.0
    bias = None
    if T < 513:
        t = np.arange(T)
        masked = (t[None, :] > t[:, None])[None] | (t[None, None, :] >= lengths[:, None, None])
        bias = np.where(masked, -1e9, 0.0).astype(np.float32)[:, None]
    jlayer = JaxLayer(hidden_size=H, num_heads=heads, ff_size=4 * H, dropout_rate=rate,
                      activation="gelu", layer_norm_eps=eps, use_pallas=True, causal=True)
    jbias = None if bias is None else jnp.asarray(bias)
    jlen = jnp.asarray(lengths)
    params = jlayer.init(jax.random.PRNGKey(3), jnp.asarray(x), jbias)["params"]
    rngs = {"dropout": jax.random.PRNGKey(11)}

    def apply(p, x):
        return jlayer.apply({"params": p}, x, jbias, False, jlen, rngs=rngs)

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

    layer = TransformerEncoderLayer(H, heads, 4 * H, activation="gelu", layer_norm_eps=eps,
                                    dtype=torch.float32, generator=torch.Generator(),
                                    dropout_rate=rate, causal=True)
    layer.load_state_dict(jax_params_to_state_dict(params), strict=True)
    layer.train()
    xt = torch.from_numpy(x).requires_grad_()
    y_t = layer(xt, None if bias is None else torch.from_numpy(bias), seeds=tuple(drawn),
                kv_lengths=torch.from_numpy(lengths))
    y_t.backward(torch.from_numpy(g))

    np.testing.assert_allclose(y_t.detach().numpy()[live], np.asarray(y_j)[live], **Y_TOL)
    np.testing.assert_allclose(xt.grad.numpy()[live], np.asarray(dx_j)[live], **GRAD_TOL)
    want = jax_params_to_state_dict(grads_j)
    for name, p in layer.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=name, **GRAD_TOL)
