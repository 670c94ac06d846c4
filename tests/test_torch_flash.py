"""The port's attention core (``stlt_tpu_torch.ops.flash`` and
``ops.attention``, plain versions on the CPU) against the JAX package's
``stlt_tpu.ops.flash`` (Pallas in interpret mode, as its own tests run it).

Same numpy-seeded q, k, v through both, f32, B = 2, N = 2, D = 8.
Tolerance atol = rtol = 1e-5: both compute f32 logits, softmax and PV over
at most 513 keys, in another order of sums; the JAX blockwise kernel also
takes the softmax online over key blocks. In lengths mode the port's dead
query rows (``t >= kv_lengths[b]``) are exact zeros with lse 0, and out and
lse are compared on the live rows, where both define them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlt_tpu.ops import attention as jax_attention
from stlt_tpu.ops import flash as jax_flash
from stlt_tpu_torch.ops import attention, flash

TOL = dict(atol=1e-5, rtol=1e-5)
B, N, D = 2, 2, 8


def _qkv(T, S=None, seed=0):
    rng = np.random.default_rng(seed)
    S = T if S is None else S
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, T, N, D), (B, S, N, D), (B, S, N, D)))


def _causal_padding_bias(T, lengths):
    """Dense [B, 1, T, T] causal plus key-padding bias of the masks (-1e9)."""
    t = np.arange(T)
    masked = (t[None, :] > t[:, None])[None] | (t[None, None, :] >= np.asarray(lengths)[:, None, None])
    return np.where(masked, -1e9, 0.0).astype(np.float32)[:, None]


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("T,lengths", [(70, (70, 23)), (257, (1, 200))])
def test_short_kernel_with_causal_padding_bias_matches_jax(T, lengths):
    q, k, v = _qkv(T, seed=T)
    bias = _causal_padding_bias(T, lengths)
    want = np.asarray(jax_flash.flash_attention(q, k, v, bias=bias))
    flash.reset_launches()
    got = flash.flash_attention(*_torch(q, k, v), bias=torch.from_numpy(bias))
    assert not any(flash.LAUNCHES.values())
    assert got.dtype == torch.float32 and got.shape == (B, T, N, D)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_lengths_mode_matches_jax(causal):
    T = 513
    q, k, v = _qkv(T, seed=5)
    lengths = np.array([1, 400], np.int32)
    want = np.asarray(jax_flash.flash_attention(q, k, v, causal=causal, kv_lengths=lengths))
    want_t, want_lse = jax_flash._blockwise_forward(
        *(jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v)), None,
        causal=causal, kv_lengths=jnp.asarray(lengths),
    )
    np.testing.assert_allclose(np.asarray(want_t).transpose(0, 2, 1, 3), want, atol=0, rtol=0)
    tl = torch.from_numpy(lengths)
    got = flash.flash_attention(*_torch(q, k, v), causal=causal, kv_lengths=tl)
    out, lse = flash.blockwise_attention(*_torch(q, k, v), kv_lengths=tl, causal=causal)
    torch.testing.assert_close(got, out, atol=0, rtol=0)
    assert lse.dtype == torch.float32 and lse.shape == (B, N, T)
    live = np.arange(T)[None, :] < lengths[:, None]  # [B, T]
    np.testing.assert_allclose(out.numpy()[live], want[live], **TOL)
    np.testing.assert_allclose(lse.numpy().transpose(0, 2, 1)[live],
                               np.asarray(want_lse).transpose(0, 2, 1)[live], **TOL)
    assert not out.numpy()[~live].any() and not lse.numpy().transpose(0, 2, 1)[~live].any()


def test_lengths_below_513_take_the_dense_bias_like_jax():
    T = 80
    q, k, v = _qkv(T, seed=7)
    lengths = np.array([80, 9], np.int32)
    for causal in (True, False):
        np.testing.assert_allclose(
            flash._lengths_dense_bias(torch.from_numpy(lengths), T, T, causal).numpy(),
            np.asarray(jax_flash._lengths_dense_bias(lengths, T, T, causal)), atol=0, rtol=0)
        want = np.asarray(jax_flash.flash_attention(q, k, v, causal=causal, kv_lengths=lengths))
        got = flash.flash_attention(*_torch(q, k, v), causal=causal, kv_lengths=torch.from_numpy(lengths))
        np.testing.assert_allclose(got.numpy(), want, **TOL)  # every row, as JAX


def test_dense_bias_blockwise_on_the_cpu_matches_jax():
    """The dense-bias mode of the blockwise kernel (the card's kernel is held
    against this plain version in tests/test_torch_cuda.py): its plain
    version computes every row like JAX's."""
    T = 513
    q, k, v = _qkv(T, seed=9)
    bias = _causal_padding_bias(T, (513, 77))
    want = np.asarray(jax_flash.flash_attention(q, k, v, bias=bias, causal=True))
    got = flash.flash_attention(*_torch(q, k, v), bias=torch.from_numpy(bias), causal=True)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("T", [70, 513])
def test_hashed_dropout_plain_matches_jax(T):
    """The plain versions drop probabilities with the kernels' hashed keep
    bits, as both JAX kernels do (train path on the CPU)."""
    q, k, v = _qkv(T, seed=11)
    seed, rate = 123456789, 0.2
    lengths = np.array([T, 31], np.int32)
    kw = dict(kv_lengths=lengths, causal=True) if T >= 513 else dict(bias=_causal_padding_bias(T, lengths))
    want = np.asarray(jax_flash.flash_attention(
        q, k, v, dropout_rate=rate, dropout_seed=jnp.uint32(seed), **kw))
    tkw = {key: torch.from_numpy(val) if isinstance(val, np.ndarray) else val for key, val in kw.items()}
    got = flash.flash_attention(*_torch(q, k, v), dropout_rate=rate, dropout_seed=seed, **tkw).numpy()
    live = np.arange(T)[None, :] < lengths[:, None]
    np.testing.assert_allclose(got[live], want[live], **TOL)


def test_dot_product_attention_dispatches_like_jax():
    T = 70
    q, k, v = _qkv(T, seed=13)
    bias = _causal_padding_bias(T, (70, 50))
    want = np.asarray(jax_attention.dot_product_attention(q, k, v, bias, use_pallas=True))
    for use_pallas in (False, True):
        got = attention.dot_product_attention(*_torch(q, k, v), torch.from_numpy(bias),
                                              use_pallas=use_pallas)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_bf16_keeps_f32_softmax_and_rounds_the_output():
    """bf16 q/k/v are promoted to f32 and the output is rounded to bf16 once:
    the plain version equals the f32 computation on the same bf16 values,
    rounded."""
    T = 70
    q, k, v = (t.to(torch.bfloat16) for t in _torch(*_qkv(T, seed=15)))
    bias = torch.from_numpy(_causal_padding_bias(T, (70, 12)))
    got = flash.fused_attention(q, k, v, bias)
    want = flash.fused_attention(q.float(), k.float(), v.float(), bias).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_ring_offsets_are_refused():
    """The ring-offset mode of the forward and of the backward (rows 8-10)
    at offsets (0, 0) is the lengths mode, bit for bit (both are held
    against JAX at other offsets in test_torch_ring*.py)."""
    q, k, v = _torch(*_qkv(513, seed=1))
    lengths = torch.tensor([3, 513])
    out, lse = flash.blockwise_attention(q, k, v, kv_lengths=lengths, causal=True,
                                         offsets=torch.tensor([0, 0]))
    want, want_lse = flash.blockwise_attention(q, k, v, kv_lengths=lengths, causal=True)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    dsum = flash._dsum(q, out, lengths)
    got = flash.blockwise_attention_bwd(q, k, v, q, lse, dsum, kv_lengths=lengths, causal=True,
                                        offsets=torch.tensor([0, 0]))
    want = flash.blockwise_attention_bwd(q, k, v, q, lse, dsum, kv_lengths=lengths, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
