"""Port ops (stlt_tpu_torch.ops.fused_encoder, plain versions on the CPU)
against the JAX package's Pallas kernels (interpret mode on the CPU).

Same numpy-seeded inputs through both. Live rows are compared; the port's
dead rows must be exact zeros (the JAX kernels zero whole dead row blocks
only, so their dead rows are not compared).

Tolerances: f32 atol=1e-5 (the two compute the same f32 sums in other
orders). bf16 in this process: atol=6e-2 and rtol=2e-2. The port rounds to
bf16 where the kernel contract rounds, but XLA on the CPU runs the
interpret-mode kernels with ``--xla_allow_excess_precision`` on (its
default) and keeps the bf16 residual sums in f32, so a LayerNorm input
differs by one bf16 rounding and about half the tail's outputs by one or
two bf16 steps (2**-8 relative, 3e-2 at the |y| ~ 4 of a LayerNorm output).
With that flag off (:func:`test_bf16_matches_the_kernel_contract_bitwise`,
in a fresh process) the tail agrees bit for bit and the attention to one
bf16 step.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlt_tpu.ops import fused_encoder as jfe
from stlt_tpu.ops import masks as jmasks
from stlt_tpu_torch.ops import fused_encoder as tfe
from stlt_tpu_torch.ops import masks as tmasks

TOL = {
    "float32": dict(atol=1e-5, rtol=1e-5),
    "bfloat16": dict(atol=6e-2, rtol=2e-2),
}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _to_numpy(t):
    return t.detach().to(torch.float32).numpy()


def _case(stage: str, ragged: bool, seed: int):
    """(x [B, T, H] f32, additive bias numpy, live mask or None, kind) for a
    spatial (T=8, key padding, rows_live) or temporal (T=17, causal plus
    padding, tokens_live) stage input."""
    rng = np.random.default_rng(seed)
    H = 64
    if stage == "spatial":
        B, T = 10, 8
        pad = rng.random((B, T)) < 0.3
        pad[:, 0] = False  # the CLS token is never padding
        bias = np.where(pad, -1e9, 0.0).astype(np.float32)[:, None, None, :]
        live = rng.random(B) < 0.6 if ragged else None
        if live is not None:
            live[0] = True
    else:
        B, T = 3, 17
        lengths = rng.integers(5, T + 1, B) if ragged else np.full(B, T)
        pad = np.arange(T)[None, :] >= lengths[:, None]
        causal = np.where(np.tril(np.ones((T, T), bool)), 0.0, -1e9)
        bias = (causal[None, None] + np.where(pad, -1e9, 0.0)[:, None, None, :]).astype(np.float32)
        live = ~pad if ragged else None
    x = rng.normal(0, 1, (B, T, H)).astype(np.float32)
    return x, bias, live


def _weights(seed: int, H: int, FF: int):
    rng = np.random.default_rng(seed + 100)
    w = lambda *s: rng.normal(0, 0.08, s).astype(np.float32)
    return {
        "wqkv": w(H, 3 * H), "bqkv": w(3 * H), "wo": w(H, H), "bo": w(H),
        "n1s": 1.0 + w(H), "n1b": w(H), "w1": w(H, FF), "b1": w(FF),
        "w2": w(FF, H), "b2": w(H), "n2s": 1.0 + w(H), "n2b": w(H),
    }


def _live_rows(stage, live, B, T):
    """[B, T] bool of the rows/tokens whose outputs are defined."""
    if live is None:
        return np.ones((B, T), bool)
    if stage == "spatial":
        return np.repeat(live[:, None], T, axis=1)
    return live


CASES = [
    (stage, ragged, dtype)
    for stage in ("spatial", "temporal")
    for ragged in (False, True)
    for dtype in ("float32", "bfloat16")
]


@pytest.mark.parametrize("stage,ragged,dtype", CASES)
def test_proj_attention_plain_matches_jax(stage, ragged, dtype):
    x, bias, live = _case(stage, ragged, seed=1)
    B, T, H = x.shape
    w = _weights(1, H, 4 * H)
    xj = jnp.asarray(x, JDT[dtype])
    rows_live = None
    if live is not None and stage == "spatial":
        rows_live = live
    want = jfe.fused_proj_attention(
        xj, jnp.asarray(w["wqkv"]), jnp.asarray(w["bqkv"]), jnp.asarray(w["wo"]),
        jnp.asarray(w["bo"]), jnp.asarray(bias), num_heads=4,
        compute_dtype=JDT[dtype],
        rows_live=None if rows_live is None else jnp.asarray(rows_live),
    )
    got = tfe.fused_proj_attention(
        _to_torch(xj), *(torch.from_numpy(w[k]) for k in ("wqkv", "bqkv", "wo", "bo")),
        torch.from_numpy(bias), num_heads=4, compute_dtype=TDT[dtype],
        rows_live=None if rows_live is None else torch.from_numpy(rows_live),
    )
    assert got.dtype == TDT[dtype] and tuple(got.shape) == (B, T, H)
    got, want = _to_numpy(got), np.asarray(want, np.float32)
    mask = _live_rows(stage, rows_live, B, T)
    np.testing.assert_allclose(got[mask], want[mask], **TOL[dtype])
    assert np.all(got[~mask] == 0.0)


@pytest.mark.parametrize("stage,ragged,dtype", CASES)
def test_layer_tail_plain_matches_jax(stage, ragged, dtype):
    x, _, live = _case(stage, ragged, seed=2)
    B, T, H = x.shape
    w = _weights(2, H, 4 * H)
    a = np.random.default_rng(3).normal(0, 1, x.shape).astype(np.float32)
    xj, aj = jnp.asarray(x, JDT[dtype]), jnp.asarray(a, JDT[dtype])
    names = ("n1s", "n1b", "w1", "b1", "w2", "b2", "n2s", "n2b")
    kw = {}
    if live is not None:
        kw = {"rows_live" if stage == "spatial" else "tokens_live": live}
    want = jfe.fused_layer_tail(
        xj, aj, *(jnp.asarray(w[k]) for k in names), eps=1e-12,
        compute_dtype=JDT[dtype], gelu_approximate=dtype == "bfloat16",
        **{k: jnp.asarray(v) for k, v in kw.items()},
    )
    got = tfe.fused_layer_tail(
        _to_torch(xj), _to_torch(aj), *(torch.from_numpy(w[k]) for k in names),
        eps=1e-12, compute_dtype=TDT[dtype], gelu_approximate=dtype == "bfloat16",
        **{k: torch.from_numpy(v) for k, v in kw.items()},
    )
    assert got.dtype == TDT[dtype] and tuple(got.shape) == (B, T, H)
    got, want = _to_numpy(got), np.asarray(want, np.float32)
    mask = _live_rows(stage, live, B, T)
    np.testing.assert_allclose(got[mask], want[mask], **TOL[dtype])
    assert np.all(got[~mask] == 0.0)


def test_proj_attention_without_bias_matches_jax():
    x, _, _ = _case("spatial", False, seed=4)
    w = _weights(4, 64, 256)
    args = [w[k] for k in ("wqkv", "bqkv", "wo", "bo")]
    want = jfe.fused_proj_attention(
        jnp.asarray(x), *map(jnp.asarray, args), None, num_heads=4, compute_dtype=jnp.float32,
    )
    got = tfe.fused_proj_attention(
        torch.from_numpy(x), *map(torch.from_numpy, args), None, num_heads=4,
        compute_dtype=torch.float32,
    )
    np.testing.assert_allclose(_to_numpy(got), np.asarray(want), **TOL["float32"])


def test_relu_tail_matches_jax():
    x, _, _ = _case("temporal", False, seed=5)
    w = _weights(5, 64, 256)
    names = ("n1s", "n1b", "w1", "b1", "w2", "b2", "n2s", "n2b")
    want = jfe.fused_layer_tail(
        jnp.asarray(x), jnp.asarray(x[::-1]), *(jnp.asarray(w[k]) for k in names),
        eps=1e-5, compute_dtype=jnp.float32, activation="relu",
    )
    got = tfe.fused_layer_tail(
        torch.from_numpy(x), torch.from_numpy(np.array(x[::-1])),
        *(torch.from_numpy(w[k]) for k in names), eps=1e-5,
        compute_dtype=torch.float32, activation="relu",
    )
    np.testing.assert_allclose(_to_numpy(got), np.asarray(want), **TOL["float32"])


@pytest.mark.parametrize("T", [8, 17])
def test_masks_match_jax(T):
    pad = np.random.default_rng(T).random((3, T)) < 0.4
    np.testing.assert_array_equal(
        tmasks.causal_bias(T).numpy(), np.asarray(jmasks.causal_bias(T))
    )
    np.testing.assert_array_equal(
        tmasks.key_padding_bias(torch.from_numpy(pad)).numpy(),
        np.asarray(jmasks.key_padding_bias(jnp.asarray(pad))),
    )


def test_fully_masked_row_is_uniform_not_nan():
    """A row whose keys are all masked gives a uniform softmax (finite
    MASK_VALUE), so the output stays finite."""
    x = torch.from_numpy(np.random.default_rng(6).normal(0, 1, (2, 8, 64)).astype(np.float32))
    w = _weights(6, 64, 256)
    bias = torch.full((2, 1, 1, 8), tmasks.MASK_VALUE)
    out = tfe.fused_proj_attention(
        x, *(torch.from_numpy(w[k]) for k in ("wqkv", "bqkv", "wo", "bo")), bias,
        num_heads=4, compute_dtype=torch.float32,
    )
    assert torch.isfinite(out).all()


def test_kernel_choice_is_by_device_alone():
    """A CPU tensor takes the plain version and counts no launch; any other
    device than cpu or cuda raises."""
    tfe.reset_launches()
    x, bias, live = _case("spatial", True, seed=7)
    w = _weights(7, 64, 256)
    tfe.fused_proj_attention(
        torch.from_numpy(x), *(torch.from_numpy(w[k]) for k in ("wqkv", "bqkv", "wo", "bo")),
        torch.from_numpy(bias), num_heads=4, compute_dtype=torch.float32,
    )
    assert tfe.LAUNCHES == {"fused_proj_attention": 0, "fused_layer_tail": 0}
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        tfe.fused_proj_attention(
            torch.empty(2, 8, 64, device="meta"), *(torch.empty(s, device="meta") for s in
                                                   ((64, 192), (192,), (64, 64), (64,))),
            None, num_heads=4, compute_dtype=torch.float32,
        )


_BITWISE_SCRIPT = textwrap.dedent(
    """
    import jax, jax.numpy as jnp, numpy as np, torch
    jax.config.update("jax_platforms", "cpu")
    from tests.test_torch_ops import _case, _weights, _to_torch, _to_numpy, _live_rows
    from stlt_tpu.ops import fused_encoder as jfe
    from stlt_tpu_torch.ops import fused_encoder as tfe

    bf = jnp.bfloat16
    names = ("n1s", "n1b", "w1", "b1", "w2", "b2", "n2s", "n2b")
    for stage in ("spatial", "temporal"):
        x, bias, live = _case(stage, True, seed=11)
        B, T, H = x.shape
        w = _weights(11, H, 4 * H)
        xj = jnp.asarray(x, bf)
        a = jnp.asarray(np.random.default_rng(12).normal(0, 1, x.shape), bf)
        rows_live = live if stage == "spatial" else None
        want = jfe.fused_proj_attention(
            xj, *(jnp.asarray(w[k]) for k in ("wqkv", "bqkv", "wo", "bo")),
            jnp.asarray(bias), num_heads=4, compute_dtype=bf,
            rows_live=None if rows_live is None else jnp.asarray(rows_live))
        got = tfe.fused_proj_attention(
            _to_torch(xj), *(torch.from_numpy(w[k]) for k in ("wqkv", "bqkv", "wo", "bo")),
            torch.from_numpy(bias), num_heads=4, compute_dtype=torch.bfloat16,
            rows_live=None if rows_live is None else torch.from_numpy(rows_live))
        m = _live_rows(stage, rows_live, B, T)
        np.testing.assert_allclose(_to_numpy(got)[m], np.asarray(want, np.float32)[m],
                                   atol=2**-9, rtol=2**-7)
        kw = {"rows_live" if stage == "spatial" else "tokens_live": live}
        want = jfe.fused_layer_tail(
            xj, a, *(jnp.asarray(w[k]) for k in names), eps=1e-12, compute_dtype=bf,
            gelu_approximate=True, **{k: jnp.asarray(v) for k, v in kw.items()})
        got = tfe.fused_layer_tail(
            _to_torch(xj), _to_torch(a), *(torch.from_numpy(w[k]) for k in names),
            eps=1e-12, compute_dtype=torch.bfloat16, gelu_approximate=True,
            **{k: torch.from_numpy(v) for k, v in kw.items()})
        m = _live_rows(stage, live, B, T)
        np.testing.assert_array_equal(_to_numpy(got)[m], np.asarray(want, np.float32)[m])
    print("BITWISE_OK")
    """
)


def test_bf16_matches_the_kernel_contract_bitwise():
    """In a process whose XLA rounds every bf16 value it is asked to (excess
    precision off), the port's bf16 tail equals the Pallas tail bit for bit
    and its attention is within one bf16 step (sums in another order): the
    rounding points, the f32 bias adds and the bf16 GELU chain all match."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_allow_excess_precision=false")
    proc = subprocess.run(
        [sys.executable, "-c", _BITWISE_SCRIPT], cwd=root, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0 and "BITWISE_OK" in proc.stdout, proc.stderr[-4000:]


@pytest.mark.parametrize("approximate", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_matches_jax_op_for_op(dtype, approximate):
    """The port's GELU rounds where ``jax.nn.gelu`` rounds: bit for bit in
    bf16 (a GELU taken in f32 and rounded once differs in ~45% of bf16
    outputs), to the f32 erfc/tanh ulp in f32."""
    x = np.random.default_rng(13).normal(0, 2, 4096).astype(np.float32)
    xj = jnp.asarray(x, JDT[dtype])
    want = np.asarray(jax.nn.gelu(xj, approximate=approximate), np.float32)
    got = _to_numpy(tfe.gelu(_to_torch(xj), approximate))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
