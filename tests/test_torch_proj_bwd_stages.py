"""The stages of the bf16 train sublayer's backward
(``csrc/fused_proj_attention_bwd.cu`` ``launch_tc``), plain, on the CPU: the
contract that splitting row 4 at its rounding points keeps.

``fused_proj_attention_train_bwd_stages_plain`` packs the live rows of x and
g, recomputes qkv on the packed tokens (rounded), takes do = g Wo^T in f32,
runs the short-attention backward on the packed rows with the keep bits
hashed at the original rows, scatters dqkv back with dead rows zero and sums
dWo and dbo over the packed tokens. It is held:

- against the port's plain backward ``fused_proj_attention_train_bwd_plain``
  in f32 and bf16: dqkv bit for bit (the same sums in the same order on the
  live rows, zeros on the dead ones), and so the packed rows, qkv and attn
  that it comes from; dWo and dbo within a relative Frobenius-norm error of
  1e-6, because they sum over the packed tokens only, where the plain
  backward sums every token with the dead rows' zeros among them (another
  blocking of the same f32 sums);
- with ``proj_input_grads`` on top, against JAX's five gradients in f32
  (``jax.vjp`` of ``stlt_tpu.ops.fused_encoder.fused_proj_attention_train``,
  interpret mode, as ``tests/test_torch_train_ops.py`` runs it) at atol =
  rtol = 1e-4: the same f32 function with its sums in another order, each
  gradient a sum over every token. Live rows are compared; dead rows' dx is
  exact zeros.

Two negative cases show the traps of the split: the keep bits hashed at the
packed row differ from JAX's wherever a dead row precedes a live one, and do
rounded to the compute dtype is not the plain backward, which keeps it f32.
The bf16 wrapper's weight operands (``proj_bwd_weights``) are the
parameters' own storage.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlt_tpu.ops import fused_encoder as jfe
from stlt_tpu_torch.models.layers import MultiHeadAttention
from stlt_tpu_torch.ops import fused_encoder as tfe
from tests.jax_reference import jit_vjp

SEED = 0x5EED
SUM_REL = 1e-6
JAX_TOL = dict(atol=1e-4, rtol=1e-4)
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
H, N = 64, 4
# Dead rows at the start, in the middle and at the end.
ROWS_LIVE = np.array([0, 1, 1, 0, 0, 1, 0, 1, 1, 0], bool)


def _case(T: int, seed: int = 0, rows_live=ROWS_LIVE):
    """x [B, T, H], a bias (key padding at T = 8, causal plus padding
    otherwise), a cotangent g (zero on dead rows, as in the model) and f32
    weights (input-major, as the ops take them), numpy."""
    B = rows_live.size
    rng = np.random.default_rng(seed + 7 * T)
    if T == 8:
        pad = rng.random((B, T)) < 0.3
        pad[:, 0] = False
        bias = np.where(pad, -1e9, 0.0).astype(np.float32)[:, None, None, :]
    else:
        lengths = rng.integers(T // 2, T + 1, B)
        pad = np.arange(T)[None, :] >= lengths[:, None]
        causal = np.where(np.tril(np.ones((T, T), bool)), 0.0, -1e9)
        bias = (causal[None, None] + np.where(pad, -1e9, 0.0)[:, None, None, :]).astype(np.float32)
    x = rng.normal(0, 1, (B, T, H)).astype(np.float32)
    g = rng.normal(0, 1, (B, T, H)).astype(np.float32)
    g[~rows_live] = 0.0
    w = lambda *s: rng.normal(0, 0.1, s).astype(np.float32)  # noqa: E731
    return x, bias, g, [w(H, 3 * H), w(3 * H), w(H, H), w(H)]


def _rel(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def _bwd_args(x, bias, g, w, cd):
    wqkv, bqkv, wo, _ = (torch.from_numpy(a) for a in w)
    return (torch.from_numpy(x).to(cd), wqkv, bqkv, wo, torch.from_numpy(bias),
            torch.from_numpy(g).to(cd), SEED)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("T", [8, 17, 33])
def test_bwd_stages_compose_to_the_plain_backward(T, rate, dtype):
    cd = TDT[dtype]
    args = _bwd_args(*_case(T), cd)
    kw = dict(num_heads=N, dropout_rate=rate, compute_dtype=cd, rows_live=torch.from_numpy(ROWS_LIVE))
    want = tfe.fused_proj_attention_train_bwd_plain(*args, **kw)
    got = tfe.fused_proj_attention_train_bwd_stages_plain(*args, **kw)
    assert got[0].dtype == cd and got[1].dtype == got[2].dtype == torch.float32
    assert torch.equal(got[0], want[0]), (got[0].float() - want[0].float()).abs().max()
    assert not got[0][~torch.from_numpy(ROWS_LIVE)].any()
    for a, b in zip(got[1:], want[1:]):
        assert _rel(a, b) < SUM_REL


def test_bwd_stages_without_rows_live_pack_every_row():
    cd = torch.bfloat16
    args = _bwd_args(*_case(17, rows_live=np.ones(6, bool)), cd)
    kw = dict(num_heads=N, dropout_rate=0.1, compute_dtype=cd)
    want = tfe.fused_proj_attention_train_bwd_plain(*args, **kw)
    got = tfe.fused_proj_attention_train_bwd_stages_plain(*args, **kw)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        assert _rel(a, b) < SUM_REL


def _jax_grads(x, bias, g, w, rate, rows_live=ROWS_LIVE):
    bo = np.zeros(H, np.float32)

    def op(x, wqkv, bqkv, wo, bo):
        return jfe.fused_proj_attention_train(N, rate, x, wqkv, bqkv, wo, bo, jnp.asarray(bias),
                                              jnp.uint32(SEED), jnp.asarray(rows_live))

    _, grads = jit_vjp(op, [jnp.asarray(a) for a in (x, *w[:3], bo)], jnp.asarray(g))
    return [np.asarray(t) for t in grads]


def _stages_grads(x, bias, g, w, rate, rows_live=ROWS_LIVE):
    cd = torch.float32
    args = _bwd_args(x, bias, g, w, cd)
    dqkv, dwo, dbo = tfe.fused_proj_attention_train_bwd_stages_plain(
        *args, num_heads=N, dropout_rate=rate, compute_dtype=cd, rows_live=torch.from_numpy(rows_live))
    return [t.numpy() for t in (*tfe.proj_input_grads(args[0], args[1], dqkv, cd), dwo, dbo)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("T", [8, 17, 33])
def test_bwd_stages_match_jax(T, rate):
    """The stages plus the wrapper's three GEMMs against JAX's five
    gradients in f32, ragged rows_live with dead rows in the middle."""
    case = _case(T)
    want = _jax_grads(*case, rate)
    got = _stages_grads(*case, rate)
    for name, a, b in zip(("dx", "dwqkv", "dbqkv", "dwo", "dbo"), got, want):
        if name == "dx":
            assert not a[~ROWS_LIVE].any()
            a, b = a[ROWS_LIVE], b[ROWS_LIVE]
        np.testing.assert_allclose(a, b, err_msg=name, **JAX_TOL)


def test_keep_bits_at_the_packed_row_differ_from_jax():
    """The trap of the split: the attention backward hashing the keep bits
    at the packed row (its bias still read at the original row) gives JAX's
    dx on the live rows before the first dead row, where packed and
    original indices coincide, and other gradients on every live row after
    it."""
    T, rate = 17, 0.1
    rows_live = np.array([1, 1, 0, 1, 0, 0, 1, 1], bool)
    x, bias, g, w = _case(T, rows_live=rows_live)
    want = _jax_grads(x, bias, g, w, rate, rows_live)[0]
    cd = torch.float32
    xt, wqkv, bqkv, wo, bt, gt, _ = _bwd_args(x, bias, g, w, cd)
    rows, count = tfe.live_rows_plain(torch.from_numpy(rows_live), rows_live.size)
    live = rows[:count].long()
    qkv = tfe.projection_plain(xt[live].reshape(count * T, H), wqkv.t(), bqkv, cd)
    q, k, v = qkv.reshape(count, T, 3 * H).split(H, dim=-1)
    do = gt[live] @ wo.t()
    b3 = tfe._bias3(bt, rows_live.size, T, None)[live]  # the bias at the original rows
    dqkv_p, _ = tfe.short_attention_bwd_plain(q, k, v, do, b3, None, num_heads=N, seed=SEED,
                                              dropout_rate=rate)
    dx = (dqkv_p @ wqkv.t()).numpy()
    first_dead = int(np.argmin(rows_live))
    for r, orig in enumerate(live.tolist()):
        err = np.abs(dx[r] - want[orig]).max()
        if orig < first_dead:
            assert err <= 1e-4, (orig, err)
        else:
            assert err > 1e-2, (orig, err)  # other keep bits: whole probabilities dropped or kept


def test_do_rounded_to_the_compute_dtype_is_not_the_plain_backward():
    """do = g Wo^T is an f32 value of the contract, not a rounding point:
    the stages with do rounded to bf16 move dqkv off the plain backward's
    bits, by a relative norm of ~2.7e-3 here (dWo does not read do). The
    same composition with do in f32 gives the plain backward's bits."""
    T, cd, rate = 17, torch.bfloat16, 0.1
    x, bias, g, w = _case(T)
    xt, wqkv, bqkv, wo, bt, gt, _ = args = _bwd_args(x, bias, g, w, cd)
    want = tfe.fused_proj_attention_train_bwd_plain(*args, num_heads=N, dropout_rate=rate, compute_dtype=cd,
                                                    rows_live=torch.from_numpy(ROWS_LIVE))
    rows, count = tfe.live_rows_plain(torch.from_numpy(ROWS_LIVE), ROWS_LIVE.size)
    live = rows[:count].long()
    qkv = tfe.projection_plain(xt[live].reshape(count * T, H), wqkv.t(), bqkv, cd).to(cd)
    q, k, v = qkv.reshape(count, T, 3 * H).split(H, dim=-1)
    gp = gt[live].float()
    do = gp @ wo.to(cd).float().t()
    b3 = tfe._bias3(bt, ROWS_LIVE.size, T, None)
    results = []
    for d in (do, do.to(cd).float()):
        dqkv_p, attn = tfe.short_attention_bwd_plain(q, k, v, d, b3, live, num_heads=N, seed=SEED,
                                                     dropout_rate=rate)
        dqkv = torch.zeros_like(want[0])
        dqkv[live] = dqkv_p.to(cd)
        results.append((dqkv, attn.reshape(-1, H).float().t() @ gp.reshape(-1, H)))
    (sound, sound_dwo), (rounded, rounded_dwo) = results
    assert torch.equal(sound, want[0]) and _rel(sound_dwo, want[1]) < SUM_REL
    assert _rel(rounded, want[0]) > 1e-3 and torch.equal(rounded_dwo, sound_dwo)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_weight_operands_are_the_parameters_own_storage(dtype):
    """The views the attention layer hands the train op
    (``in_proj_weight.t()``, ``out_proj.weight.t()``) come back from
    ``proj_bwd_weights`` as the parameters' own storage in the compute
    dtype, [3H, H] and [H_out, H_in]; and the one conversion the autograd
    backward makes of Wqkv (``wqkv.to(cd)``) keeps that layout, so the
    wrapper reads the converted tensor in place."""
    attn = MultiHeadAttention(H, N, torch.float32, torch.Generator().manual_seed(0)).to(dtype)
    w, wo = attn.in_proj_weight, attn.out_proj.weight
    got_w, got_o = tfe.proj_bwd_weights(w.t(), wo.t(), dtype)
    assert got_w.data_ptr() == w.data_ptr() and tuple(got_w.shape) == (3 * H, H)
    assert got_o.data_ptr() == wo.data_ptr() and tuple(got_o.shape) == (H, H)
    f32_view = w.float().t()
    converted = f32_view.to(torch.bfloat16)
    assert converted.stride() == f32_view.stride()
    stored, _ = tfe.proj_bwd_weights(converted, wo.t(), torch.bfloat16)
    assert stored.data_ptr() == converted.data_ptr()


def test_bwd_scratch_views_cover_the_scratch():
    B, T = 7, 17
    x = torch.empty(B, T, H, dtype=torch.bfloat16)
    scratch = tfe.proj_bwd_scratch(B, T, H, x)
    v = tfe.proj_bwd_scratch_views(scratch, B, T, H)
    M = B * T
    chunk, splits = tfe.proj_bwd_splits(M)
    assert v["attn"].shape == v["g"].shape == (M, H) and v["qkv"].shape == (M, 3 * H)
    assert v["do"].shape == (M, H) and v["do"].dtype == torch.float32
    assert v["rows"].shape == (B,) and v["count"].shape == (1,)
    assert v["partial"].shape == (splits, H, H) and v["partial_b"].shape == (splits, H)
    ends = [t.data_ptr() - scratch.data_ptr() + t.numel() * t.element_size() for t in v.values()]
    assert max(ends) == scratch.numel()
    for name in ("qkv", "do", "rows", "partial", "partial_b"):
        assert (v[name].data_ptr() - scratch.data_ptr()) % 16 == 0, name


@pytest.mark.parametrize("tokens", [1, 64, 1000, 8704, 69632])
def test_bwd_splits_cover_the_packed_rows_in_64_row_steps(tokens):
    chunk, splits = tfe.proj_bwd_splits(tokens)
    assert chunk % 64 == 0 and 1 <= splits <= 8
    assert chunk * splits >= tokens > chunk * (splits - 1)
