"""The stages of the bf16 short-attention sublayers (``csrc/sublayer.cuh``),
plain, on the CPU: the contract that splitting rows 1, 3 and 5 at their
rounding points keeps.

``fused_proj_attention_stages_plain`` (pack the live rows, the QKV GEMM
rounded, the short attention on the packed rows with the keep bits hashed at
the original rows, the out GEMM scattered back with dead rows zero) and
``fused_cross_attention_stages_plain`` (the q and kv GEMMs, the attention,
the out GEMM) are held:

- against the port's plain ops, bit for bit in f32 and bf16 (the same sums
  in the same order);
- against the JAX package's Pallas kernels (interpret mode, as
  ``tests/test_torch_ops.py`` runs them) in f32 at atol = rtol = 2e-5 (the
  same f32 function with its sums in another order), live rows compared
  (the JAX kernels zero whole dead row blocks only).

A negative case shows the trap of the split: the keep bits hashed at the
packed row index instead of the original one differ from JAX's wherever a
dead row precedes a live one. And the bf16 kernels read the weights in the
model's parameter storage: ``weight_storage`` of the views the model passes
is that storage.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlt_tpu.ops import fused_encoder as jfe
from stlt_tpu_torch.models.layers import MultiHeadAttention
from stlt_tpu_torch.ops import fused_encoder as tfe

SEED = 0x5EED
JAX_TOL = dict(atol=2e-5, rtol=2e-5)
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
H, N = 64, 4
# Dead rows at the start, in the middle and at the end.
ROWS_LIVE = np.array([0, 1, 1, 0, 0, 1, 0, 1, 1, 0], bool)


def _case(T: int, seed: int = 0, B: int = ROWS_LIVE.size):
    """x [B, T, H], a bias (key padding at T = 8, causal plus padding
    otherwise) and f32 weights (input-major, as the ops take them), numpy."""
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
    x = rng.normal(0, 1, (B, T, H)).astype(np.float32)
    w = lambda *s: rng.normal(0, 0.1, s).astype(np.float32)  # noqa: E731
    return x, bias, [w(H, 3 * H), w(3 * H), w(H, H), w(H)]


def _cross_case(T: int, S: int, seed: int = 0):
    rng = np.random.default_rng(seed + 100 * T + S)
    B = 3
    pad = rng.random((B, S)) < 0.3
    pad[:, 0] = False
    bias = np.where(pad, -1e9, 0.0).astype(np.float32)[:, None, None, :]
    w = lambda *s: rng.normal(0, 0.1, s).astype(np.float32)  # noqa: E731
    x = rng.normal(0, 1, (B, T, H)).astype(np.float32)
    ctx = rng.normal(0, 1, (B, S, H)).astype(np.float32)
    return x, ctx, bias, [w(H, H), w(H), w(H, 2 * H), w(2 * H), w(H, H), w(H)]


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_live_rows_pack_in_order_with_the_dead_after():
    rows, count = tfe.live_rows_plain(torch.from_numpy(ROWS_LIVE), ROWS_LIVE.size)
    assert rows.dtype == torch.int32 and count == 5
    assert rows.tolist() == [1, 2, 5, 7, 8, 0, 3, 4, 6, 9]
    rows, count = tfe.live_rows_plain(None, 4)
    assert rows.tolist() == [0, 1, 2, 3] and count == 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["eval", "eval_all_live", "train"])
@pytest.mark.parametrize("T", [8, 17, 33])
def test_proj_stages_compose_to_the_plain_op(T, mode, dtype):
    """Rows 1 and 3: the stages give the plain op's bits (train: rate 0.1)."""
    x, bias, w = _case(T)
    cd = TDT[dtype]
    xt = torch.from_numpy(x).to(cd)
    rows_live = None if mode == "eval_all_live" else torch.from_numpy(ROWS_LIVE)
    kw = dict(num_heads=N, compute_dtype=cd, rows_live=rows_live)
    args = (xt, *_t(w), torch.from_numpy(bias))
    if mode == "train":
        want = tfe.fused_proj_attention_train_plain(*args, SEED, dropout_rate=0.1, **kw)
        got = tfe.fused_proj_attention_stages_plain(*args, seed=SEED, dropout_rate=0.1, **kw)
    else:
        want = tfe.fused_proj_attention_plain(*args, **kw)
        got = tfe.fused_proj_attention_stages_plain(*args, **kw)
    got = got.to(want.dtype)
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()
    if rows_live is not None:
        assert not got[~rows_live].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,S", [(17, 33), (33, 17), (8, 64)])
def test_cross_stages_compose_to_the_plain_op(T, S, dtype):
    """Row 5: the stages give the plain op's bits."""
    x, ctx, bias, w = _cross_case(T, S)
    cd = TDT[dtype]
    args = (torch.from_numpy(x).to(cd), torch.from_numpy(ctx).to(cd), *_t(w), torch.from_numpy(bias))
    want = tfe.fused_cross_attention_plain(*args, num_heads=N, compute_dtype=cd)
    got = tfe.fused_cross_attention_stages_plain(*args, num_heads=N, compute_dtype=cd).to(want.dtype)
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()


def _jax_proj(x, bias, w, train: bool, rows_live=ROWS_LIVE):
    jw = [jnp.asarray(a) for a in w]
    if train:
        return jfe.fused_proj_attention_train(N, 0.1, jnp.asarray(x), *jw, jnp.asarray(bias),
                                              jnp.uint32(SEED), jnp.asarray(rows_live))
    return jfe.fused_proj_attention(jnp.asarray(x), *jw, jnp.asarray(bias), num_heads=N,
                                    compute_dtype=jnp.float32, rows_live=jnp.asarray(rows_live))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("T", [8, 17, 33])
def test_proj_stages_match_jax(T, train):
    """Rows 1 and 3 in f32: the stages against JAX's Pallas kernel (train:
    its forward at rate 0.1, the same keep bits), ragged rows_live with dead
    rows in the middle."""
    x, bias, w = _case(T)
    want = np.asarray(_jax_proj(x, bias, w, train))
    got = tfe.fused_proj_attention_stages_plain(
        *_t([x, *w]), torch.from_numpy(bias), num_heads=N, compute_dtype=torch.float32,
        rows_live=torch.from_numpy(ROWS_LIVE), seed=SEED if train else None,
        dropout_rate=0.1 if train else 0.0).numpy()
    np.testing.assert_allclose(got[ROWS_LIVE], want[ROWS_LIVE], **JAX_TOL)
    assert not got[~ROWS_LIVE].any()


@pytest.mark.parametrize("T,S", [(17, 33), (33, 17)])
def test_cross_stages_match_jax(T, S):
    """Row 5 in f32: the stages against JAX's Pallas kernel."""
    x, ctx, bias, w = _cross_case(T, S)
    want = jfe.fused_cross_attention(jnp.asarray(x), jnp.asarray(ctx), *map(jnp.asarray, w),
                                     jnp.asarray(bias), num_heads=N, compute_dtype=jnp.float32)
    got = tfe.fused_cross_attention_stages_plain(*_t([x, ctx, *w]), torch.from_numpy(bias), num_heads=N,
                                                 compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **JAX_TOL)


def test_keep_bits_at_the_packed_row_differ_from_jax():
    """The trap of the split: the attention stage hashing the keep bits at
    the packed row (its bias still read at the original row) agrees with
    JAX's train forward on the live rows before the first dead row, where
    packed and original indices coincide, and differs on every live row
    after it."""
    T = 17
    rows_live = np.array([1, 1, 0, 1, 0, 0, 1, 1], bool)
    x, bias, w = _case(T, B=rows_live.size)
    want = np.asarray(_jax_proj(x, bias, w, True, rows_live))
    cd = torch.float32
    xt, wqkv, bqkv, wo, bo = _t([x, *w])
    rows, count = tfe.live_rows_plain(torch.from_numpy(rows_live), rows_live.size)
    live = rows[:count].long()
    qkv = tfe.projection_plain(xt[live].reshape(count * T, H), wqkv.t(), bqkv, cd)
    q, k, v = qkv.reshape(count, T, 3 * H).split(H, dim=-1)
    b3 = tfe._bias3(torch.from_numpy(bias), rows_live.size, T, None)[live]  # the bias at the original rows
    o = tfe.short_attention_plain(q, k, v, b3, None, num_heads=N, seed=SEED, dropout_rate=0.1)
    got = tfe.projection_plain(o.reshape(count * T, H), wo.t(), bo, cd).reshape(count, T, H).numpy()
    first_dead = int(np.argmin(rows_live))
    for r, orig in enumerate(live.tolist()):
        err = np.abs(got[r] - want[orig]).max()
        if orig < first_dead:
            assert err <= 2e-5, (orig, err)
        else:
            assert err > 1e-3, (orig, err)  # other keep bits: whole probabilities dropped or kept


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weight_storage_is_the_parameters_own_storage(dtype):
    """The views the attention layer hands the kernels (``in_proj_weight.t()``,
    its row slices ``[:H].t()`` and ``[H:].t()`` for the cross-attention,
    ``out_proj.weight.t()``) come back from ``weight_storage`` as the
    parameter's own storage: the bf16 kernels read the weights in place."""
    attn = MultiHeadAttention(H, N, dtype, torch.Generator().manual_seed(0)).to(dtype)
    w, wo = attn.in_proj_weight, attn.out_proj.weight
    for view, base in ((w.t(), w), (w[:H].t(), w[:H]), (w[H:].t(), w[H:]), (wo.t(), wo)):
        got = tfe.weight_storage(view, dtype)
        assert got.data_ptr() == base.data_ptr() and tuple(got.shape) == tuple(base.shape)


def test_scratch_views_cover_the_scratch():
    B, T, S = 5, 17, 33
    x = torch.empty(B, T, H, dtype=torch.bfloat16)
    scratch = tfe.proj_scratch(B, T, H, x)
    qkv, o, rows, count = tfe.proj_scratch_views(scratch, B, T, H)
    assert scratch.numel() == B * T * 4 * H * 2 + (B + 1) * 4
    assert qkv.shape == (B * T, 3 * H) and o.shape == (B * T, H) and rows.shape == (B,) and count.shape == (1,)
    scratch = tfe.cross_scratch(B, T, S, H, x)
    q, kv, o = tfe.cross_scratch_views(scratch, B, T, S, H)
    assert q.shape == (B * T, H) and kv.shape == (B * S, 2 * H) and o.shape == (B * T, H)
    assert scratch.numel() == (q.numel() + kv.numel() + o.numel()) * 2
    assert tfe.cross_scratch(B, T, S, H, x.float()).shape == (B * S, 2 * H)
