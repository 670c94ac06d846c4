"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a GPU every test here skips. On a machine with one
(and without JAX, which this file does not import):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances, kernel against plain version on the same inputs with the same
rounding points (the attention kernels of ``ops/flash.py`` take the softmax
online over key chunks, which moves only the rounding): f32 atol = rtol = 1e-4 (sums of up to 4H products taken in
another order, then LayerNorm); bf16 atol 6e-2, rtol 2e-2 (a reordered f32
sum can round to the neighbouring bf16 value, and LayerNorm outputs move a
few bf16 steps with it). Dead rows are exact zeros in both.
"""

import math

import numpy as np
import pytest
import torch

from stlt_tpu_torch.ops import fused_encoder as fe
from stlt_tpu_torch.ops import fused_tail_train as ftt
from stlt_tpu_torch.ops import masks

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4), torch.bfloat16: dict(atol=6e-2, rtol=2e-2)}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _weights(H, gen, device):
    u = lambda *s, b: ((torch.rand(s, generator=gen) * 2 - 1) * b).to(device)
    return {
        "wqkv": u(H, 3 * H, b=math.sqrt(1.5 / H)), "bqkv": u(3 * H, b=0.05),
        "wo": u(H, H, b=1 / math.sqrt(H)), "bo": u(H, b=0.05),
        "n1s": 1 + u(H, b=0.1), "n1b": u(H, b=0.1),
        "w1": u(H, 4 * H, b=1 / math.sqrt(H)), "b1": u(4 * H, b=0.05),
        "w2": u(4 * H, H, b=1 / math.sqrt(4 * H)), "b2": u(H, b=0.05),
        "n2s": 1 + u(H, b=0.1), "n2b": u(H, b=0.1),
    }


def _bias(kind, rows, T, gen):
    if kind == "none":
        return None
    if kind == "key_padding":
        pad = torch.rand(rows, T, generator=gen) < 0.3
        pad[:, 0] = False
        return masks.key_padding_bias(pad)
    lengths = torch.randint(1, T + 1, (rows,), generator=gen)
    pad = torch.arange(T)[None, :] >= lengths[:, None]
    return masks.causal_bias(T) + masks.key_padding_bias(pad)


def _close(got, want, dtype, live=None):
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    if live is not None and (~live).any():
        assert got[~live].abs().max().item() == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,T,bias_kind,ragged", [
    (64, 8, "key_padding", True),
    (128, 17, "causal_padding", False),
    (768, 8, "key_padding", True),
    (768, 17, "causal_padding", True),
    (256, 1, "none", False),
    (512, 32, "causal_padding", True),
    (768, 33, "causal_padding", True),
    (128, 64, "key_padding", True),
])
def test_proj_attention_kernel_matches_plain(device, dtype, H, T, bias_kind, ragged):
    gen = torch.Generator().manual_seed(H + T)
    rows = 37
    w = _weights(H, gen, device)
    x = torch.randn(rows, T, H, generator=gen).to(device, dtype)
    bias = _bias(bias_kind, rows, T, gen)
    bias = None if bias is None else bias.to(device)
    rows_live = (torch.rand(rows, generator=gen) < 0.6).to(device) if ragged else None
    args = (x, w["wqkv"], w["bqkv"], w["wo"], w["bo"], bias)
    kw = dict(num_heads=H // 64, compute_dtype=dtype, rows_live=rows_live)
    before = fe.LAUNCHES["fused_proj_attention"]
    got = fe.fused_proj_attention(*args, **kw)
    assert fe.LAUNCHES["fused_proj_attention"] == before + 1
    want = fe.fused_proj_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    live = None if rows_live is None else rows_live[:, None].expand(rows, T)
    _close(got, want, dtype, live)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,T,live_kind,activation", [
    (64, 8, "rows", "gelu"),
    (128, 17, "tokens", "gelu"),
    (768, 8, "rows", "gelu"),
    (768, 17, "tokens", "gelu"),
    (256, 5, "none", "relu"),
])
def test_layer_tail_kernel_matches_plain(device, dtype, H, T, live_kind, activation):
    gen = torch.Generator().manual_seed(H * T)
    rows = 29
    w = _weights(H, gen, device)
    x = torch.randn(rows, T, H, generator=gen).to(device, dtype)
    a = (0.5 * torch.randn(rows, T, H, generator=gen)).to(device, dtype)
    live_kw, live = {}, None
    if live_kind == "rows":
        rows_live = torch.rand(rows, generator=gen) < 0.6
        live_kw = {"rows_live": rows_live.to(device)}
        live = rows_live[:, None].expand(rows, T).to(device)
    elif live_kind == "tokens":
        live = (torch.rand(rows, T, generator=gen) < 0.6).to(device)
        live_kw = {"tokens_live": live}
    args = (x, a, w["n1s"], w["n1b"], w["w1"], w["b1"], w["w2"], w["b2"], w["n2s"], w["n2b"])
    kw = dict(eps=1e-12, compute_dtype=dtype, activation=activation,
              gelu_approximate=dtype == torch.bfloat16, **live_kw)
    before = fe.LAUNCHES["fused_layer_tail"]
    got = fe.fused_layer_tail(*args, **kw)
    assert fe.LAUNCHES["fused_layer_tail"] == before + 1
    want = fe.fused_layer_tail_plain(*args, **kw)
    torch.cuda.synchronize()
    _close(got, want, dtype, live)


def _rel(got, want):
    """Relative error in the Frobenius norm."""
    return ((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30)).item()


# Summed weight gradients (dWo, dbo, dWqkv, dbqkv, and dx through the
# Wqkv^T product) are held in the relative Frobenius norm: each element is a
# sum over every token, so a reordered f32 sum or a neighbouring bf16 value of
# one dqkv or attention element moves it by its own rounding, not the sum's.
GRAD_REL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,T,bias_kind,ragged,rate", [
    (768, 8, "key_padding", True, 0.1),
    (768, 17, "causal_padding", False, 0.1),
    (768, 33, "causal_padding", False, 0.1),
    (128, 8, "key_padding", True, 0.0),
    (64, 64, "causal_padding", True, 0.25),
    (256, 5, "none", False, 0.1),
])
def test_train_kernels_match_plain(device, dtype, H, T, bias_kind, ragged, rate):
    gen = torch.Generator().manual_seed(H + 3 * T)
    rows = 29
    N = H // 64
    w = _weights(H, gen, device)
    x = torch.randn(rows, T, H, generator=gen).to(device, dtype)
    g = torch.randn(rows, T, H, generator=gen).to(device, dtype)
    bias = _bias(bias_kind, rows, T, gen)
    bias = None if bias is None else bias.to(device)
    rows_live = (torch.rand(rows, generator=gen) < 0.6).to(device) if ragged else None
    live = None if rows_live is None else rows_live[:, None].expand(rows, T)
    seed = 987654321
    kw = dict(num_heads=N, dropout_rate=rate, compute_dtype=dtype, rows_live=rows_live)

    fwd = (x, w["wqkv"], w["bqkv"], w["wo"], w["bo"], bias, seed)
    fe.reset_launches()
    got = fe._ProjAttentionTrain.apply(x, w["wqkv"], w["bqkv"], w["wo"], w["bo"], bias,
                                       rows_live, seed, N, rate, dtype)
    assert fe.LAUNCHES["fused_proj_attention_train"] == 1
    _close(got, fe.fused_proj_attention_train_plain(*fwd, **kw), dtype, live)

    bwd = (x, w["wqkv"], w["bqkv"], w["wo"], bias, g, seed)
    dqkv, dwo, dbo = fe._launch_proj_bwd(*bwd, **kw)
    assert fe.LAUNCHES["fused_proj_attention_train_bwd"] == 1
    want = fe.fused_proj_attention_train_bwd_plain(*bwd, **kw)
    torch.cuda.synchronize()
    _close(dqkv, want[0], dtype, live)
    assert _rel(dwo, want[1]) < GRAD_REL[dtype] and _rel(dbo, want[2]) < GRAD_REL[dtype]
    again = fe._launch_proj_bwd(*bwd, **kw)
    assert all(torch.equal(a, b) for a, b in zip(again, (dqkv, dwo, dbo))), "not deterministic"

    leaves = [t.clone().requires_grad_() for t in (x, w["wqkv"], w["bqkv"], w["wo"], w["bo"])]
    fe.fused_proj_attention_train(*leaves, bias, seed, **kw).backward(g)
    plain = (*fe.proj_input_grads(x, w["wqkv"], want[0], dtype), want[1], want[2])
    for name, a, b in zip(("dx", "dwqkv", "dbqkv", "dwo", "dbo"), [t.grad for t in leaves], plain):
        assert _rel(a, b) < GRAD_REL[dtype], name
        if live is not None and name == "dx":
            assert a[~live].abs().max().item() == 0.0


def test_kernels_refuse_what_they_do_not_take(device):
    gen = torch.Generator().manual_seed(0)
    w = _weights(64, gen, device)
    x = torch.randn(2, 65, 64, device=device)
    proj = (w["wqkv"], w["bqkv"], w["wo"], w["bo"], None)
    with pytest.raises(ValueError, match="T <= 64"):
        fe.fused_proj_attention(x, *proj, num_heads=1, compute_dtype=torch.float32)
    with pytest.raises(TypeError, match="compute dtype"):
        fe.fused_proj_attention(x[:, :8].bfloat16(), *proj, num_heads=1, compute_dtype=torch.float32)
    ctx = torch.randn(2, 17, 32, device=device)
    cross = (torch.randn(32, 32, device=device), torch.zeros(32, device=device),
             torch.randn(32, 64, device=device), torch.zeros(64, device=device),
             torch.randn(32, 32, device=device), torch.zeros(32, device=device), None)
    with pytest.raises(ValueError, match="H in 64"):
        fe.fused_cross_attention(ctx[:, :8], ctx, *cross, num_heads=4, compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="T, S <= 64"):
        fe.fused_cross_attention(x, torch.randn(2, 8, 64, device=device), w["wqkv"][:, :64],
                                 w["bqkv"][:64], w["wqkv"][:, 64:], w["bqkv"][64:], w["wo"],
                                 w["bo"], None, num_heads=1, compute_dtype=torch.float32)
    w96 = _weights(96, gen, device)
    with pytest.raises(ValueError, match="H in 64"):
        fe.fused_layer_tail(
            torch.randn(2, 8, 96, device=device), torch.randn(2, 8, 96, device=device),
            *(w96[k] for k in ("n1s", "n1b", "w1", "b1", "w2", "b2", "n2s", "n2b")),
            eps=1e-12, compute_dtype=torch.float32,
        )


def test_model_on_the_card_matches_the_plain_model(device):
    from stlt_tpu_torch.configs import StltModelConfig
    from stlt_tpu_torch.models import models_factory

    cfg = StltModelConfig(num_classes=7, unique_categories=4, hidden_size=128,
                          num_attention_heads=2, num_spatial_layers=2, num_temporal_layers=2,
                          layout_num_frames=32)
    model = models_factory["stlt"](cfg, torch.Generator().manual_seed(1)).eval()
    gen = torch.Generator().manual_seed(2)
    B, F, O = 6, 17, 8
    lengths = torch.randint(3, F + 1, (B,), generator=gen)
    pad = torch.arange(F)[None, :] >= lengths[:, None]
    frame_types = torch.where(pad, 0, 2)
    frame_types[torch.arange(B), lengths - 1] = 4
    categories = torch.randint(1, 3, (B, F, O), generator=gen)
    categories[:, :, 0] = 3
    categories[pad] = torch.tensor([3] + [0] * (O - 1))
    batch = {"categories": categories, "boxes": torch.rand(B, F, O, 4, generator=gen),
             "frame_types": frame_types, "lengths": lengths}
    with torch.inference_mode():
        want = model(batch)["stlt"]
        fe.reset_launches()
        got = model.to(device)({k: v.to(device) for k, v in batch.items()})["stlt"]
    assert fe.LAUNCHES == {"fused_proj_attention": 4, "fused_layer_tail": 4,
                           "fused_proj_attention_train": 0, "fused_proj_attention_train_bwd": 0,
                           "fused_cross_attention": 0}
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


def test_train_step_on_the_card_matches_the_plain_step(device, monkeypatch):
    """One f32 train step with dropout through the train kernels, against the
    same step with the op's plain forward and backward on the card (same
    weights, batch and generator): loss at 1e-5, every gradient within a
    relative norm of 1e-4 (f32 sums in another order, through two layers)."""
    from stlt_tpu_torch.configs import StltModelConfig
    from stlt_tpu_torch.models import models_factory
    from stlt_tpu_torch.training.criterion import make_criterion
    from stlt_tpu_torch.training.loop import step_generator

    cfg = StltModelConfig(num_classes=7, unique_categories=4, hidden_size=128,
                          num_attention_heads=2, num_spatial_layers=1, num_temporal_layers=1,
                          layout_num_frames=32, hidden_dropout_prob=0.1)
    model = models_factory["stlt"](cfg, torch.Generator().manual_seed(4)).to(device).train()
    gen = torch.Generator().manual_seed(5)
    B, F, O = 6, 17, 8
    lengths = torch.randint(3, F + 1, (B,), generator=gen)
    pad = torch.arange(F)[None, :] >= lengths[:, None]
    frame_types = torch.where(pad, 0, 2)
    frame_types[torch.arange(B), lengths - 1] = 4
    categories = torch.randint(1, 3, (B, F, O), generator=gen)
    categories[:, :, 0] = 3
    categories[pad] = torch.tensor([3] + [0] * (O - 1))
    batch = {"categories": categories, "boxes": torch.rand(B, F, O, 4, generator=gen),
             "frame_types": frame_types, "lengths": lengths}
    batch = {k: v.to(device) for k, v in batch.items()}
    labels = torch.randint(0, 7, (B,), generator=gen).to(device)
    criterion = make_criterion("something")

    def step():
        model.zero_grad(set_to_none=True)
        loss = criterion(model(batch, step_generator(0, 0)), labels)
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()
                             if p.grad is not None}

    fe.reset_launches()
    loss, grads = step()
    assert fe.LAUNCHES["fused_proj_attention_train"] == 2
    assert fe.LAUNCHES["fused_proj_attention_train_bwd"] == 2
    monkeypatch.setattr(fe, "_launch_proj", lambda op, x, wqkv, bqkv, wo, bo, bias, *, seed=None,
                        dropout_rate=0.0, **kw: fe.fused_proj_attention_train_plain(
                            x, wqkv, bqkv, wo, bo, bias, seed, dropout_rate=dropout_rate, **kw))
    monkeypatch.setattr(fe, "_launch_proj_bwd", fe.fused_proj_attention_train_bwd_plain)
    plain_loss, plain_grads = step()
    assert abs(loss - plain_loss) < 1e-5
    assert set(grads) == set(plain_grads)
    for name, g in grads.items():
        assert _rel(g, plain_grads[name]) < 1e-4, name


# --- the long-clip attention kernels (ops/flash.py) ------------------------------


def _heads(B, T, S, dtype, gen, device, strided=False):
    """q [B, T, 12, 64] and k, v [B, S, 12, 64]; strided: the q/k/v thirds
    of one [B, T, 3H] projection, as the model passes them."""
    N, D = 12, 64
    if strided:
        assert T == S
        qkv = torch.randn(B, T, 3 * N * D, generator=gen).to(device, dtype)
        return tuple(qkv[..., i * N * D:(i + 1) * N * D].unflatten(-1, (N, D)) for i in range(3))
    return tuple(torch.randn(B, L, N, D, generator=gen).to(device, dtype) for L in (T, S, S))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,strided", [(65, False), (257, True), (512, False)])
def test_flash_kernel_matches_plain(device, dtype, T, strided):
    from stlt_tpu_torch.ops import flash

    gen = torch.Generator().manual_seed(T)
    B = 5
    q, k, v = _heads(B, T, T, dtype, gen, device, strided)
    bias = _bias("causal_padding", B, T, gen).to(device)
    flash.reset_launches()
    got = flash.fused_attention(q, k, v, bias)
    assert flash.LAUNCHES == {"flash_attention": 1, "blockwise_attention": 0,
                              "blockwise_attention_dense": 0,
                              "flash_attention_bwd": 0, "blockwise_attention_bwd": 0,
                              "blockwise_attention_bwd_dense": 0}
    want = flash.fused_attention_plain(q, k, v, bias)
    torch.cuda.synchronize()
    _close(got, want, dtype)
    assert got.is_contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,causal", [(513, True), (1025, True), (513, False)])
def test_blockwise_kernel_matches_plain(device, dtype, T, causal):
    from stlt_tpu_torch.ops import flash

    gen = torch.Generator().manual_seed(T + causal)
    B = 5
    q, k, v = _heads(B, T, T, dtype, gen, device, strided=True)
    lengths = torch.tensor([1, T, 64, 65, T // 2 + 3], dtype=torch.int32)
    flash.reset_launches()
    out, lse = flash.blockwise_attention(q, k, v, kv_lengths=lengths.to(device), causal=causal)
    assert flash.LAUNCHES == {"flash_attention": 0, "blockwise_attention": 1,
                              "blockwise_attention_dense": 0,
                              "flash_attention_bwd": 0, "blockwise_attention_bwd": 0,
                              "blockwise_attention_bwd_dense": 0}
    want, want_lse = flash.blockwise_attention_plain(q, k, v, kv_lengths=lengths.to(device), causal=causal)
    torch.cuda.synchronize()
    live = (torch.arange(T)[None, :] < lengths[:, None]).to(device)  # [B, T]
    _close(out, want, dtype, live[:, :, None, None].expand(out.shape))
    torch.testing.assert_close(lse.transpose(1, 2)[live], want_lse.transpose(1, 2)[live],
                               **TOL[torch.float32])
    assert lse.transpose(1, 2)[~live].abs().max().item() == 0.0


def test_long_clip_kernels_refuse_what_they_do_not_take(device):
    from stlt_tpu_torch.ops import flash

    gen = torch.Generator().manual_seed(0)
    q, k, v = _heads(2, 513, 513, torch.bfloat16, gen, device)
    lengths = torch.tensor([3, 513], device=device)
    # The dense-bias forward and backward run (their kernels are held
    # against their plain versions in test_blockwise_dense_bias_kernel_matches_plain
    # and test_blockwise_dense_bias_bwd_kernel_matches_plain).
    flash.reset_launches()
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = flash.flash_attention(*leaves, bias=torch.zeros(2, 1, 513, 513, device=device))
    out.float().sum().backward()
    assert torch.isfinite(out.float()).all() and flash.LAUNCHES["blockwise_attention_dense"] == 1
    assert flash.LAUNCHES["blockwise_attention_bwd_dense"] == 1
    assert all(torch.isfinite(x.grad.float()).all() for x in leaves)
    mask = torch.ones(2, 12, 100, 100, device=device)
    with pytest.raises(NotImplementedError, match="dropout-mask operand"):
        flash.flash_attention(q[:, :100], k[:, :100], v[:, :100], dropout_mask=mask, dropout_rate=0.1)
    lse = dsum = torch.zeros(2, 12, 513, device=device)
    with pytest.raises(NotImplementedError, match="dropout-mask operand"):
        flash.blockwise_attention_bwd(q, k, v, q, lse, dsum, bias=torch.zeros(2, 1, 513, 513, device=device),
                                      dropout_mask=torch.ones(2, 12, 513, 513, device=device),
                                      dropout_rate=0.1)
    with pytest.raises(NotImplementedError, match="ROADMAP.md item A9"):
        flash.blockwise_attention_bwd(q, k, v, q, lse, dsum, kv_lengths=lengths, causal=True,
                                      offsets=torch.tensor([0, 0]))
    q32 = torch.randn(2, 100, 4, 32, device=device)
    with pytest.raises(ValueError, match="head dim 64"):
        flash.flash_attention(q32, q32, q32)
    with pytest.raises(ValueError, match="head dim 64"):
        flash.flash_attention(*(torch.randn(2, 600, 4, 32, device=device) for _ in range(3)),
                              kv_lengths=lengths, causal=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,rate", [(65, 0.1), (257, 0.5), (512, 0.1)])
def test_flash_kernel_with_dropout_and_lse_matches_plain(device, dtype, T, rate):
    """The short kernel's dropout variant keeps the plain version's bits (in
    f32 the outputs agree to 1e-5, which one flipped bit would break) and
    writes the plain lse."""
    from stlt_tpu_torch.ops import flash

    gen = torch.Generator().manual_seed(T + 7)
    B = 5
    q, k, v = _heads(B, T, T, dtype, gen, device, strided=True)
    bias = _bias("causal_padding", B, T, gen).to(device)
    kw = dict(dropout_rate=rate, dropout_seed=0xDEADBEEF)
    got, lse = flash.fused_attention(q, k, v, bias, with_lse=True, **kw)
    want, want_lse = flash.fused_attention_plain(q, k, v, bias, with_lse=True, **kw)
    torch.cuda.synchronize()
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), **tol)
    torch.testing.assert_close(lse, want_lse, **TOL[torch.float32])
    assert not torch.allclose(got.float(), flash.fused_attention_plain(q, k, v, bias).float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,rate", [(513, 0.1), (1025, 0.5)])
def test_blockwise_kernel_with_dropout_matches_plain(device, dtype, T, rate):
    from stlt_tpu_torch.ops import flash

    gen = torch.Generator().manual_seed(T + 11)
    B = 5
    q, k, v = _heads(B, T, T, dtype, gen, device, strided=True)
    lengths = torch.tensor([1, T, 64, 65, T // 2 + 3], dtype=torch.int32, device=device)
    kw = dict(kv_lengths=lengths, causal=True, dropout_rate=rate, dropout_seed=12345)
    out, lse = flash.blockwise_attention(q, k, v, **kw)
    want, want_lse = flash.blockwise_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    live = (torch.arange(T, device=device)[None, :] < lengths[:, None])
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), **tol)
    torch.testing.assert_close(lse.transpose(1, 2)[live], want_lse.transpose(1, 2)[live],
                               **TOL[torch.float32])
    assert out[~live].abs().max().item() == 0.0


def _bwd_case(B, T, dtype, gen, device, lengths=None, rate=0.0):
    """q, k, v (strided thirds), a cotangent, and the plain forward's out,
    lse and dsum; in lengths mode the cotangent is 1e30 on dead rows."""
    from stlt_tpu_torch.ops import flash

    q, k, v = _heads(B, T, T, dtype, gen, device, strided=True)
    dout = torch.randn(B, T, 12, 64, generator=gen).to(device, dtype)
    drop = dict(dropout_rate=rate, dropout_seed=0x5EED if rate else None)
    if lengths is None:
        bias = _bias("causal_padding", B, T, gen).to(device)
        out, lse = flash.fused_attention_plain(q, k, v, bias, with_lse=True, **drop)
        return q, k, v, dout, lse, flash._dsum(dout, out, None), dict(bias=bias, **drop)
    live = torch.arange(T, device=device)[None, :] < lengths[:, None]
    dout[~live] = 1e30
    kw = dict(kv_lengths=lengths, causal=True, **drop)
    out, lse = flash.blockwise_attention_plain(q, k, v, **kw)
    return q, k, v, dout, lse, flash._dsum(dout, out, lengths), kw


# The long-clip backwards' dq, dk and dv in the relative norm: sound kernels
# read at most 2.2e-4 in bf16 (H100); a tensor-core product of p or dz
# without the hi + lo split reads 2.5e-3 to 2.7e-3
# (``python -m stlt_tpu_torch.utils.bwd_tolerance``; PERF.md, PR 4), and the
# elementwise bf16 bound is about as large as a dk or dv element.
BWD_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}


def _check_grads(got, want, dtype, dead=None):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.is_contiguous() and torch.isfinite(a).all(), name
        assert _rel(a, b) < BWD_REL[dtype], (name, _rel(a, b))
        torch.testing.assert_close(a.float(), b.float(), **TOL[dtype], msg=name)
    if dead is not None and dead.any():
        assert got[0][dead].abs().max().item() == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,rate", [(65, 0.0), (257, 0.1), (512, 0.1)])
def test_flash_bwd_kernel_matches_plain(device, dtype, T, rate):
    from stlt_tpu_torch.ops import flash

    gen = torch.Generator().manual_seed(T + 13)
    q, k, v, dout, lse, dsum, kw = _bwd_case(5, T, dtype, gen, device, rate=rate)
    flash.reset_launches()
    got = flash.fused_attention_bwd(q, k, v, dout, lse, dsum, **kw)
    assert flash.LAUNCHES["flash_attention_bwd"] == 1
    want = flash.attention_bwd_plain(q, k, v, dout, lse, dsum, **kw)
    again = flash.fused_attention_bwd(q, k, v, dout, lse, dsum, **kw)
    torch.cuda.synchronize()
    _check_grads(got, want, dtype)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), "not deterministic"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,rate", [(513, 0.0), (513, 0.1), (1025, 0.1)])
def test_blockwise_bwd_kernel_matches_plain(device, dtype, T, rate):
    """Full and ragged lengths (1 and T among them), causal, a cotangent of
    1e30 on dead rows: finite gradients, dead rows' dq exact zeros, equal to
    the plain version and the same bits twice."""
    from stlt_tpu_torch.ops import flash

    gen = torch.Generator().manual_seed(T + 17)
    lengths = torch.tensor([1, T, 64, 65, T // 2 + 3], dtype=torch.int32, device=device)
    q, k, v, dout, lse, dsum, kw = _bwd_case(5, T, dtype, gen, device, lengths, rate)
    flash.reset_launches()
    got = flash.blockwise_attention_bwd(q, k, v, dout, lse, dsum, **kw)
    assert flash.LAUNCHES["blockwise_attention_bwd"] == 1
    want = flash.attention_bwd_plain(q, k, v, dout, lse, dsum, **kw)
    again = flash.blockwise_attention_bwd(q, k, v, dout, lse, dsum, **kw)
    torch.cuda.synchronize()
    dead = ~(torch.arange(T, device=device)[None, :] < lengths[:, None])
    _check_grads(got, want, dtype, dead)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), "not deterministic"


@pytest.mark.parametrize("T", [257, 513])
def test_flash_attention_gradients_on_the_card_match_the_cpu(device, T):
    """The autograd Functions end to end, f32 with dropout: forward and
    gradients on the card against the same Functions on the CPU (plain
    forward and backward), which the CPU tests hold against JAX."""
    from stlt_tpu_torch.ops import flash

    gen = torch.Generator().manual_seed(T)
    B, N, D = 3, 2, 64
    q, k, v, g = (torch.randn(B, T, N, D, generator=gen) for _ in range(4))
    lengths = torch.tensor([T, 40, 200], dtype=torch.int32)
    kw = dict(causal=True, kv_lengths=lengths, dropout_rate=0.1, dropout_seed=99)
    results = []
    for dev in ("cpu", device):
        leaves = [t.detach().clone().to(dev).requires_grad_() for t in (q, k, v)]
        flash.reset_launches()
        out = flash.flash_attention(*leaves, **{**kw, "kv_lengths": lengths.to(dev)})
        out.backward(g.to(dev))
        results.append([out.detach().cpu()] + [t.grad.cpu() for t in leaves])
    name = "blockwise_attention" if T >= 513 else "flash_attention"
    assert flash.LAUNCHES[name] == 1 and flash.LAUNCHES[name + "_bwd"] == 1
    live = torch.arange(T)[None, :] < lengths[:, None]
    for a, b in zip(results[0], results[1]):
        torch.testing.assert_close(b[live], a[live], atol=1e-4, rtol=1e-4)


def test_long_clip_train_layer_runs_the_kernels_on_the_card(device):
    """Train mode above 64 tokens: the attention's forward and backward
    launch the long-clip kernels (and nothing else of ops/flash.py)."""
    from stlt_tpu_torch.models.layers import MultiHeadAttention
    from stlt_tpu_torch.ops import flash

    mha = MultiHeadAttention(128, 2, torch.float32, torch.Generator().manual_seed(0),
                             dropout_rate=0.1).to(device)
    x = torch.randn(2, 70, 128, device=device, requires_grad=True)
    flash.reset_launches()
    mha.train()(x, seed=3).sum().backward()
    assert flash.LAUNCHES == {"flash_attention": 1, "blockwise_attention": 0,
                              "blockwise_attention_dense": 0,
                              "flash_attention_bwd": 1, "blockwise_attention_bwd": 0,
                              "blockwise_attention_bwd_dense": 0}
    assert torch.isfinite(x.grad).all()


def test_predict_at_257_frames_runs_the_flash_kernel(device, tmp_path):
    """A full-width-shaped STLT (H = 768, 12 heads, 1 + 2 layers) served
    through predict at --layout_num_frames 256: every temporal layer's
    attention launches the short flash kernel."""
    import json

    from stlt_tpu_torch import predict
    from stlt_tpu_torch.configs import DataConfig, make_model_config, position_table_rows
    from stlt_tpu_torch.models import models_factory
    from stlt_tpu_torch.ops import flash

    rng = np.random.default_rng(0)
    labels = {f"Doing thing {i}": str(i) for i in range(4)}
    frame = {"frame_objects": [{"category": "hand", "x1": 10.0, "y1": 20.0, "x2": 90.0,
                                "y2": 80.0, "score": 0.9}]}
    videos = [{"id": str(v), "template": f"Doing thing {v % 4}",
               "frames": [frame] * int(rng.integers(200, 300))} for v in range(6)]
    paths = {}
    for name, obj in (("dataset_path", videos), ("labels_path", labels),
                      ("videoid2size_path", {str(v): [320, 240] for v in range(6)})):
        paths[name] = str(tmp_path / f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(obj, f)
    data_cfg = DataConfig(dataset_name="something", layout_num_frames=256, **paths)
    model = models_factory["stlt"](make_model_config(
        "stlt", num_classes=4, unique_categories=4, hidden_size=768, num_attention_heads=12,
        num_spatial_layers=1, num_temporal_layers=2, compute_dtype="bfloat16",
        layout_num_frames=position_table_rows(data_cfg)))
    checkpoint = str(tmp_path / "random.pt")
    torch.save(model.state_dict(), checkpoint)
    out = str(tmp_path / "predictions.jsonl")
    flash.reset_launches()
    fe.reset_launches()
    rows = predict.main([
        "--dataset_name", "something", "--dataset_type", "layout", "--model_name", "stlt",
        "--test_dataset_path", paths["dataset_path"], "--labels_path", paths["labels_path"],
        "--videoid2size_path", paths["videoid2size_path"], "--checkpoint_path", checkpoint,
        "--layout_num_frames", "256", "--batch_size", "4", "--num_spatial_layers", "1",
        "--num_temporal_layers", "2", "--compute_dtype", "bfloat16", "--output", out, "--top_k", "3",
    ])
    assert len(rows) == 6 and all(len(json.loads(line)["top_k"]) == 3 for line in open(out))
    assert flash.LAUNCHES == {"flash_attention": 2 * 2, "blockwise_attention": 0,
                              "blockwise_attention_dense": 0,
                              "flash_attention_bwd": 0, "blockwise_attention_bwd": 0,
                              "blockwise_attention_bwd_dense": 0}
    assert fe.LAUNCHES["fused_proj_attention"] == 1 * 2 and fe.LAUNCHES["fused_layer_tail"] == 3 * 2


def test_train_at_257_frames_runs_the_long_clip_kernels(device, tmp_path):
    """train --layout_num_frames 256 on the card (H = 128, 2 heads of 64, 1 + 2
    layers, dropout 0.1): every temporal layer's attention runs the short
    flash kernel forward and its backward kernel in each step, finite
    losses."""
    import json

    from stlt_tpu_torch import train as port_train
    from stlt_tpu_torch.ops import flash

    rng = np.random.default_rng(1)
    labels = {f"Doing thing {i}": str(i) for i in range(4)}
    frame = {"frame_objects": [{"category": "hand", "x1": 10.0, "y1": 20.0, "x2": 90.0,
                                "y2": 80.0, "score": 0.9}]}
    videos = [{"id": str(v), "template": f"Doing thing {v % 4}",
               "frames": [frame] * int(rng.integers(100, 300))} for v in range(8)]
    paths = {}
    for name, obj in (("dataset_path", videos), ("labels_path", labels),
                      ("videoid2size_path", {str(v): [320, 240] for v in range(8)})):
        paths[name] = str(tmp_path / f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(obj, f)
    flash.reset_launches()
    fe.reset_launches()
    result = port_train.main([
        "--dataset_name", "something", "--dataset_type", "layout", "--model_name", "stlt",
        "--train_dataset_path", paths["dataset_path"], "--val_dataset_path", paths["dataset_path"],
        "--labels_path", paths["labels_path"], "--videoid2size_path", paths["videoid2size_path"],
        "--layout_num_frames", "256", "--batch_size", "4", "--hidden_size", "128",
        "--num_attention_heads", "2", "--num_spatial_layers", "1", "--num_temporal_layers", "2",
        "--hidden_dropout_prob", "0.1", "--epochs", "1", "--compute_dtype", "bfloat16",
        "--use_pallas", "--save_model_path", str(tmp_path / "best.pt"),
    ])
    steps, val = 2, 2
    assert result.step == steps and all(np.isfinite(r["train_loss"]) for r in result.epochs)
    assert flash.LAUNCHES == {"flash_attention": 2 * (steps + val), "blockwise_attention": 0,
                              "blockwise_attention_dense": 0,
                              "flash_attention_bwd": 2 * steps, "blockwise_attention_bwd": 0,
                              "blockwise_attention_bwd_dense": 0}
    assert fe.LAUNCHES == {"fused_proj_attention": val, "fused_layer_tail": 3 * val,
                           "fused_proj_attention_train": steps, "fused_proj_attention_train_bwd": steps,
                           "fused_cross_attention": 0}
    # Every train tail of the 257-frame model (1 spatial + 2 temporal layers)
    # runs the fused train tail's four kernels.
    assert ftt.LAUNCHES == dict.fromkeys(ftt.LAUNCHES, 3 * steps)


# --- the fused train tail (ops/fused_tail_train.py) -------------------------------

# dx and dattn of the train tail's backward in bf16, relative Frobenius norm:
# sound kernels read 8.7e-5, act' taken on the bf16-rounded z1 1.1e-3 and a
# dropped keep2 in the input kernel 7.0e-2. dr2 and the summed gradients:
# sound kernels read at most 9e-5; the weight kernel's split partials rounded
# to bf16 1.7e-3, its last split left out 6.0e-2 (H100; PERF.md, python -m
# stlt_tpu_torch.utils.bwd_tolerance tail).
TAIL_BWD_REL = {torch.float32: 1e-5, torch.bfloat16: 5e-4}
TAIL_SUM_REL = {torch.float32: 1e-5, torch.bfloat16: 5e-4}


def _tail_case(H, tokens, live_kind, gen, device, dtype):
    w = _weights(H, gen, device)
    weights = [w[k] for k in ("n1s", "n1b", "w1", "b1", "w2", "b2", "n2s", "n2b")]
    x = torch.randn(tokens, H, generator=gen).to(device, dtype)
    a = (0.5 * torch.randn(tokens, H, generator=gen)).to(device, dtype)
    g = torch.randn(tokens, H, generator=gen)
    live = None
    if live_kind == "tokens":
        live = torch.rand(tokens, generator=gen) < 0.7
        live[:40] = False  # a whole dead block
        g[~live] = 1e30  # a dead token's cotangent is never read
        live = live.to(device)
    return x, a, g.to(device, dtype), weights, live


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,tokens,rate,activation,live_kind", [
    (64, 203, 0.1, "gelu", "tokens"),
    (128, 96, 0.0, "relu", "none"),
    (768, 1000, 0.1, "gelu", "tokens"),
    (768, 300, 0.0, "gelu", "none"),
    (768, 17000, 0.1, "gelu", "tokens"),  # 264 row blocks, 5 splits of the weight products
])
def test_tail_train_kernels_match_plain(device, dtype, H, tokens, rate, activation, live_kind):
    """The four kernels of the fused train tail against their plain versions
    on the same inputs: y and r2 elementwise (OP tolerance), dr2 and the
    summed gradients in relative norm (TAIL_SUM_REL), dx and dattn in
    relative norm (TAIL_BWD_REL); dead tokens exact zeros under a 1e30
    cotangent, no NaN, and a second launch bit-identical."""
    gen = torch.Generator().manual_seed(H + tokens)
    x, a, g, weights, live = _tail_case(H, tokens, live_kind, gen, device, dtype)
    cfg = ftt.TailConfig(1e-12, activation, dtype == torch.bfloat16, rate, 0x5EED if rate else None)
    ftt.reset_launches()
    y, r2 = ftt._launch_tail_train(x, a, weights, cfg, live)
    want_y, want_r2 = ftt.fused_layer_tail_train_plain(x, a, weights, cfg, live)
    torch.cuda.synchronize()
    tok_live = None if live is None else live[:, None].expand(tokens, H)
    _close(y, want_y, dtype, tok_live)
    _close(r2, want_r2, dtype, tok_live)

    run = lambda: ftt._launch_tail_train_bwd(x, a, want_r2, g, weights, cfg, live)
    got, again = run(), run()
    dr2, *_ = ftt._launch_bwd_row(want_r2, g, weights[6], cfg, live)
    want_row = ftt.tail_train_bwd_row_plain(want_r2, g, weights[6], cfg, live)
    dn2s, dn2b, db2 = want_row[1:]
    want = (*ftt.tail_train_bwd_input_plain(x, a, want_row[0], weights, cfg, live),
            *ftt.tail_train_bwd_weight_plain(x, a, want_row[0], weights, cfg), db2, dn2s, dn2b)
    torch.cuda.synchronize()
    assert ftt.LAUNCHES == {"fused_layer_tail_train": 1, "fused_tail_train_bwd_row": 3,
                            "fused_tail_train_bwd_input": 2, "fused_tail_train_bwd_weight": 2}
    assert all(torch.equal(p, q) for p, q in zip(got, again))
    assert _rel(dr2, want_row[0]) < TAIL_SUM_REL[dtype]
    names = ("dx", "dattn", "dn1s", "dn1b", "dw1", "db1", "dw2", "db2", "dn2s", "dn2b")
    for name, p, q in zip(names, got, want):
        assert p.shape == q.shape and p.dtype == q.dtype and torch.isfinite(p).all(), name
        limit = TAIL_BWD_REL[dtype] if name in ("dx", "dattn") else TAIL_SUM_REL[dtype]
        assert _rel(p, q) < limit, (name, _rel(p, q))
        if name in ("dx", "dattn") and live is not None:
            assert p[~live].abs().max().item() == 0.0, name


def test_tail_train_kernels_refuse_what_they_do_not_take(device):
    gen = torch.Generator().manual_seed(0)
    x, a, g, weights, _ = _tail_case(64, 32, "none", gen, device, torch.float32)
    cfg = ftt.TailConfig(1e-12)
    with pytest.raises(TypeError, match="compute dtype"):
        ftt._launch_tail_train(x, a.bfloat16(), weights, cfg)
    w96 = _weights(96, gen, device)
    with pytest.raises(ValueError, match="H in 64"):
        ftt._launch_bwd_row(torch.randn(8, 96, device=device), torch.randn(8, 96, device=device),
                            w96["n2s"], cfg)


# --- the fusion models' kernels: row 5 and row 8's dense-bias mode --------------

# Their bf16 outputs in the relative norm, as chip_smoke.py holds them: the
# elementwise bf16 bound is about as large as a typical cross-attention
# output, so it cannot see a dropped bias; the limits sit between the sound
# kernels' readings and planted faults' (``python -m
# stlt_tpu_torch.utils.bwd_tolerance cross dense``; PERF.md, PR 6).
CROSS_REL, DENSE_REL = 1.2e-3, 5e-4
# dq, dk, dv of the blockwise backward's dense-bias mode in bf16, relative
# Frobenius norm: sound kernels read at most 1.3e-4, no hi + lo split
# 2.5e-3, the causal key range one key short 6.1e-3, dsum left out 0.14
# (H100; PERF.md §6; python -m stlt_tpu_torch.utils.bwd_tolerance
# dense_bwd).
DENSE_BWD_REL = 1e-3


def _cross_weights(H, gen, device):
    u = lambda *s, b: ((torch.rand(s, generator=gen) * 2 - 1) * b).to(device)
    return (u(H, H, b=math.sqrt(1.5 / H)), u(H, b=0.05), u(H, 2 * H, b=math.sqrt(1.5 / H)),
            u(2 * H, b=0.05), u(H, H, b=1 / math.sqrt(H)), u(H, b=0.05))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,T,S,bias_kind", [
    (768, 17, 33, "none"),
    (768, 33, 17, "key_padding"),
    (768, 8, 64, "key_padding"),
    (768, 64, 8, "none"),
    (64, 1, 1, "none"),
    (128, 5, 40, "masked_row"),
    (1024, 64, 64, "key_padding"),
])
def test_cross_attention_kernel_matches_plain(device, dtype, H, T, S, bias_kind):
    gen = torch.Generator().manual_seed(H + T * S)
    rows = 37
    w = _cross_weights(H, gen, device)
    x = torch.randn(rows, T, H, generator=gen).to(device, dtype)
    ctx = torch.randn(rows, S, H, generator=gen).to(device, dtype)
    bias = None
    if bias_kind != "none":
        pad = torch.rand(rows, S, generator=gen) < 0.3
        pad[:, 0] = False
        if bias_kind == "masked_row":
            pad[0] = True  # every key of row 0 masked: a finite, uniform softmax
        bias = masks.key_padding_bias(pad).to(device)  # [rows, 1, 1, S]
    kw = dict(num_heads=H // 64, compute_dtype=dtype)
    before = fe.LAUNCHES["fused_cross_attention"]
    got = fe.fused_cross_attention(x, ctx, *w, bias, **kw)
    assert fe.LAUNCHES["fused_cross_attention"] == before + 1
    want = fe.fused_cross_attention_plain(x, ctx, *w, bias, **kw)
    torch.cuda.synchronize()
    _close(got, want, dtype)
    assert torch.isfinite(got.float()).all()
    if dtype == torch.bfloat16:
        assert _rel(got, want) < CROSS_REL, _rel(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,S,bias_kind,causal", [
    (513, 513, "causal_padding", True),
    (513, 513, "causal_padding", False),
    (513, 33, "none", False),
    (33, 513, "key_padding", False),
    (1025, 700, "heads", False),
])
def test_blockwise_dense_bias_kernel_matches_plain(device, dtype, T, S, bias_kind, causal):
    from stlt_tpu_torch.ops import flash

    gen = torch.Generator().manual_seed(T + S + causal)
    B = 3
    q, k, v = _heads(B, T, S, dtype, gen, device, strided=T == S)
    if bias_kind == "causal_padding":
        bias = _bias("causal_padding", B, T, gen).to(device)  # [B, 1, T, T]
    elif bias_kind == "key_padding":
        pad = torch.rand(B, S, generator=gen) < 0.3
        pad[:, 0] = False
        bias = masks.key_padding_bias(pad).to(device)  # [B, 1, 1, S]
    elif bias_kind == "heads":
        bias = torch.randn(1, 12, T, S, generator=gen).to(device)
    else:
        bias = None
    flash.reset_launches()
    out, lse = flash.blockwise_attention(q, k, v, bias=bias, causal=causal)
    assert flash.LAUNCHES["blockwise_attention_dense"] == 1 and flash.LAUNCHES["blockwise_attention"] == 0
    want, want_lse = flash.blockwise_attention_plain(q, k, v, bias=bias, causal=causal)
    torch.cuda.synchronize()
    _close(out, want, dtype)
    if dtype == torch.bfloat16:
        assert _rel(out, want) < DENSE_REL, _rel(out, want)
    torch.testing.assert_close(lse, want_lse, **TOL[torch.float32])


def _dense_bias(kind, B, T, S, gen, device):
    if kind == "causal_padding":
        return _bias("causal_padding", B, T, gen).to(device)  # [B, 1, T, T]
    if kind == "key_padding":
        pad = torch.rand(B, S, generator=gen) < 0.3
        pad[:, 0] = False
        return masks.key_padding_bias(pad).to(device)  # [B, 1, 1, S]
    if kind == "heads":
        return torch.randn(1, 12, T, S, generator=gen).to(device)
    return None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,S,bias_kind,causal,rate", [
    (513, 513, "causal_padding", True, 0.1),
    (513, 513, "causal_padding", False, 0.0),
    (513, 33, "none", False, 0.1),
    (33, 513, "key_padding", False, 0.1),
    (1025, 700, "heads", False, 0.0),
])
def test_blockwise_dense_bias_bwd_kernel_matches_plain(device, dtype, T, S, bias_kind, causal, rate):
    """The blockwise backward's dense-bias mode (the fusion models' 513-token
    attentions in training): dq, dk, dv against ``attention_bwd_plain``
    within DENSE_BWD_REL (bf16) or BWD_REL (f32), the same bits twice; and
    its dropout forward against the plain one (f32 at 1e-5: the keep bits
    are the same)."""
    from stlt_tpu_torch.ops import flash

    gen = torch.Generator().manual_seed(T + S + causal + 7)
    B = 3
    q, k, v = _heads(B, T, S, dtype, gen, device, strided=T == S)
    bias = _dense_bias(bias_kind, B, T, S, gen, device)
    dout = torch.randn(B, T, 12, 64, generator=gen).to(device, dtype)
    kw = dict(bias=bias, causal=causal, dropout_rate=rate, dropout_seed=0xC0FFEE if rate else None)
    flash.reset_launches()
    out, lse = flash.blockwise_attention(q, k, v, **kw)
    want_out, want_lse = flash.blockwise_attention_plain(q, k, v, **kw)
    dsum = flash._dsum(dout, out, None)
    got = flash.blockwise_attention_bwd(q, k, v, dout, lse, dsum, **kw)
    again = flash.blockwise_attention_bwd(q, k, v, dout, lse, dsum, **kw)
    assert flash.LAUNCHES["blockwise_attention_dense"] == 1
    assert flash.LAUNCHES["blockwise_attention_bwd_dense"] == 2
    assert flash.LAUNCHES["blockwise_attention_bwd"] == 0
    want = flash.attention_bwd_plain(q, k, v, dout, lse, dsum, **kw)
    torch.cuda.synchronize()
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else TOL[dtype]
    torch.testing.assert_close(out.float(), want_out.float(), **tol)
    torch.testing.assert_close(lse, want_lse, **TOL[torch.float32])
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.is_contiguous() and torch.isfinite(a).all(), name
        limit = DENSE_BWD_REL if dtype == torch.bfloat16 else BWD_REL[dtype]
        assert _rel(a, b) < limit, (name, _rel(a, b))
        torch.testing.assert_close(a.float(), b.float(), **TOL[dtype], msg=name)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), "not deterministic"


def test_cacnf_train_step_on_the_card_matches_the_plain_step(device, monkeypatch):
    """One f32 CACNF train step at 513 layout frames with dropout 0.1 (H =
    128, 2 heads of 64, R3D depth 10 over 8 x 32 x 32 frames, one fusion
    layer) through the kernels, against the same step with every train
    kernel's plain forward and backward on the card (same weights, batch and
    generator): loss at 1e-5, every gradient within a relative norm of 1e-4.
    The step launches the dense-bias backward three times (the layout
    self-attention and both cross-attentions) and the lengths mode once."""
    from stlt_tpu_torch.configs import make_model_config
    from stlt_tpu_torch.models import models_factory
    from stlt_tpu_torch.ops import flash
    from stlt_tpu_torch.training.criterion import make_criterion
    from stlt_tpu_torch.training.loop import step_generator

    cfg = make_model_config("cacnf", num_classes=5, unique_categories=4, hidden_size=128,
                            num_attention_heads=2, num_spatial_layers=1, num_temporal_layers=1,
                            num_appearance_layers=1, num_fusion_layers=1, appearance_num_frames=1,
                            resnet_depth=10, layout_num_frames=513, hidden_dropout_prob=0.1)
    model = models_factory["cacnf"](cfg, torch.Generator().manual_seed(8)).to(device).train()
    gen = torch.Generator().manual_seed(9)
    B, F, O = 3, 513, 4
    lengths = torch.tensor([F, 300, 40])
    pad = torch.arange(F)[None, :] >= lengths[:, None]
    frame_types = torch.where(pad, 0, 2)
    frame_types[torch.arange(B), lengths - 1] = 4
    categories = torch.randint(1, 3, (B, F, O), generator=gen)
    categories[:, :, 0] = 3
    categories[pad] = torch.tensor([3] + [0] * (O - 1))
    batch = {"categories": categories, "boxes": torch.rand(B, F, O, 4, generator=gen),
             "frame_types": frame_types, "lengths": lengths,
             "video_frames": torch.randn(B, 8, 32, 32, 3, generator=gen)}
    batch = {k: v.to(device) for k, v in batch.items()}
    labels = torch.randint(0, 5, (B,), generator=gen).to(device)
    criterion = make_criterion("something")

    def step():
        model.zero_grad(set_to_none=True)
        loss = criterion(model(batch, step_generator(0, 0)), labels)
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()
                             if p.grad is not None}

    flash.reset_launches()
    loss, grads = step()
    assert flash.LAUNCHES["blockwise_attention_bwd_dense"] == 3
    assert flash.LAUNCHES["blockwise_attention_bwd"] == 1
    assert flash.LAUNCHES["blockwise_attention_dense"] == 3
    monkeypatch.setattr(fe, "_launch_proj", lambda op, x, wqkv, bqkv, wo, bo, bias, *, seed=None,
                        dropout_rate=0.0, **kw: fe.fused_proj_attention_train_plain(
                            x, wqkv, bqkv, wo, bo, bias, seed, dropout_rate=dropout_rate, **kw))
    monkeypatch.setattr(fe, "_launch_proj_bwd", fe.fused_proj_attention_train_bwd_plain)
    monkeypatch.setattr(flash, "blockwise_attention", flash.blockwise_attention_plain)
    monkeypatch.setattr(flash, "blockwise_attention_bwd",
                        lambda *a, offsets=None, **kw: flash.attention_bwd_plain(*a, **kw))
    monkeypatch.setattr(ftt, "_launch_tail_train", ftt.fused_layer_tail_train_plain)
    monkeypatch.setattr(ftt, "_launch_tail_train_bwd", ftt.fused_layer_tail_train_bwd_plain)
    plain_loss, plain_grads = step()
    assert abs(loss - plain_loss) < 1e-5
    assert set(grads) == set(plain_grads)
    for name, g in grads.items():
        assert _rel(g, plain_grads[name]) < 1e-4, name
