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
# Row 4's bf16 dqkv, dWo and dbo against the plain backward, relative norm
# (chip_smoke.py's PROJ_BWD_REL, set between the sound kernels' error and the
# smallest planted fault: python -m stlt_tpu_torch.utils.bwd_tolerance proj_bwd).
PROJ_BWD_REL = 1e-3


def _proj_bwd_close(got, want, dtype, live=None):
    """Row 4's (dqkv, dWo, dbo) against the plain backward: dqkv elementwise
    with dead rows exact zeros; dWo and dbo within GRAD_REL; in bf16 all
    three within PROJ_BWD_REL too."""
    _close(got[0], want[0], dtype, live)
    rel = [_rel(a, b) for a, b in zip(got, want)]
    assert rel[1] < GRAD_REL[dtype] and rel[2] < GRAD_REL[dtype], rel
    if dtype == torch.bfloat16:
        assert max(rel) < PROJ_BWD_REL, rel


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
    _proj_bwd_close((dqkv, dwo, dbo), want, dtype, live)
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
    # Outside the kernels' domain (H a multiple of 64 up to 1024, head dim 32,
    # 64 or 128): H = 1088, and head dim 8.
    ctx = torch.randn(2, 17, 1088, device=device)
    cross = (torch.randn(1088, 1088, device=device), torch.zeros(1088, device=device),
             torch.randn(1088, 2176, device=device), torch.zeros(2176, device=device),
             torch.randn(1088, 1088, device=device), torch.zeros(1088, device=device), None)
    with pytest.raises(ValueError, match="H in 64"):
        fe.fused_cross_attention(ctx[:, :8], ctx, *cross, num_heads=17, compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="head dim in"):
        fe.fused_proj_attention(x[:, :8], *proj, num_heads=8, compute_dtype=torch.float32)
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


@pytest.mark.parametrize("T", [8, 17, 33])
def test_bf16_sublayers_read_the_model_weights_in_place_and_repeat_their_bits(device, T):
    """Rows 1, 3 and 5 in bf16 (``csrc/sublayer.cuh``) read the parameters'
    storage in place: ``weight_storage`` of the views the attention layer
    passes (``in_proj_weight.t()``, its row slices, ``out_proj.weight.t()``)
    is that storage, and they give the same bits as contiguous input-major
    weights. A second launch repeats the bits, and so does a launch into a
    scratch filled with NaN beforehand: no row past the live count reaches
    an output."""
    bf, H, N = torch.bfloat16, 768, 12
    gen = torch.Generator().manual_seed(T)
    w = _weights(H, gen, device)
    in_proj = w["wqkv"].t().contiguous().to(bf)  # [3H, H], as the model stores it
    out_proj = w["wo"].t().contiguous().to(bf)
    views = dict(wqkv=in_proj.t(), wo=out_proj.t(), wq=in_proj[:H].t(), wkv=in_proj[H:].t())
    for name, base in (("wqkv", in_proj), ("wo", out_proj), ("wq", in_proj[:H]), ("wkv", in_proj[H:])):
        assert fe.weight_storage(views[name], bf).data_ptr() == base.data_ptr(), name
    dense = {name: v.contiguous() for name, v in views.items()}
    rows = 41
    x = torch.randn(rows, T, H, generator=gen).to(device, bf)
    bias = _bias("causal_padding", rows, T, gen).to(device)
    rows_live = (torch.rand(rows, generator=gen) < 0.6).to(device)
    kw = dict(num_heads=N, compute_dtype=bf, rows_live=rows_live)
    for seed, rate in ((None, 0.0), (0x5EED, 0.1)):
        op = "fused_proj_attention" if seed is None else "fused_proj_attention_train"

        def run(wts, scratch=None):
            return fe._launch_proj(op, x, wts["wqkv"], w["bqkv"], wts["wo"], w["bo"], bias, seed=seed,
                                   dropout_rate=rate, scratch=scratch, **kw)

        got = run(views)
        poisoned = fe.proj_scratch(rows, T, H, x).fill_(0xFF)  # every bf16 a NaN
        for again in (run(dense), run(views), run(views, poisoned)):
            assert torch.equal(got, again), op
        assert not got[~rows_live].any()
    ctx = torch.randn(rows, 33, H, generator=gen).to(device, bf)
    cw = lambda wts: (wts["wq"], w["bqkv"][:H], wts["wkv"], w["bqkv"][H:], wts["wo"], w["bo"])  # noqa: E731
    got = fe.fused_cross_attention(x, ctx, *cw(views), None, num_heads=N, compute_dtype=bf)
    poisoned = fe.cross_scratch(rows, T, 33, H, x).fill_(0xFF)
    for again in (fe.fused_cross_attention(x, ctx, *cw(dense), None, num_heads=N, compute_dtype=bf),
                  fe._launch_cross(x, ctx, *cw(views), None, num_heads=N, compute_dtype=bf,
                                   scratch=poisoned)):
        assert torch.equal(got, again)


@pytest.mark.parametrize("T,ragged", [(8, True), (17, False), (33, True)])
def test_bf16_proj_bwd_reads_the_model_weights_in_place_and_repeats_its_bits(device, T, ragged):
    """Row 4 in bf16 (``csrc/fused_proj_attention_bwd.cu`` ``launch_tc``)
    reads the parameters' storage in place: ``proj_bwd_weights`` of the
    views the attention layer passes is that storage, and the backward gives
    the same bits as from contiguous input-major weights. A second launch
    repeats the bits, and so does a launch into a scratch filled with NaN
    beforehand: no row past the live count reaches an output, and dead rows'
    dqkv is exact zeros."""
    bf, H, N = torch.bfloat16, 768, 12
    gen = torch.Generator().manual_seed(100 + T)
    w = _weights(H, gen, device)
    in_proj = w["wqkv"].t().contiguous().to(bf)  # [3H, H], as the model stores it
    out_proj = w["wo"].t().contiguous().to(bf)
    stored = fe.proj_bwd_weights(in_proj.t(), out_proj.t(), bf)
    assert stored[0].data_ptr() == in_proj.data_ptr() and stored[1].data_ptr() == out_proj.data_ptr()
    rows = 45
    x = torch.randn(rows, T, H, generator=gen).to(device, bf)
    g = torch.randn(rows, T, H, generator=gen).to(device, bf)
    bias = _bias("causal_padding", rows, T, gen).to(device)
    rows_live = (torch.rand(rows, generator=gen) < 0.6).to(device) if ragged else None
    if ragged:
        g[~rows_live] = 0
    kw = dict(num_heads=N, dropout_rate=0.1, compute_dtype=bf, rows_live=rows_live)

    def run(wqkv, wo, scratch=None):
        return fe._launch_proj_bwd(x, wqkv, w["bqkv"], wo, bias, g, 0x5EED, scratch=scratch, **kw)

    got = run(in_proj.t(), out_proj.t())
    poisoned = fe.proj_bwd_scratch(rows, T, H, x).fill_(0xFF)  # every bf16 and f32 a NaN
    for again in (run(in_proj.t().contiguous(), out_proj.t().contiguous()), run(in_proj.t(), out_proj.t()),
                  run(in_proj.t(), out_proj.t(), poisoned)):
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.isfinite(t.float()).all() for t in got)
    if ragged:
        assert not got[0][~rows_live].any()
    want = fe.fused_proj_attention_train_bwd_plain(x, in_proj.t(), w["bqkv"], out_proj.t(), bias, g, 0x5EED, **kw)
    _proj_bwd_close(got, want, bf, None if rows_live is None else rows_live[:, None].expand(rows, T))


def test_bf16_proj_bwd_sums_its_partials_in_order_and_repeats_its_bits_under_load(device):
    """Row 4's bf16 dWo and dbo are the split partials in the scratch summed
    in split order (``proj_bwd_finalize_kernel``, the f32 path's pass too),
    and sixteen launches at a spatial shape of eight splits give the same
    bits: the weight GEMM's dbo column sums finish reading a ring stage
    before the stage is freed for a later step's TMA load."""
    bf, H, N, T, rows = torch.bfloat16, 768, 12, 17, 512
    gen = torch.Generator().manual_seed(417)
    w = _weights(H, gen, device)
    in_proj = w["wqkv"].t().contiguous().to(bf)
    out_proj = w["wo"].t().contiguous().to(bf)
    x = torch.randn(rows, T, H, generator=gen).to(device, bf)
    g = torch.randn(rows, T, H, generator=gen).to(device, bf)
    rows_live = (torch.rand(rows, generator=gen) < 0.9).to(device)
    g[~rows_live] = 0
    scratch = fe.proj_bwd_scratch(rows, T, H, x)

    def run():
        return fe._launch_proj_bwd(x, in_proj.t(), w["bqkv"], out_proj.t(), None, g, 0x5EED, num_heads=N,
                                   dropout_rate=0.1, compute_dtype=bf, rows_live=rows_live, scratch=scratch)

    got = run()
    v = fe.proj_bwd_scratch_views(scratch, rows, T, H)
    assert v["partial"].shape[0] == 8
    sum_w, sum_b = torch.zeros_like(got[1]), torch.zeros_like(got[2])
    for k in range(v["partial"].shape[0]):
        sum_w += v["partial"][k]
        sum_b += v["partial_b"][k]
    assert torch.equal(got[1], sum_w) and torch.equal(got[2], sum_b)
    for _ in range(16):
        assert all(torch.equal(a, b) for a, b in zip(got, run()))


def test_bf16_proj_bwd_refuses_what_it_does_not_take(device):
    """Row 4's bf16 wrapper refuses, in its own words, a scratch too small
    for the shape, a clip over 64 tokens and a width off the kernels' grid."""
    bf, H = torch.bfloat16, 128
    gen = torch.Generator().manual_seed(7)
    w = _weights(H, gen, device)
    x = torch.randn(4, 8, H, generator=gen).to(device, bf)
    args = (x, w["wqkv"], w["bqkv"], w["wo"], None, x.clone(), 1)
    kw = dict(num_heads=2, dropout_rate=0.1, compute_dtype=bf, rows_live=None)
    short = fe.proj_bwd_scratch(3, 8, H, x)
    with pytest.raises(ValueError, match="scratch of"):
        fe._launch_proj_bwd(*args, scratch=short, **kw)
    x65 = torch.randn(2, 65, H, generator=gen).to(device, bf)
    with pytest.raises(ValueError, match="T <= 64"):
        fe._launch_proj_bwd(x65, *args[1:5], x65, 1, **kw)
    w96 = _weights(96, gen, device)
    x96 = torch.randn(2, 8, 96, generator=gen).to(device, bf)
    with pytest.raises(ValueError, match="H in 64"):
        fe._launch_proj_bwd(x96, w96["wqkv"], w96["bqkv"], w96["wo"], None, x96, 1, **kw)


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
                              "blockwise_attention_dense": 0, "blockwise_attention_offsets": 0,
                              "flash_attention_bwd": 0, "blockwise_attention_bwd": 0,
                              "blockwise_attention_bwd_dense": 0,
                              "blockwise_attention_bwd_offsets": 0,
                              **MASK_MODES_IDLE}
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
                              "blockwise_attention_dense": 0, "blockwise_attention_offsets": 0,
                              "flash_attention_bwd": 0, "blockwise_attention_bwd": 0,
                              "blockwise_attention_bwd_dense": 0,
                              "blockwise_attention_bwd_offsets": 0,
                              **MASK_MODES_IDLE}
    want, want_lse = flash.blockwise_attention_plain(q, k, v, kv_lengths=lengths.to(device), causal=causal)
    torch.cuda.synchronize()
    live = (torch.arange(T)[None, :] < lengths[:, None]).to(device)  # [B, T]
    _close(out, want, dtype, live[:, :, None, None].expand(out.shape))
    torch.testing.assert_close(lse.transpose(1, 2)[live], want_lse.transpose(1, 2)[live],
                               **TOL[torch.float32])
    assert lse.transpose(1, 2)[~live].abs().max().item() == 0.0


MASK_MODES_IDLE = {"flash_attention_mask": 0, "blockwise_attention_mask": 0,
                   "flash_attention_bwd_mask": 0, "blockwise_attention_bwd_mask": 0}


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
    # The dropout-mask operand runs in its mask mode (held against the plain
    # versions and the seed mode in test_mask_mode_kernels_match_plain and
    # test_hashed_mask_equals_the_seed_mode); a mask of the wrong shape or
    # device is refused in the wrappers' words.
    mask = torch.rand(2, 1, 100, 100, generator=gen).to(device) < 0.9
    flash.reset_launches()
    got = flash.flash_attention(q[:, :100], k[:, :100], v[:, :100], dropout_mask=mask, dropout_rate=0.1)
    want = flash.fused_attention_plain(q[:, :100], k[:, :100], v[:, :100], dropout_mask=mask,
                                       dropout_rate=0.1)
    _close(got, want, torch.bfloat16)
    assert flash.LAUNCHES["flash_attention_mask"] == 1 and flash.LAUNCHES["flash_attention"] == 0
    with pytest.raises(ValueError, match=r"dropout_mask must be \[B, 1 or N, T, S\]"):
        flash.flash_attention(q[:, :100], k[:, :100], v[:, :100], dropout_mask=mask[:, :, :99],
                              dropout_rate=0.1)
    with pytest.raises(ValueError, match="dropout_mask must be on"):
        flash.fused_attention(q[:, :100], k[:, :100], v[:, :100], dropout_mask=mask.cpu(),
                              dropout_rate=0.1)
    lse = dsum = torch.zeros(2, 12, 513, device=device)
    with pytest.raises(ValueError, match=r"blockwise_attention_bwd: dropout_mask must be"):
        flash.blockwise_attention_bwd(q, k, v, q, lse, dsum, bias=torch.zeros(2, 1, 513, 513, device=device),
                                      dropout_mask=torch.ones(2, 3, 513, 513, device=device),
                                      dropout_rate=0.1)
    with pytest.raises(ValueError, match="ring offsets require kv_lengths"):
        flash.blockwise_attention_bwd(q, k, v, q, lse, dsum, offsets=torch.tensor([0, 0]))
    q8 = torch.randn(2, 100, 4, 8, device=device)  # head dim 8: outside 32, 64, 128
    with pytest.raises(ValueError, match="head dim in"):
        flash.flash_attention(q8, q8, q8)
    with pytest.raises(ValueError, match="head dim in"):
        flash.flash_attention(*(torch.randn(2, 600, 4, 8, device=device) for _ in range(3)),
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
                              "blockwise_attention_dense": 0, "blockwise_attention_offsets": 0,
                              "flash_attention_bwd": 1, "blockwise_attention_bwd": 0,
                              "blockwise_attention_bwd_dense": 0,
                              "blockwise_attention_bwd_offsets": 0,
                              **MASK_MODES_IDLE}
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
                              "blockwise_attention_dense": 0, "blockwise_attention_offsets": 0,
                              "flash_attention_bwd": 0, "blockwise_attention_bwd": 0,
                              "blockwise_attention_bwd_dense": 0,
                              "blockwise_attention_bwd_offsets": 0,
                              **MASK_MODES_IDLE}
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
                              "blockwise_attention_dense": 0, "blockwise_attention_offsets": 0,
                              "flash_attention_bwd": 2 * steps, "blockwise_attention_bwd": 0,
                              "blockwise_attention_bwd_dense": 0,
                              "blockwise_attention_bwd_offsets": 0,
                              **MASK_MODES_IDLE}
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
    if live_kind.startswith("some:"):  # exactly n live tokens, at random places
        live = torch.zeros(tokens, dtype=torch.bool)
        live[torch.randperm(tokens, generator=gen)[:int(live_kind[5:])]] = True
    elif live_kind != "none":
        live = torch.rand(tokens, generator=gen) < 0.7
        live[:40] = False  # a whole dead block
        if live_kind == "dead_tile":
            live[128:256] = False  # a whole dead 128-token tile of the bf16 GEMMs
    if live is not None:
        g[~live] = 1e30  # a dead token's cotangent is never read
        live = live.to(device)
    return x, a, g.to(device, dtype), weights, live


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,tokens,rate,activation,live_kind", [
    (64, 203, 0.1, "gelu", "tokens"),
    (128, 96, 0.0, "relu", "none"),
    (768, 1000, 0.1, "gelu", "tokens"),
    (768, 300, 0.0, "gelu", "none"),
    (768, 17000, 0.1, "gelu", "tokens"),  # 264 row blocks, 3 splits of the weight products
    (768, 1000, 0.1, "gelu", "some:333"),  # a live count no multiple of 64 or 128
    (768, 700, 0.1, "gelu", "some:50"),  # fewer live tokens than one GEMM tile
    (768, 600, 0.1, "gelu", "dead_tile"),
    (768, 256, 0.1, "gelu", "some:0"),  # no live token: every output and sum zero
    (320, 600, 0.1, "gelu", "some:333"),
    (1024, 600, 0.1, "gelu", "some:333"),
])
def test_tail_train_kernels_match_plain(device, dtype, H, tokens, rate, activation, live_kind):
    """The four kernels of the fused train tail against their plain versions
    on the same inputs: y and r2 elementwise (OP tolerance), dr2 and the
    summed gradients in relative norm (TAIL_SUM_REL), dx and dattn in
    relative norm (TAIL_BWD_REL); dead tokens exact zeros under a 1e30
    cotangent, no NaN, and a second launch bit-identical. The live counts
    cover the bf16 backward's packed rows: ragged, below one 128-token tile,
    a whole dead tile, none."""
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tail_kernels_take_the_models_weight_layout(device, dtype):
    """The model hands the layer tails ``linear.weight.t()``; the eval tail,
    the train forward and the train backward read that storage in place (no
    copy when the dtype matches) and give the same bits as for contiguous
    [H, FF] / [FF, H] weights."""
    gen = torch.Generator().manual_seed(5)
    x, a, g, weights, live = _tail_case(768, 500, "tokens", gen, device, dtype)
    weights = [w.to(dtype) if w.dim() == 2 else w for w in weights]
    views = list(weights)
    views[2], views[4] = (w.t().contiguous().t() for w in (weights[2], weights[4]))
    for w in (views[2], views[4]):
        assert fe.weight_storage(w, dtype).data_ptr() == w.data_ptr()
    kw = dict(eps=1e-12, compute_dtype=dtype, activation="gelu", gelu_approximate=dtype == torch.bfloat16,
              tokens_live=live[None])
    cfg = ftt.TailConfig(1e-12, "gelu", dtype == torch.bfloat16, 0.1, 0x5EED)
    r2 = ftt.fused_layer_tail_train_plain(x, a, weights, cfg, live)[1]
    for run in (lambda w: [fe.fused_layer_tail(x[None], a[None], *w, **kw)],
                lambda w: ftt._launch_tail_train(x, a, w, cfg, live),
                lambda w: ftt._launch_tail_train_bwd(x, a, r2, g, w, cfg, live)):
        got, want = run(views), run(weights)
        torch.cuda.synchronize()
        assert all(torch.equal(p, q) for p, q in zip(got, want))


def test_tail_train_scratch_rows_past_the_count_never_reach_the_weights(device):
    """The bf16 backward's scratch rows from the live count on are the
    kernels' to zero: with the memory the scratch gets filled with NaN
    beforehand (the caching allocator hands freed blocks back), dW1, dW2 and
    the other gradients stay finite and within their limits."""
    dtype, H, tokens = torch.bfloat16, 768, 1000
    gen = torch.Generator().manual_seed(6)
    x, a, g, weights, live = _tail_case(H, tokens, "some:333", gen, device, dtype)
    cfg = ftt.TailConfig(1e-12, "gelu", True, 0.1, 0x5EED)
    r2 = ftt.fused_layer_tail_train_plain(x, a, weights, cfg, live)[1]
    want = ftt.fused_layer_tail_train_bwd_plain(x, a, r2, g, weights, cfg, live)
    dr2 = ftt._launch_bwd_row(r2, g, weights[6], cfg, live)[0]
    torch.cuda.synchronize()
    poison = [torch.full((tokens, w), float("nan"), dtype=dt, device=device)
              for w, dt in ((H, dtype), (H, dtype), (4 * H, dtype), (4 * H, dtype), (H, torch.float32))]
    del poison
    got_inp = ftt._launch_bwd_input(x, a, dr2, weights, cfg, live)
    got = (*got_inp[:4], *ftt._launch_bwd_weight(got_inp[4]))
    torch.cuda.synchronize()
    names = ("dx", "dattn", "dn1s", "dn1b", "dw1", "db1", "dw2")
    for name, p, q in zip(names, got, want):
        limit = TAIL_BWD_REL[dtype] if name in ("dx", "dattn") else TAIL_SUM_REL[dtype]
        assert torch.isfinite(p).all() and _rel(p, q) < limit, (name, _rel(p, q))


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
# stlt_tpu_torch.utils.bwd_tolerance cross dense``; PERF.md, PRs 6 and
# 15). Row 8's dense-bias mode takes the forwards' ATTN_FWD_REL.
CROSS_REL = 1.2e-3
# The forwards' bf16 output, rows 6 and 8 in every mode: sound kernels read
# at most 1.3e-4, P V with P's hi part only 2.7e-3, the causal key range one
# key short 7.2e-3, O not rescaled 0.31, the keep bits at (s, t) 0.41
# (H100; PERF.md, PR 15; python -m stlt_tpu_torch.utils.bwd_tolerance
# attention dense).
ATTN_FWD_REL = 5e-4
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
        assert _rel(out, want) < ATTN_FWD_REL, _rel(out, want)
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


# --- every head dim and width the kernels take (ROADMAP.md §C 1) ---------------

# (H, heads): head dim 32, an odd width (5 heads of 64), head dim 128 at the
# widest H.
WIDTHS = [(256, 8), (320, 5), (1024, 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,N", WIDTHS)
@pytest.mark.parametrize("T", [8, 17, 33])
def test_proj_kernels_match_plain_at_every_width(device, dtype, H, N, T):
    """Rows 1, 3 and 4 (eval, train forward with dropout, train backward)
    at head dims 32, 64 and 128 and widths 256, 320 and 1024."""
    gen = torch.Generator().manual_seed(H + N + T)
    rows = 23
    w = _weights(H, gen, device)
    x = torch.randn(rows, T, H, generator=gen).to(device, dtype)
    bias = _bias("causal_padding", rows, T, gen).to(device)
    rows_live = (torch.rand(rows, generator=gen) < 0.7).to(device)
    live = rows_live[:, None].expand(rows, T)
    kw = dict(num_heads=N, compute_dtype=dtype, rows_live=rows_live)
    args = (x, w["wqkv"], w["bqkv"], w["wo"], w["bo"], bias)
    _close(fe.fused_proj_attention(*args, **kw), fe.fused_proj_attention_plain(*args, **kw), dtype, live)
    kw["dropout_rate"] = 0.1
    fwd = (*args, 0x5EED)
    _close(fe.fused_proj_attention_train(*fwd, **kw), fe.fused_proj_attention_train_plain(*fwd, **kw),
           dtype, live)
    g = torch.randn(x.shape, generator=gen).to(device, dtype)
    g[~rows_live] = 0
    bwd = (x, w["wqkv"], w["bqkv"], w["wo"], bias, g, 0x5EED)
    got, want = fe._launch_proj_bwd(*bwd, **kw), fe.fused_proj_attention_train_bwd_plain(*bwd, **kw)
    torch.cuda.synchronize()
    _proj_bwd_close(got, want, dtype, live)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [320, 576, 960, 1024])
def test_tail_kernels_match_plain_at_every_width(device, dtype, H):
    """Row 2 and rows 11-14 at odd widths (5, 9 and 15 column blocks of 64)
    and the widest."""
    gen = torch.Generator().manual_seed(H)
    x, a, g, weights, live = _tail_case(H, 600, "tokens", gen, device, dtype)
    kw = dict(eps=1e-12, compute_dtype=dtype, activation="gelu", gelu_approximate=dtype == torch.bfloat16)
    tl = dict(tokens_live=live[None])
    _close(fe.fused_layer_tail(x[None], a[None], *weights, **kw, **tl),
           fe.fused_layer_tail_plain(x[None], a[None], *weights, **kw, **tl), dtype,
           live[None, :, None].expand(1, 600, H))
    cfg = ftt.TailConfig(1e-12, "gelu", dtype == torch.bfloat16, 0.1, 0x5EED)
    y, r2 = ftt._launch_tail_train(x, a, weights, cfg, live)
    want_y, want_r2 = ftt.fused_layer_tail_train_plain(x, a, weights, cfg, live)
    _close(y, want_y, dtype)
    got = ftt._launch_tail_train_bwd(x, a, want_r2, g, weights, cfg, live)
    want = ftt.fused_layer_tail_train_bwd_plain(x, a, want_r2, g, weights, cfg, live)
    torch.cuda.synchronize()
    for i, (p, q) in enumerate(zip(got, want)):
        assert torch.isfinite(p).all() and _rel(p, q) < TAIL_BWD_REL[dtype], (i, _rel(p, q))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,N", WIDTHS)
def test_cross_attention_kernel_matches_plain_at_every_width(device, dtype, H, N):
    gen = torch.Generator().manual_seed(H + N)
    rows = 19
    w = _cross_weights(H, gen, device)
    x = torch.randn(rows, 17, H, generator=gen).to(device, dtype)
    ctx = torch.randn(rows, 33, H, generator=gen).to(device, dtype)
    pad = torch.rand(rows, 33, generator=gen) < 0.3
    pad[:, 0] = False
    bias = masks.key_padding_bias(pad).to(device)
    kw = dict(num_heads=N, compute_dtype=dtype)
    got = fe.fused_cross_attention(x, ctx, *w, bias, **kw)
    want = fe.fused_cross_attention_plain(x, ctx, *w, bias, **kw)
    torch.cuda.synchronize()
    _close(got, want, dtype)
    if dtype == torch.bfloat16:
        assert _rel(got, want) < CROSS_REL, _rel(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_attention_kernels_match_plain_at_every_head_dim(device, dtype, D):
    """Rows 6-10 at head dims 32, 64 and 128 (the bf16 backwards: the staged
    body at 32, the wgmma body at 64 and 128): the short kernel and its
    backward (T = 257, dropout 0.1), the blockwise lengths mode (T = 513,
    causal, ragged, dropout 0.1) and its backward."""
    from stlt_tpu_torch.ops import flash

    gen = torch.Generator().manual_seed(D)
    N = 256 // D
    drop = dict(dropout_rate=0.1, dropout_seed=0x5EED)
    for T in (257, 513):
        B = 3
        q, k, v = (torch.randn(B, T, N, D, generator=gen).to(device, dtype) for _ in range(3))
        dout = torch.randn(B, T, N, D, generator=gen).to(device, dtype)
        if T == 257:
            bias = _bias("causal_padding", B, T, gen).to(device)
            out, lse = flash.fused_attention(q, k, v, bias, with_lse=True, **drop)
            want, want_lse = flash.fused_attention_plain(q, k, v, bias, with_lse=True, **drop)
            kw, dead = dict(bias=bias, **drop), None
            bwd = flash.fused_attention_bwd
        else:
            lengths = torch.tensor([1, T, 300], device=device)
            kw = dict(kv_lengths=lengths, causal=True, **drop)
            out, lse = flash.blockwise_attention(q, k, v, **kw)
            want, want_lse = flash.blockwise_attention_plain(q, k, v, **kw)
            dead = torch.arange(T, device=device)[None, :] >= lengths[:, None]
            bwd = flash.blockwise_attention_bwd
        torch.cuda.synchronize()
        _close(out, want, dtype)
        torch.testing.assert_close(lse, want_lse, **TOL[torch.float32])
        dsum = flash._dsum(dout, want, kw.get("kv_lengths"))
        got = bwd(q, k, v, dout, want_lse, dsum, **kw)
        _check_grads(got, flash.attention_bwd_plain(q, k, v, dout, want_lse, dsum, **kw), dtype, dead)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offsets", [(0, 0), (0, 257), (257, 0), (257, 257)])
def test_blockwise_offsets_kernel_matches_plain(device, dtype, offsets):
    """The ring-offset mode at a 512-frame clip's per-rank shapes (C = 2):
    out and lse of live rows, dead rows zeros with lse 0, a live row with no
    live key in the chunk zeros with lse -1e30, never NaN."""
    from stlt_tpu_torch.ops import flash

    gen = torch.Generator().manual_seed(sum(offsets))
    B, T = 6, 257
    q, k, v = _heads(B, T, T, dtype, gen, device, strided=True)
    lengths = torch.tensor([33, 513, 257, 258, 100, 400], device=device)
    kw = dict(kv_lengths=lengths, causal=True, offsets=offsets)
    flash.reset_launches()
    out, lse = flash.blockwise_attention(q, k, v, **kw)
    assert flash.LAUNCHES["blockwise_attention_offsets"] == 1 and flash.LAUNCHES["blockwise_attention"] == 0
    want, want_lse = flash.blockwise_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    row0, col0 = offsets
    t = torch.arange(T, device=device)[None, :] + row0
    live = t < lengths[:, None]
    _close(out, want, dtype, live[:, :, None, None].expand(out.shape))
    torch.testing.assert_close(lse, want_lse, **TOL[torch.float32])
    none = live & ((col0 >= lengths[:, None]) | (col0 > t))
    if none.any():
        assert (lse.transpose(1, 2)[none] == flash._NEG_INF).all()
        assert out[none].abs().max().item() == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offsets", [(0, 0), (0, 257), (257, 0), (257, 257)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_blockwise_offsets_bwd_kernel_matches_plain(device, dtype, offsets, rate):
    """The backward's ring-offset mode at a 512-frame clip's per-rank shapes
    (C = 2), from the whole clip's lse and output as a ring step takes them:
    dq, dk, dv against the plain version, a cotangent of 1e30 on dead rows
    (global indices) that the kernel must not read, dq of dead rows and of
    rows with no live key in the chunk exact zeros, outputs filled with NaN
    beforehand fully written, the same bits twice."""
    from stlt_tpu_torch.ops import flash

    gen = torch.Generator().manual_seed(sum(offsets) + 7)
    B, T = 6, 257
    q, k, v = _heads(B, 2 * T, 2 * T, dtype, gen, device)
    lengths = torch.tensor([33, 513, 257, 258, 100, 400], device=device)
    drop = dict(dropout_rate=rate, dropout_seed=0x5EED if rate else None)
    out, lse = flash.blockwise_attention_plain(q, k, v, kv_lengths=lengths, causal=True)
    row0, col0 = offsets
    rows, cols = slice(row0, row0 + T), slice(col0, col0 + T)
    q, out, lse = q[:, rows], out[:, rows], lse[:, :, rows].contiguous()
    t = torch.arange(T, device=device)[None, :] + row0
    live = t < lengths[:, None]
    dout = torch.randn(B, T, 12, 64, generator=gen).to(device, dtype)
    dout[~live] = 1e30
    dsum = flash._dsum(dout, out, lengths, row0)
    kw = dict(kv_lengths=lengths, causal=True, offsets=offsets, **drop)
    empty = torch.empty

    def nan_filled(*args, **kwargs):
        x = empty(*args, **kwargs)
        return x.fill_(float("nan")) if x.is_floating_point() else x

    # The chunk copied, and as the ring passes it: the clip's column view
    # (a k/v row stride of the whole clip's, kb != S kt).
    results = []
    for kc, vc in ((k[:, cols].contiguous(), v[:, cols].contiguous()), (k[:, cols], v[:, cols])):
        flash.reset_launches()
        try:
            torch.empty = nan_filled
            got = flash.blockwise_attention_bwd(q, kc, vc, dout, lse, dsum, **kw)
        finally:
            torch.empty = empty
        assert flash.LAUNCHES["blockwise_attention_bwd_offsets"] == 1
        assert flash.LAUNCHES["blockwise_attention_bwd"] == 0
        want = flash.attention_bwd_plain(q, kc, vc, dout, lse, dsum, **kw)
        again = flash.blockwise_attention_bwd(q, kc, vc, dout, lse, dsum, **kw)
        torch.cuda.synchronize()
        no_key = live & ((col0 >= lengths[:, None]) | (col0 > t))
        _check_grads(got, want, dtype, ~live | no_key)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), "not deterministic"
        results.append(got)
    assert all(torch.equal(a, b) for a, b in zip(*results)), "the column view reads other values"


# --- the attention kernels' dropout-mask operand (rows 6-10, mask mode) -------------


def _mask_case(route, dtype, shared, gen, device):
    """Inputs of one mask-mode route at its kernel's shapes: (q, k, v, the
    wrappers' keyword arguments with a Bernoulli(0.9) mask [B, 1|12, T, S],
    the forward and backward wrappers, the [B, T] live rows or None). The
    ring-offset route takes rank 1's rows of a 514-frame clip against chunk
    0, its mask the chunk's column view of the rank's [B, n, 257, 514] rows."""
    from stlt_tpu_torch.ops import flash

    B, T = 4, 513 if route in ("lengths", "dense") else 257
    q, k, v = _heads(B, T, T, dtype, gen, device, strided=route != "dense")
    n = 1 if shared else 12
    kw, live = dict(dropout_rate=0.1), None
    if route == "flash":
        kw["bias"] = _bias("causal_padding", B, T, gen).to(device)
        kw["dropout_mask"] = (torch.rand(B, n, T, T, generator=gen) < 0.9).to(device)
        return q, k, v, kw, flash.fused_attention, flash.fused_attention_bwd, live
    lengths = torch.tensor([1, 300, 64, T], dtype=torch.int32, device=device)
    if route == "dense":
        kw.update(bias=flash._lengths_dense_bias(lengths, T, T, True), causal=True)
    else:
        kw.update(kv_lengths=lengths, causal=True)
        live = torch.arange(T, device=device)[None, :] < lengths[:, None]
    if route == "offsets":
        lengths = torch.tensor([33, 514, 300, 400], dtype=torch.int32, device=device)
        kw.update(kv_lengths=lengths, offsets=(T, 0))
        live = torch.arange(T, device=device)[None, :] + T < lengths[:, None]
        full = (torch.rand(B, n, T, 2 * T, generator=gen) < 0.9).to(device)
        kw["dropout_mask"] = full[..., :T]
    else:
        kw["dropout_mask"] = (torch.rand(B, n, T, T, generator=gen) < 0.9).to(device)
    return q, k, v, kw, flash.blockwise_attention, flash.blockwise_attention_bwd, live


def _mask_forward(fwd, q, k, v, kw):
    """(out, lse) of a forward wrapper or plain version: the short ones take
    the bias positionally and give lse on request."""
    from stlt_tpu_torch.ops import flash

    if fwd in (flash.fused_attention, flash.fused_attention_plain):
        rest = {n: x for n, x in kw.items() if n != "bias"}
        return fwd(q, k, v, kw["bias"], with_lse=True, **rest)
    return fwd(q, k, v, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route", ["flash", "lengths", "dense", "offsets"])
@pytest.mark.parametrize("shared", [False, True])
def test_mask_mode_kernels_match_plain(device, dtype, route, shared):
    """Rows 6-10 in mask mode, per-head and head-broadcast masks, in every
    mode the kernels have: out and lse against the plain forward (f32 within
    1e-5, which one flipped keep bit would break), dq, dk, dv against
    attention_bwd_plain within BWD_REL (DENSE_BWD_REL in the dense mode's
    bf16), the mask-mode launch counts, and a planted fault: one flipped
    keep bit of a live (t, s) moves the output past the tolerance."""
    from stlt_tpu_torch.ops import flash

    gen = torch.Generator().manual_seed(len(route) + 10 * shared)
    q, k, v, kw, fwd, bwd, live = _mask_case(route, dtype, shared, gen, device)
    flash.reset_launches()
    out, lse = _mask_forward(fwd, q, k, v, kw)
    name = "flash_attention" if fwd is flash.fused_attention else "blockwise_attention"
    assert flash.LAUNCHES[name + "_mask"] == 1 and sum(flash.LAUNCHES.values()) == 1
    plain = flash.fused_attention_plain if fwd is flash.fused_attention else flash.blockwise_attention_plain
    want, want_lse = _mask_forward(plain, q, k, v, kw)
    torch.cuda.synchronize()
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else TOL[dtype]
    rows = torch.ones(out.shape[:2], dtype=torch.bool, device=device) if live is None else live
    torch.testing.assert_close(out.float()[rows], want.float()[rows], **tol)
    torch.testing.assert_close(lse.transpose(1, 2)[rows], want_lse.transpose(1, 2)[rows],
                               **TOL[torch.float32])

    dout = torch.randn(out.shape, generator=gen).to(device, dtype)
    dsum = flash._dsum(dout, want, kw.get("kv_lengths"), kw.get("offsets", (0, 0))[0])
    got = bwd(q, k, v, dout, want_lse, dsum, **kw)
    assert flash.LAUNCHES[name + "_bwd_mask"] == 1 and sum(flash.LAUNCHES.values()) == 2
    wanted = flash.attention_bwd_plain(q, k, v, dout, want_lse, dsum, **kw)
    torch.cuda.synchronize()
    limit = DENSE_BWD_REL if route == "dense" and dtype == torch.bfloat16 else BWD_REL[dtype]
    for what, a, b in zip(("dq", "dk", "dv"), got, wanted):
        assert torch.isfinite(a).all() and _rel(a, b) < limit, (what, _rel(a, b))

    if dtype == torch.float32:  # the f32 limit is the one a single keep bit must break
        flipped = kw["dropout_mask"].clone()
        b = 1 if route == "offsets" else 0  # clip 0's rows are dead in the ring case
        flipped[b, 0, 0, 0] = ~flipped[b, 0, 0, 0]  # (t, s) = (0, 0): live in every route
        fault = _mask_forward(fwd, q, k, v, {**kw, "dropout_mask": flipped})[0]
        err = (fault.float() - want.float()).abs()
        assert (err > tol["atol"] + tol["rtol"] * want.float().abs()).any(), "flipped bit not seen"


@pytest.mark.parametrize("route", ["flash", "lengths", "dense", "offsets"])
def test_hashed_mask_equals_the_seed_mode(device, route):
    """A mask equal to hash_keep_mask(seed, ...) gives the seed mode's
    output, lse and gradients bit for bit: the same keep bits through the
    same arithmetic (bf16)."""
    from stlt_tpu_torch.ops import flash
    from stlt_tpu_torch.ops.dropout import hash_keep_mask

    gen = torch.Generator().manual_seed(len(route))
    q, k, v, kw, fwd, bwd, _ = _mask_case(route, torch.bfloat16, False, gen, device)
    B, T, N, _ = q.shape
    seed = 0xC0FFEE
    seeded = {**{n: x for n, x in kw.items() if n != "dropout_mask"}, "dropout_seed": seed}
    masked = {**kw, "dropout_mask": hash_keep_mask(seed, B, N, T, k.shape[1], 0.1, device)}
    outs = [_mask_forward(fwd, q, k, v, c) for c in (seeded, masked)]
    dout = torch.randn(q.shape, generator=gen).to(device, q.dtype)
    dsum = flash._dsum(dout, outs[0][0], kw.get("kv_lengths"), kw.get("offsets", (0, 0))[0])
    grads = [bwd(q, k, v, dout, outs[0][1], dsum, **c) for c in (seeded, masked)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.parametrize("route", ["flash", "lengths", "dense", "offsets"])
def test_mask_mode_backward_relaunch_is_bit_identical(device, route):
    """Rows 7 and 9-10 in mask mode (bf16, per-head mask): two launches give
    the same bits, as the seed mode's tests check for theirs."""
    from stlt_tpu_torch.ops import flash

    gen = torch.Generator().manual_seed(len(route) + 3)
    q, k, v, kw, fwd, bwd, _ = _mask_case(route, torch.bfloat16, False, gen, device)
    out, lse = _mask_forward(fwd, q, k, v, kw)
    dout = torch.randn(out.shape, generator=gen).to(device, q.dtype)
    dsum = flash._dsum(dout, out, kw.get("kv_lengths"), kw.get("offsets", (0, 0))[0])
    first = bwd(q, k, v, dout, lse, dsum, **kw)
    second = bwd(q, k, v, dout, lse, dsum, **kw)
    torch.cuda.synchronize()
    assert all(torch.isfinite(a).all() for a in first)
    assert all(torch.equal(a, b) for a, b in zip(first, second)), "not deterministic"


# --- the attention backward on wgmma and TMA (rows 7, 9-10) ----------------------


@pytest.mark.parametrize("T", [65, 513])
@pytest.mark.parametrize("fill", ["next_clip_1e4", "inf_past_the_clip"])
def test_attention_bwd_reads_nothing_past_its_clip(device, T, fill):
    """The bf16 backwards' TMA maps bound each clip, so a clip's last tile
    (65 = 64 + 1, 513 = 8 * 64 + 1 rows) reads zeros past its rows: with
    clip 2's q, k, v and dO 1e4 times larger, clips 0 and 1's dq, dk, dv
    equal the plain version's; with inf in the rows past every clip (views
    of [B, T + 64] buffers), every clip's do. T = 65 on the short kernel
    (causal+padding bias), 513 on the blockwise lengths mode, dropout 0.1."""
    from stlt_tpu_torch.ops import flash

    gen = torch.Generator().manual_seed(T + len(fill))
    B, N, D, dtype = 3, 12, 64, torch.bfloat16
    pad = 64 if fill == "inf_past_the_clip" else 0
    bufs = [torch.randn(B, T + pad, N, D, generator=gen) for _ in range(4)]
    for x in bufs:
        if pad:
            x[:, T:] = float("inf")
        else:
            x[2] *= 1e4
    q, k, v, dout = (x.to(device, dtype)[:, :T] for x in bufs)
    drop = dict(dropout_rate=0.1, dropout_seed=0x5EED)
    if T < 513:
        kw = dict(bias=_bias("causal_padding", B, T, gen).to(device), **drop)
        out, lse = flash.fused_attention_plain(q, k, v, kw["bias"], with_lse=True, **drop)
        dsum, bwd = flash._dsum(dout, out, None), flash.fused_attention_bwd
    else:
        lengths = torch.tensor([T, 300, T], dtype=torch.int32, device=device)
        kw = dict(kv_lengths=lengths, causal=True, **drop)
        out, lse = flash.blockwise_attention_plain(q, k, v, **kw)
        dsum, bwd = flash._dsum(dout, out, lengths), flash.blockwise_attention_bwd
    got = bwd(q, k, v, dout, lse, dsum, **kw)
    want = flash.attention_bwd_plain(q, k, v, dout, lse, dsum, **kw)
    torch.cuda.synchronize()
    clips = slice(None) if pad else slice(0, 2)
    _check_grads(tuple(g[clips] for g in got), tuple(g[clips] for g in want), dtype)


# --- the attention forward on wgmma and TMA (rows 6 and 8) ------------------------

# (route, T, S, extra keyword arguments) of the forward cases: row 6's bias
# mode at T = 65 and 257 (eval, and with lse, dropout or a mask), row 8's
# lengths mode at 513 and 1025 (causal or not, dropout), its ring-offset
# mode and its dense-bias mode (flag on and off, no bias, T != S).
FWD_CASES = [
    ("flash", 65, 65, {}),
    ("flash", 257, 257, {}),
    ("flash", 257, 257, {"with_lse": True}),
    ("flash", 257, 257, {"with_lse": True, "dropout_rate": 0.1}),
    ("flash", 257, 257, {"with_lse": True, "mask": True}),
    ("lengths", 513, 513, {"causal": True}),
    ("lengths", 513, 513, {"causal": False}),
    ("lengths", 1025, 1025, {"causal": True, "dropout_rate": 0.1}),
    ("lengths", 513, 513, {"causal": True, "mask": True}),
    ("offsets", 257, 257, {"offsets": (0, 257)}),
    ("offsets", 257, 257, {"offsets": (257, 0), "dropout_rate": 0.1}),
    ("dense", 513, 513, {"causal": True}),
    ("dense", 513, 513, {"causal": False, "dropout_rate": 0.1}),
    ("dense", 513, 33, {"bias": None}),
    ("dense", 33, 513, {"bias": "key_padding"}),
    ("dense", 513, 513, {"causal": True, "mask": True}),
]


def _fwd_case(route, T, S, extra, D, gen, device, B=3):
    """q, k, v [B, T|S, N, D] bf16 (the q/k/v thirds of one projection where
    T = S), the forward wrapper and its plain version as (out, lse)
    callables, and the [B, T] live rows (None: every row) and the rows with
    no live key in the held chunk (None: none)."""
    from stlt_tpu_torch.ops import flash

    N = 768 // D
    if T == S:
        qkv = torch.randn(B, T, 3, N, D, generator=gen).to(device, torch.bfloat16)
        q, k, v = qkv.unbind(2)
    else:
        q, k, v = (torch.randn(B, L, N, D, generator=gen).to(device, torch.bfloat16) for L in (T, S, S))
    kw = {}
    if extra.get("dropout_rate"):
        kw.update(dropout_rate=extra["dropout_rate"], dropout_seed=0x5EED)
    if extra.get("mask"):
        kw.update(dropout_rate=0.1, dropout_mask=(torch.rand(B, N, T, S, generator=gen) < 0.9).to(device))
    live = none = None
    if route == "flash":
        bias = _bias("causal_padding", B, T, gen).to(device)
        with_lse = extra.get("with_lse", False)

        def call(fn):
            res = fn(q, k, v, bias, with_lse=with_lse, **kw)
            return res if with_lse else (res, None)

        return q, k, v, lambda: call(flash.fused_attention), lambda: call(flash.fused_attention_plain), live, none
    if route == "dense":
        kind = extra.get("bias", "causal_padding")
        if kind == "causal_padding":
            kw["bias"] = _bias("causal_padding", B, T, gen).to(device)
        elif kind == "key_padding":
            pad = torch.rand(B, S, generator=gen) < 0.3
            pad[:, 0] = False
            kw["bias"] = masks.key_padding_bias(pad).to(device)
        kw["causal"] = extra.get("causal", False)
    else:
        row0, col0 = extra.get("offsets", (0, 0))
        clip_lengths = [2 * T, 33, T + 100] if route == "offsets" else [T, 1, T // 2 + 3]
        lengths = torch.tensor(clip_lengths * B, dtype=torch.int32, device=device)[:B]
        kw.update(kv_lengths=lengths, causal=extra.get("causal", True))
        if route == "offsets":
            kw["offsets"] = (row0, col0)
        t = torch.arange(T, device=device)[None, :] + row0
        live = t < lengths[:, None]
        none = live & ((col0 >= lengths[:, None]) | ((col0 > t) if kw["causal"] else False))
    return (q, k, v, lambda: flash.blockwise_attention(q, k, v, **kw),
            lambda: flash.blockwise_attention_plain(q, k, v, **kw), live, none)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("route,T,S,extra", FWD_CASES)
def test_attention_fwd_wgmma_body_matches_plain(device, D, route, T, S, extra):
    """Rows 6 and 8 in bf16 at head dims 64 and 128, on the wgmma body, in
    every mode: out within the bf16 tolerance and ATTN_FWD_REL, lse within
    the f32 tolerance on live rows, dead rows zeros with lse 0, a live row
    with no live key in the chunk zeros with lse -1e30, two launches
    bit-identical."""
    gen = torch.Generator().manual_seed(D + T + S + len(extra))
    q, k, v, kernel, plain, live, none = _fwd_case(route, T, S, extra, D, gen, device)
    (out, lse), (want, want_lse) = kernel(), plain()
    again = kernel()
    torch.cuda.synchronize()
    assert out.is_contiguous() and torch.isfinite(out.float()).all()
    rows = torch.ones(out.shape[:2], dtype=torch.bool, device=device) if live is None else live
    torch.testing.assert_close(out.float()[rows], want.float()[rows], **TOL[torch.bfloat16])
    assert _rel(out, want) < ATTN_FWD_REL, _rel(out, want)
    assert torch.equal(out, again[0])
    if lse is not None:
        torch.testing.assert_close(lse.transpose(1, 2)[rows], want_lse.transpose(1, 2)[rows],
                                   **TOL[torch.float32])
        assert torch.equal(lse, again[1])
    if live is not None and (~live).any():
        assert out[~live].abs().max().item() == 0.0 and lse.transpose(1, 2)[~live].abs().max().item() == 0.0
    if none is not None and none.any():
        assert out[none].abs().max().item() == 0.0
        assert (lse.transpose(1, 2)[none] == -1e30).all()


@pytest.mark.parametrize("route,T", [("flash", 65), ("lengths", 513), ("dense", 513)])
@pytest.mark.parametrize("fill", ["next_clip_1e4", "inf_past_the_clip"])
def test_attention_fwd_reads_nothing_past_its_clip(device, route, T, fill):
    """The bf16 forward's TMA maps bound each clip, so a clip's last tile
    (65 = 64 + 1, 513 = 8 * 64 + 1 rows) reads zeros past its rows: with
    clip 2's q, k and v 1e4 times larger, clips 0 and 1's out and lse equal
    the plain version's; with inf in the rows past every clip (views of
    [B, T + 64] buffers), every clip's do. Dropout 0.1."""
    from stlt_tpu_torch.ops import flash

    gen = torch.Generator().manual_seed(T + len(fill) + len(route))
    B, N, D = 3, 12, 64
    pad = 64 if fill == "inf_past_the_clip" else 0
    bufs = [torch.randn(B, T + pad, N, D, generator=gen) for _ in range(3)]
    for x in bufs:
        if pad:
            x[:, T:] = float("inf")
        else:
            x[2] *= 1e4
    q, k, v = (x.to(device, torch.bfloat16)[:, :T] for x in bufs)
    kw = dict(dropout_rate=0.1, dropout_seed=0x5EED)
    if route == "flash":
        bias = _bias("causal_padding", B, T, gen).to(device)
        got = flash.fused_attention(q, k, v, bias, with_lse=True, **kw)
        want = flash.fused_attention_plain(q, k, v, bias, with_lse=True, **kw)
    else:
        if route == "lengths":
            kw.update(kv_lengths=torch.tensor([T, 300, T], dtype=torch.int32, device=device), causal=True)
        else:
            kw.update(bias=_bias("causal_padding", B, T, gen).to(device))
        got = flash.blockwise_attention(q, k, v, **kw)
        want = flash.blockwise_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    clips = slice(None) if pad else slice(0, 2)
    (out, lse), (want_out, want_lse) = ((x[clips] for x in pair) for pair in (got, want))
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(out.float(), want_out.float(), **TOL[torch.bfloat16])
    assert _rel(out, want_out) < ATTN_FWD_REL
    torch.testing.assert_close(lse, want_lse, **TOL[torch.float32])


@pytest.mark.parametrize("route,T,S,extra", [FWD_CASES[3], FWD_CASES[7], FWD_CASES[10], FWD_CASES[12]])
def test_attention_fwd_repeats_its_bits_under_load_into_a_nan_buffer(device, route, T, S, extra):
    """Sixteen launches of the bf16 forward at B = 32 give the same bits as
    the first, each into an output block that was filled with NaN and freed
    just before (the allocator hands it to the wrapper's torch.empty): every
    element of out and lse is written, none read."""
    gen = torch.Generator().manual_seed(T + S)
    q, k, v, kernel, _, _, _ = _fwd_case(route, T, S, extra, 64, gen, device, B=32)
    first = kernel()
    torch.cuda.synchronize()
    for _ in range(16):
        poison = [torch.full_like(x, float("nan")) for x in first]
        ptrs = [x.data_ptr() for x in poison]
        del poison
        got = kernel()
        assert [x.data_ptr() for x in got] == ptrs, "the output did not take the NaN-filled blocks"
        assert all(torch.equal(a, b) for a, b in zip(first, got))


def test_attention_fwd_refuses_an_operand_tma_cannot_map(device):
    """A bf16 D = 64 operand that passes the wrappers' checks but that TMA
    cannot map (a clip stride of 2**41 bytes: the map's strides stop below
    2**40) raises, launches nothing and leaves the card usable."""
    from stlt_tpu_torch.ops import flash

    gen = torch.Generator().manual_seed(9)
    q, k, v = (torch.randn(1, 257, 12, 64, generator=gen).to(device, torch.bfloat16) for _ in range(3))
    far = q.as_strided(q.shape, (2 ** 40, *q.stride()[1:]))
    flash.reset_launches()
    with pytest.raises(RuntimeError, match="cannot map"):
        flash.fused_attention(far, k, v)
    with pytest.raises(RuntimeError, match="cannot map"):
        flash.blockwise_attention(far, k, v, kv_lengths=torch.tensor([200], device=device), causal=True)
    torch.cuda.synchronize()
    assert not any(flash.LAUNCHES.values())
    _close(flash.fused_attention(q, k, v), flash.fused_attention_plain(q, k, v), torch.bfloat16)


# --- the bf16 layer tail on wgmma and TMA (rows 2 and 11) --------------------------


@pytest.mark.parametrize("tokens,live_kind", [
    (64 * 17, "temporal"),  # the temporal stage at B = 64: 9 tiles of 128
    (1000, "ragged"),       # a ragged edge: 1000 = 7 x 128 + 104
    (640, "dead_tile"),     # tokens 128..255 all dead: one tile computes nothing
])
def test_bf16_tail_tiles_and_determinism(device, tokens, live_kind):
    """The bf16 tail (eval and train, dropout 0.1) at the temporal stage's
    size, a ragged last tile and an all-dead tile: y and r2 against the plain
    versions, dead tokens exact zeros, and two launches bit-identical."""
    dtype, H = torch.bfloat16, 768
    gen = torch.Generator().manual_seed(tokens)
    x, a, _, weights, live = _tail_case(H, tokens, "tokens", gen, device, dtype)
    if live_kind == "temporal":
        live = (torch.arange(17)[None, :] < torch.randint(4, 18, (64, 1), generator=gen)).reshape(-1)
    elif live_kind == "dead_tile":
        live = torch.rand(tokens, generator=gen) < 0.7
        live[128:256] = False
    live = live.to(device)
    kw = dict(eps=1e-12, compute_dtype=dtype, activation="gelu", gelu_approximate=True)
    tl = dict(tokens_live=live[None])
    run = lambda: fe.fused_layer_tail(x[None], a[None], *weights, **kw, **tl)
    got, again = run(), run()
    want = fe.fused_layer_tail_plain(x[None], a[None], *weights, **kw, **tl)
    torch.cuda.synchronize()
    _close(got, want, dtype, live[None, :, None].expand(1, tokens, H))
    assert torch.equal(got, again), "eval tail not deterministic"
    cfg = ftt.TailConfig(1e-12, "gelu", True, 0.1, 0x5EED)
    (y, r2), (y2, r22) = (ftt._launch_tail_train(x, a, weights, cfg, live) for _ in range(2))
    want_y, want_r2 = ftt.fused_layer_tail_train_plain(x, a, weights, cfg, live)
    torch.cuda.synchronize()
    tok_live = live[:, None].expand(tokens, H)
    _close(y, want_y, dtype, tok_live)
    _close(r2, want_r2, dtype, tok_live)
    assert torch.equal(y, y2) and torch.equal(r2, r22), "train tail not deterministic"
