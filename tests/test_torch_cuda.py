"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a GPU every test here skips. On a machine with one
(and without JAX, which this file does not import):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances, kernel against plain version on the same inputs with the same
rounding points: f32 atol = rtol = 1e-4 (sums of up to 4H products taken in
another order, then LayerNorm); bf16 atol 6e-2, rtol 2e-2 (a reordered f32
sum can round to the neighbouring bf16 value, and LayerNorm outputs move a
few bf16 steps with it). Dead rows are exact zeros in both.
"""

import math

import pytest
import torch

from stlt_tpu_torch.ops import fused_encoder as fe
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


def test_kernels_refuse_what_they_do_not_take(device):
    gen = torch.Generator().manual_seed(0)
    w = _weights(64, gen, device)
    x = torch.randn(2, 33, 64, device=device)
    proj = (w["wqkv"], w["bqkv"], w["wo"], w["bo"], None)
    with pytest.raises(ValueError, match="T <= 32"):
        fe.fused_proj_attention(x, *proj, num_heads=1, compute_dtype=torch.float32)
    with pytest.raises(TypeError, match="compute dtype"):
        fe.fused_proj_attention(x[:, :8].bfloat16(), *proj, num_heads=1, compute_dtype=torch.float32)
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
    assert fe.LAUNCHES == {"fused_proj_attention": 4, "fused_layer_tail": 4}
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
