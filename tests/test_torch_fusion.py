"""The fusion models and their two new ops through the port (plain versions
on the CPU) against the JAX package: ``fused_cross_attention`` (TPU row 5),
the dense-bias mode of the blockwise forward (row 8), and LCF, CAF and CACNF,
also at 513 layout frames.

Same numpy-seeded inputs and the same weights through both: a seeded port
model's state_dict goes into JAX's tree by the JAX package's
``torch_to_flax_params`` and back by the port's
``stlt_tpu_torch.utils.convert.jax_params_to_state_dict`` (the JAX
package's own ``flax_to_torch_state_dict`` loads too); JAX runs
``use_pallas=True`` with its Pallas kernels in interpret mode, at
``tests/test_fusion_parity.py``'s sizes (H 32, 4 heads, R3D depth 10 over
8 x 32 x 32 frames: one appearance token). Tolerances:

- ``fused_cross_attention_plain`` against JAX's ``fused_cross_attention``:
  f32 atol = rtol = 1e-5 (the same f32 function, sums in another order);
  bf16 atol 6e-2, rtol 2e-2 (``tests/test_torch_ops.py``: a reordered f32
  sum can round to the neighbouring bf16 value);
- the dense-bias ``blockwise_attention_plain`` against JAX's
  ``_blockwise_forward`` with ``bias_arr``, out and lse: f32 atol = rtol =
  1e-5 (JAX takes the softmax online over key blocks, the plain version
  normalises first: only the rounding differs);
- the models' logits, every head: f32 atol 2e-5, rtol 1e-5
  (``tests/test_torch_long_context.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_layout_batch
from stlt_tpu import configs as jax_configs
from stlt_tpu.models import models_factory as jax_models
from stlt_tpu.ops import flash as jax_flash
from stlt_tpu.ops import fused_encoder as jax_fe
from stlt_tpu.utils.convert import flax_to_torch_state_dict, torch_to_flax_params
from stlt_tpu_torch import configs
from stlt_tpu_torch.models import models_factory
from stlt_tpu_torch.ops import flash
from stlt_tpu_torch.ops import fused_encoder as fe
from stlt_tpu_torch.utils.convert import jax_params_to_state_dict

OP_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5), torch.bfloat16: dict(atol=6e-2, rtol=2e-2)}
LOGITS_TOL = dict(atol=2e-5, rtol=1e-5)
MODEL_KW = dict(num_classes=5, unique_categories=4, hidden_size=32, num_attention_heads=4,
                num_spatial_layers=1, num_temporal_layers=1, num_appearance_layers=1,
                num_fusion_layers=2, appearance_num_frames=1, resnet_depth=10, use_pallas=True)
NUM_BOXES = 4


def _cross_inputs(T, S, H, padded, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    B = 3
    args = (f(B, T, H), f(B, S, H), f(H, H, scale=0.2), f(H, scale=0.1), f(H, 2 * H, scale=0.2),
            f(2 * H, scale=0.1), f(H, H, scale=0.2), f(H, scale=0.1))
    bias = None
    if padded:
        pad = rng.random((B, S)) < 0.4
        pad[:, 0] = False
        bias = np.where(pad, -1e9, 0.0).astype(np.float32)[:, None, None, :]
    return args, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,S", [(17, 33), (33, 17)])
@pytest.mark.parametrize("padded", [False, True])
def test_cross_attention_plain_matches_jax(dtype, T, S, padded):
    H, N = 32, 4
    args, bias = _cross_inputs(T, S, H, padded, seed=T * S + padded)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    x, ctx, *w = args
    want = jax_fe.fused_cross_attention(
        jnp.asarray(x, jdt), jnp.asarray(ctx, jdt), *map(jnp.asarray, w),
        None if bias is None else jnp.asarray(bias), num_heads=N, compute_dtype=jdt)
    t = [torch.from_numpy(a) for a in args]
    fe.reset_launches()
    got = fe.fused_cross_attention(
        t[0].to(dtype), t[1].to(dtype), *t[2:], None if bias is None else torch.from_numpy(bias),
        num_heads=N, compute_dtype=dtype)
    assert got.dtype == dtype and not any(fe.LAUNCHES.values())
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **OP_TOL[dtype])


def test_cross_attention_row_with_every_key_masked_is_finite():
    """Every key of a row masked by the -1e9 bias: the logits stay finite and
    the softmax is uniform over the S real keys. (JAX pads S to a multiple of
    8 with -1e9 keys of value bv, so its uniform mean takes those in too:
    both are finite, and no model passes such a row, since every clip keeps
    its extract frame.)"""
    H, N = 32, 4
    (x, ctx, *w), _ = _cross_inputs(5, 9, H, False, seed=0)
    bias = torch.full((3, 1, 1, 9), -1e9)
    t = [torch.from_numpy(a) for a in (x, ctx, *w)]
    got = fe.fused_cross_attention(*t, bias, num_heads=N, compute_dtype=torch.float32)
    wq, bq, wkv, bkv, wo, bo = t[2:]
    v_mean = (t[1] @ wkv[:, H:] + bkv[H:]).mean(dim=1, keepdim=True)  # [B, 1, H]
    want = (v_mean @ wo + bo).expand(3, 5, H)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **OP_TOL[torch.float32])


@pytest.mark.parametrize("T,S,bias_kind,causal", [
    (513, 513, "causal_padding", True),
    (513, 513, "causal_padding", False),
    (33, 513, "key_padding", False),
    (513, 33, "none", False),
])
def test_dense_bias_blockwise_plain_matches_jax(T, S, bias_kind, causal):
    rng = np.random.default_rng(T + S + causal)
    B, N, D = 2, 2, 8
    q, k, v = (rng.standard_normal((B, L, N, D)).astype(np.float32) for L in (T, S, S))
    lengths = np.array([S, S // 3])
    if bias_kind == "causal_padding":
        allowed = (np.arange(S)[None, None, :] <= np.arange(T)[None, :, None]) & (
            np.arange(S)[None, None, :] < lengths[:, None, None])
        bias = np.where(allowed, 0.0, -1e9).astype(np.float32)[:, None]  # [B, 1, T, S]
    elif bias_kind == "key_padding":
        bias = np.where(np.arange(S)[None, :] < lengths[:, None], 0.0, -1e9).astype(np.float32)
        bias = np.broadcast_to(bias[:, None, None, :], (B, 1, T, S)).copy()
    else:
        bias = np.zeros((B, 1, T, S), np.float32)
    tr = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)  # noqa: E731
    want, want_lse = jax_flash._blockwise_forward(tr(q), tr(k), tr(v), jnp.asarray(bias), causal=causal)
    flash.reset_launches()
    got, lse = flash.blockwise_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                         bias=None if bias_kind == "none" else torch.from_numpy(bias),
                                         causal=causal)
    assert not any(flash.LAUNCHES.values())
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 2, 1, 3), **OP_TOL[torch.float32])
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **OP_TOL[torch.float32])


# --- the models -------------------------------------------------------------------


def carried_params(name, jax_cfg, model, inputs, seed):
    """JAX parameters carried from a seeded port model: its state_dict, with
    the frozen BN statistics, the CLS token, pos_embed and every bias drawn
    (their inits are constants), into JAX's tree by the JAX package's
    ``torch_to_flax_params`` (the tree's shapes from ``jax.eval_shape``, so
    JAX runs no init)."""
    rng = np.random.default_rng(seed)
    port = models_factory[name](port_config(name, jax_cfg), torch.Generator().manual_seed(seed))
    sd = {}
    for key, value in port.state_dict().items():
        a = value.numpy()
        if key.endswith("running_mean"):
            a = (rng.standard_normal(a.shape) * 0.1).astype(a.dtype)
        elif key.endswith("running_var"):
            a = (rng.random(a.shape) + 0.5).astype(a.dtype)
        elif key.endswith(("cls_token", "pos_embed")):
            a = (rng.standard_normal(a.shape) * 0.02).astype(a.dtype)
        elif key.endswith("bias"):
            a = (a + rng.standard_normal(a.shape) * 0.02).astype(a.dtype)
        sd[key] = a
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), inputs))["params"]
    template = jax.tree_util.tree_map(lambda t: np.zeros(t.shape, t.dtype), shapes)
    return torch_to_flax_params(sd, template)


def model_inputs(frames, length_range, seed, clips=2):
    batch = _synthetic_layout_batch(clips, frames, NUM_BOXES, 4, seed=seed, length_range=length_range)
    batch = {k: v for k, v in batch.items() if k != "labels"}
    rng = np.random.default_rng(seed + 1)
    batch["video_frames"] = rng.standard_normal((clips, 8, 32, 32, 3)).astype(np.float32)
    return batch


def port_config(name, jax_cfg):
    cls = configs.model_configs_factory[name]
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in dataclasses.asdict(jax_cfg).items() if k in fields})


def port_logits(name, jax_cfg, params, inputs):
    model = models_factory[name](port_config(name, jax_cfg)).eval()
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    with torch.inference_mode():
        return model({k: torch.from_numpy(v) for k, v in inputs.items()})


def jax_model(name, frames):
    cfg_cls = (jax_configs.AppearanceModelConfig if name.startswith("resnet3d")
               else jax_configs.MultimodalModelConfig)
    fields = {f.name for f in dataclasses.fields(cfg_cls)}
    kw = {k: v for k, v in dict(MODEL_KW, layout_num_frames=frames).items() if k in fields}
    cfg = cfg_cls(**kw)
    return cfg, jax_models[name](cfg)


def check_model(name, frames, length_range, seed):
    """Logits of every head, port against JAX; the JAX package's exported
    state_dict loads with strict=True."""
    cfg, model = jax_model(name, frames)
    inputs = model_inputs(frames, length_range, seed)
    params = carried_params(name, cfg, model, inputs, seed)
    want = model.apply({"params": params}, inputs)
    fe.reset_launches()
    flash.reset_launches()
    got = port_logits(name, cfg, params, inputs)
    assert not any(fe.LAUNCHES.values()) and not any(flash.LAUNCHES.values())
    assert tuple(got) == tuple(model.logit_names) == models_factory[name].logit_names
    for head in got:
        np.testing.assert_allclose(got[head].numpy(), np.asarray(want[head]), **LOGITS_TOL,
                                   err_msg=f"{name}:{head}")
    exported = {k: torch.from_numpy(np.array(v)) for k, v in flax_to_torch_state_dict(params).items()}
    models_factory[name](port_config(name, cfg)).load_state_dict(exported, strict=True)
    return got


@pytest.mark.parametrize("name", ["lcf", "caf", "cacnf"])
def test_fusion_logits_match_jax(name):
    check_model(name, 7, (3, 7), seed=3)


def test_cacnf_logits_match_jax_at_513_frames(monkeypatch):
    """513 layout frames: the temporal encoder in lengths mode, and every
    fusion attention that touches the layout stream (the layout
    self-attention, both cross-attentions) on the blockwise kernel's
    dense-bias mode, as JAX dispatches it."""
    calls = []
    real = flash.blockwise_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw.get("kv_lengths") is None))
        return real(q, k, v, **kw)

    monkeypatch.setattr(flash, "blockwise_attention", spy)
    check_model("cacnf", 513, (200, 513), seed=5)
    dense = sorted((t, s) for t, s, is_dense in calls if is_dense)
    # 2 fusion layers x (layout self 513x513, 513 <- 2 appearance tokens,
    # 2 <- 513), one temporal lengths-mode call.
    assert dense == sorted([(513, 513), (513, 2), (2, 513)] * 2)
    assert sum(not d for *_, d in calls) == 1


def test_fused_cross_attention_is_the_eval_dispatch(monkeypatch):
    """Eval with T, S <= 64 runs every cross-attention as one fused op, the
    shared ``cross_attn`` twice per fusion layer with the streams swapped."""
    shapes = []
    real = fe.fused_cross_attention

    def spy(x, ctx, *args, **kw):
        shapes.append((x.shape[1], ctx.shape[1], args[-1] is None))
        return real(x, ctx, *args, **kw)

    monkeypatch.setattr(fe, "fused_cross_attention", spy)
    cfg = configs.MultimodalModelConfig(**dict(MODEL_KW, layout_num_frames=7))
    model = models_factory["caf"](cfg).eval()
    with torch.inference_mode():
        model({k: torch.from_numpy(v) for k, v in model_inputs(7, (3, 7), seed=4).items()})
    # per layer: layout (7) <- appearance (2) without a bias, then
    # appearance <- layout with the layout padding bias.
    assert shapes == [(7, 2, True), (2, 7, False)] * MODEL_KW["num_fusion_layers"]


def test_fusion_masks_follow_the_frame_capacity_cut():
    """With a frame capacity the layout branch returns the cut axis, and the
    fusion masks are built on it: the logits equal the uncut model's."""
    cfg = configs.MultimodalModelConfig(**dict(MODEL_KW, layout_num_frames=16))
    inputs = {k: torch.from_numpy(v) for k, v in model_inputs(16, (3, 6), seed=6).items()}
    model = models_factory["cacnf"](cfg, torch.Generator().manual_seed(6)).eval()
    capped = models_factory["cacnf"](dataclasses.replace(cfg, temporal_frame_capacity=8)).eval()
    capped.load_state_dict(model.state_dict())
    with torch.inference_mode():
        full, cut = model(inputs), capped(inputs)
    for head in full:
        np.testing.assert_allclose(cut[head].numpy(), full[head].numpy(), atol=1e-5, rtol=1e-5)
