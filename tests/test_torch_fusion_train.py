"""Training the fusion models through the port (plain versions on the CPU)
against the JAX package: the dense-bias mode of the blockwise attention
backward (TPU rows 9 and 10), CAF and CACNF four-step dynamics, CACNF's
loss and gradients at 513 layout frames, the train CLI on a multimodal
dataset, and the fusion layers' own dropout stream.

Sizes, weights and dropout as ``tests/test_torch_appearance_train.py``
(whose harness this file shares: H 32, 4 heads, R3D depth 10, one fusion
layer; dropout 0 in both packages, the appearance encoder's torch-default
rate set to 0 by ``monkeypatch`` inside the test process only). Tolerances:

- the dense-bias backward, ``blockwise_attention_bwd`` on the CPU (its plain
  version) and through the autograd Function, against ``jax.vjp`` of
  ``stlt_tpu.ops.flash.flash_attention`` with the same dense bias, its
  Pallas kernels in interpret mode as the JAX package's own tests run them:
  f32 atol = rtol = 1e-5 (the same f32 function; JAX sums over key blocks
  of 384, the plain version over the whole row);
- four-step dynamics: the appearance file's (losses atol 2e-5, rtol 1e-5;
  clip norms rtol 2e-5; parameters atol 1e-5);
- CACNF at 513 layout frames: loss atol 2e-5; gradients atol = rtol = 1e-4,
  as ``tests/test_torch_long_train.py`` (sums over 513 keys in another
  order, through eight layers).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlt_tpu.ops import flash as jax_flash
from stlt_tpu.training.criterion import make_criterion as jax_make_criterion
from stlt_tpu_torch import train as port_train
from stlt_tpu_torch.configs import make_model_config
from stlt_tpu_torch.models import fusion as port_fusion
from stlt_tpu_torch.models import models_factory
from stlt_tpu_torch.ops import flash
from stlt_tpu_torch.training.criterion import make_criterion
from stlt_tpu_torch.training.loop import step_generator
from stlt_tpu_torch.utils.convert import jax_params_to_state_dict, read_state_dict
from tests.fixtures import make_something_fixture, make_video_hdf5
from tests.jax_reference import jit_vjp
from tests.test_torch_appearance_train import (  # noqa: F401 (no_encoder_dropout: a fixture)
    MODEL_KW,
    TRAIN_KW,
    _twins,
    carried_params,
    check_dynamics,
    jax_train_model,
    no_encoder_dropout,
    port_config,
    train_batch,
)

OP_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_ATOL = 2e-5
SEED = 0x5EED


# --- the dense-bias backward --------------------------------------------------------


def _dense_case(T, S, kind, seed):
    rng = np.random.default_rng(seed)
    B, N, D = 2, 2, 8
    q, k, v, dout = (rng.standard_normal((B, L, N, D)).astype(np.float32) for L in (T, S, S, T))
    lengths = np.array([S, S // 3])
    if kind == "causal_padding":
        allowed = (np.arange(S)[None, None, :] <= np.arange(T)[None, :, None]) & (
            np.arange(S)[None, None, :] < lengths[:, None, None])
        bias = np.where(allowed, 0.0, -1e9).astype(np.float32)[:, None]  # [B, 1, T, S]
    elif kind == "key_padding":
        bias = np.where(np.arange(S)[None, :] < lengths[:, None], 0.0, -1e9).astype(np.float32)
        bias = bias[:, None, None, :]  # [B, 1, 1, S]
    else:
        bias = None
    return q, k, v, dout, bias


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("T,S,kind,causal", [
    (513, 513, "causal_padding", True),
    (513, 513, "causal_padding", False),
    (513, 33, "none", False),
    (33, 513, "key_padding", False),
])
def test_dense_bias_backward_matches_jax(T, S, kind, causal, rate):
    """dq, dk, dv of the fusion models' 513-token attentions (the layout
    self-attention with the causal+padding bias, with JAX's causal flag on
    and off; 513 <- 33 without a bias; 33 <- 513 with key padding), with
    hashed dropout at 0 and 0.1: the backward wrapper on the CPU (from the
    forward's lse and dsum) and the autograd Function both equal JAX's
    ``jax.vjp`` through its blockwise backward kernels."""
    q, k, v, dout, bias = _dense_case(T, S, kind, seed=T + 2 * S + causal + int(10 * rate))
    seed = SEED if rate else None

    def jax_attention(q, k, v):
        return jax_flash.flash_attention(
            q, k, v, None if bias is None else jnp.asarray(bias), dropout_rate=rate,
            dropout_seed=None if seed is None else jnp.uint32(seed), causal=causal)

    want_out, want = jit_vjp(jax_attention, list(map(jnp.asarray, (q, k, v))), jnp.asarray(dout))

    t = {name: torch.from_numpy(a) for name, a in zip("qkvd", (q, k, v, dout))}
    tb = None if bias is None else torch.from_numpy(bias)
    kw = dict(bias=tb, causal=causal, dropout_rate=rate, dropout_seed=seed)
    flash.reset_launches()
    out, lse = flash.blockwise_attention(t["q"], t["k"], t["v"], **kw)
    grads = flash.blockwise_attention_bwd(t["q"], t["k"], t["v"], t["d"], lse,
                                          flash._dsum(t["d"], out, None), **kw)
    qkv = [t[name].clone().requires_grad_() for name in "qkv"]
    through = flash.flash_attention(*qkv, bias=tb, causal=causal, dropout_rate=rate,
                                    dropout_seed=seed)
    through.backward(t["d"])
    assert not any(flash.LAUNCHES.values())
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **OP_TOL)
    np.testing.assert_allclose(through.detach().numpy(), np.asarray(want_out), **OP_TOL)
    for name, got, auto, ref in zip(("dq", "dk", "dv"), grads, (x.grad for x in qkv), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), err_msg=name, **OP_TOL)
        np.testing.assert_allclose(auto.numpy(), np.asarray(ref), err_msg=f"autograd {name}",
                                   **OP_TOL)


# --- the models ---------------------------------------------------------------------


@pytest.mark.parametrize("name", ["caf", "cacnf"])
def test_fusion_train_dynamics_match_jax(name, no_encoder_dropout):
    """Four steps of CAF and CACNF (CACNF's four heads each take the loss,
    the ensemble too): losses, clip norms and parameters equal JAX's; every
    FrozenBatchNorm stays put; the fusion models' ``pos_embed`` and
    ``cls_token`` decay, as JAX's do."""
    port, before = check_dynamics(name, seed=7)
    moved = {k for k, v in port.state_dict().items() if not torch.equal(v, before[k])}
    assert any("mm_fusion.0.cross_attn" in k for k in moved)
    assert any(k.endswith("pos_embed") for k in moved)


def test_cacnf_loss_and_gradients_match_jax_at_513_frames(monkeypatch, no_encoder_dropout):
    """At 513 layout frames the temporal encoder takes the blockwise
    backward's lengths mode and every fusion attention on the layout stream
    its dense-bias mode (the layout self-attention 513 x 513, the shared
    cross-attention 513 <- 2 and 2 <- 513): loss and every gradient against
    ``jax.grad`` of JAX's train loss."""
    frames, seed = 513, 9
    cfg, model = jax_train_model("cacnf", frames)
    batch = train_batch(frames, "something", seed)
    inputs = {k: v for k, v in batch.items() if k not in ("labels", "valid")}
    params = carried_params("cacnf", cfg, model, inputs, seed)
    criterion = jax_make_criterion("something")

    def loss_fn(p):
        logits = model.apply({"params": p}, inputs, deterministic=False,
                             rngs={"dropout": jax.random.PRNGKey(0)})
        return criterion(logits, batch["labels"], batch["valid"])

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = jax_params_to_state_dict(want_grads)

    calls = []
    real = flash.blockwise_attention_bwd

    def spy(q, k, v, dout, lse, dsum, **kw):
        calls.append((q.shape[1], k.shape[1], kw.get("kv_lengths") is None))
        return real(q, k, v, dout, lse, dsum, **kw)

    monkeypatch.setattr(flash, "blockwise_attention_bwd", spy)
    port = models_factory["cacnf"](port_config("cacnf", cfg))
    port.load_state_dict(jax_params_to_state_dict(params), strict=True)
    port.train()
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = make_criterion("something")(
        port({k: v for k, v in tensors.items() if k not in ("labels", "valid")},
             step_generator(0, 0)),
        tensors["labels"], tensors["valid"])
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= LOSS_ATOL
    assert sorted(c for c in calls if c[2]) == sorted([(513, 513, True), (513, 2, True),
                                                      (2, 513, True)])
    assert sum(not c[2] for c in calls) == TRAIN_KW["num_temporal_layers"]
    checked, twins = 0, _twins(params)
    for name, p in port.named_parameters():
        if name in twins and p.requires_grad:
            np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=name, **GRAD_TOL)
            checked += 1
    assert checked > 50


# --- the train CLI ------------------------------------------------------------------


def _cli_argv(root, paths, videos, *extra):
    return [
        "--dataset_name", "something", "--dataset_type", "multimodal", "--model_name", "cacnf",
        "--train_dataset_path", paths["dataset_path"], "--val_dataset_path", paths["dataset_path"],
        "--labels_path", paths["labels_path"], "--videoid2size_path", paths["videoid2size_path"],
        "--videos_path", videos, "--layout_num_frames", "4", "--appearance_num_frames", "4",
        "--spatial_size", "64", "--batch_size", "2", "--epochs", "2", "--warmup_epochs", "1",
        "--learning_rate", "1e-3", "--hidden_size", "32", "--num_attention_heads", "4",
        "--num_spatial_layers", "1", "--num_temporal_layers", "1", "--num_appearance_layers", "1",
        "--num_fusion_layers", "1", "--resnet_depth", "10", "--platform", "cpu", *extra,
    ]


def test_train_cli_trains_cacnf_and_fine_tunes_a_frozen_backbone(tmp_path):
    """``train --dataset_type multimodal --model_name cacnf --platform cpu``:
    two epochs with dropout 0.1, every head's metrics, a best ``.pt`` that
    loads with ``strict=True`` and a backbone ``.pt``. Then a fine-tune from
    that backbone with ``--freeze_backbone``: the backbone in its best
    ``.pt`` is the loaded one, bit for bit, and the heads moved."""
    root = str(tmp_path)
    paths, _, _, sizes = make_something_fixture(root, num_videos=4)
    videos = make_video_hdf5(root, sizes, num_frames=9)
    best, backbone = os.path.join(root, "best.pt"), os.path.join(root, "backbone.pt")
    result = port_train.main(_cli_argv(root, paths, videos, "--save_model_path", best,
                                       "--save_backbone_path", backbone))
    assert result.step == 2 * 2 and [r["epoch"] for r in result.epochs] == [1, 2]
    assert all(np.isfinite(r["train_loss"]) for r in result.epochs)
    heads = models_factory["cacnf"].logit_names
    assert set(result.epochs[0]["metrics"]) == {f"{h}_top{k}_accuracy" for h in heads for k in (1, 5)}
    cfg = make_model_config("cacnf", **dict(MODEL_KW, num_fusion_layers=1, num_classes=4,
                                            appearance_num_frames=4, layout_num_frames=256))
    model = models_factory["cacnf"](cfg)
    model.load_state_dict(read_state_dict(best), strict=True)
    model.backbone.load_state_dict(read_state_dict(backbone), strict=True)

    tuned = os.path.join(root, "tuned.pt")
    port_train.main(_cli_argv(root, paths, videos, "--save_model_path", tuned,
                              "--load_backbone_path", backbone, "--freeze_backbone", "--seed", "3"))
    loaded, after = read_state_dict(backbone), read_state_dict(tuned)
    for key, value in loaded.items():
        torch.testing.assert_close(after[f"backbone.{key}"], value, atol=0, rtol=0, msg=key)
    init = models_factory["cacnf"](cfg, torch.Generator().manual_seed(3)).state_dict()
    for head in ("layout_classifier", "appearance_classifier", "fusion_classifier"):
        assert not torch.equal(after[f"{head}.fc2.weight"], init[f"{head}.fc2.weight"])


@pytest.mark.parametrize("flag", [["--save_backbone_path", "b.pt"], ["--load_backbone_path", "b.pt"]])
def test_train_cli_backbone_flags_need_a_backbone(tmp_path, flag):
    """The backbone flags act on the models with a ``backbone`` (STLT and
    CACNF); for CAF they raise naming those."""
    root = str(tmp_path)
    paths, *_ = make_something_fixture(root, num_videos=2)
    argv = _cli_argv(root, paths, "videos.h5", "--save_model_path", os.path.join(root, "m.pt"), *flag)
    argv[argv.index("cacnf")] = "caf"
    with pytest.raises(ValueError, match="acts on a model's backbone"):
        port_train.main(argv)


# --- the fusion layers' own dropout stream -------------------------------------------


def test_fusion_dropout_is_a_seeded_stream():
    """The sublayers' output dropout (JAX's flax ``nn.Dropout``): hashed keep
    bits from one seed of the step's generator, so a CACNF train forward is
    the same for the same (seed, step) and differs across steps; the keep
    share is near 1 - rate and kept values are scaled by 1 / (1 - rate)."""
    cfg = make_model_config("cacnf", **dict(MODEL_KW, num_fusion_layers=1, layout_num_frames=7,
                                            hidden_dropout_prob=0.1))
    model = models_factory["cacnf"](cfg, torch.Generator().manual_seed(1)).train()
    inputs = {k: torch.from_numpy(v) for k, v in train_batch(7, "something", 2).items()
              if k not in ("labels", "valid")}
    with torch.no_grad():
        a = model(inputs, step_generator(4, 7))
        b = model(inputs, step_generator(4, 7))
        c = model(inputs, step_generator(4, 8))
    for head in a:
        torch.testing.assert_close(a[head], b[head], atol=0, rtol=0)
        assert not torch.equal(a[head], c[head])

    layer = port_fusion.FeedforwardModule(cfg, torch.Generator().manual_seed(0)).train()
    ones = torch.ones((4, 513, 256))
    dropped = port_fusion._output_dropout(layer, ones, step_generator(4, 7))
    keep = dropped != 0
    assert abs(keep.float().mean().item() - 0.9) < 3e-3
    torch.testing.assert_close(dropped[keep], torch.full_like(dropped[keep], 1 / 0.9))
    again = port_fusion._output_dropout(layer, ones, step_generator(4, 7))
    assert torch.equal(dropped, again)
    assert torch.equal(port_fusion._output_dropout(layer.eval(), ones, None), ones)
