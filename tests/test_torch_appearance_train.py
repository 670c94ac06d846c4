"""Training the appearance branch through the port (plain versions on the
CPU) against the JAX package: the optimizer's masks, the Kinetics R3D load,
four-step dynamics of ``resnet3d``, ``resnet3d-transformer`` and LCF,
frozen-backbone CACNF and STLT steps, and the appearance train data path.

Same numpy-seeded inputs and the same weights through both (a seeded port
model's state_dict carried into JAX's ``jax.eval_shape`` tree,
``tests/test_torch_fusion.py::carried_params``), at the fusion tests'
sizes (H 32, 4 heads, R3D depth 10 over 8 x 32 x 32 frames: one appearance
token; one fusion layer). JAX trains with ``use_pallas=False``: its train
step compiles in seconds here, and the port's CPU path is the same
function. Dropout is 0 in both packages: ``hidden_dropout_prob`` 0, and the
appearance encoder's ``TORCH_ENCODER_DROPOUT`` (torch's default 0.1, read
when a model is built) set to 0 in both modules for the test's duration by
``monkeypatch``, inside the test process only; no file of the JAX package
changes.

Dynamics are JAX's own ``make_train_step`` with its ``make_optimizer``
(the ``multi_transform`` of a trainable and a frozen partition), wrapped so
that each step also reports the global norm of the trainable partition's
gradients, the norm the clip reads. Tolerances: losses atol 2e-5, rtol 1e-5
and parameters atol 1e-5, as ``tests/test_torch_train.py`` (the same f32
functions, sums in another order); the clip's norms rtol 2e-5 (a norm over
some 10^5 f32 gradients, each a sum over thousands of convolution taps in
another order: sound runs read up to 8e-6); frozen and twinless parameters
bit-unchanged. The clip engages (asserted). The learning rate is 3e-4, not
``test_torch_train``'s 1e-3: at 1e-3 ``resnet3d`` fits its two valid clips
in three steps (loss 1.2e-4), its gradients shrink to their rounding, and
Adam's per-element normalisation lifts that rounding to 2e-4 in the
parameters; at 3e-4 sound runs differ by at most 1.1e-6 while every model's
parameters move by 7e-4 or more, seventy times the tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stlt_tpu import configs as jax_configs
from stlt_tpu.data import collaters_factory as jax_collaters
from stlt_tpu.data import datasets_factory as jax_datasets
from stlt_tpu.data.loader import Loader as JaxLoader
from stlt_tpu.models import appearance as jax_appearance
from stlt_tpu.models import models_factory as jax_models
from stlt_tpu.training import optimizer as jax_opt
from stlt_tpu.training.criterion import make_criterion as jax_make_criterion
from stlt_tpu.training.loop import create_train_state, make_train_step as jax_make_train_step
from stlt_tpu.utils.convert import load_kinetics_r3d as jax_load_kinetics_r3d
from stlt_tpu_torch.configs import DataConfig
from stlt_tpu_torch.data import collaters_factory, datasets_factory
from stlt_tpu_torch.data.loader import Loader
from stlt_tpu_torch.models import appearance as port_appearance
from stlt_tpu_torch.models import models_factory
from stlt_tpu_torch.training import optimizer as port_opt
from stlt_tpu_torch.training.criterion import make_criterion
from stlt_tpu_torch.training.loop import make_train_step, step_generator
from stlt_tpu_torch.utils.convert import jax_params_to_state_dict, load_kinetics_r3d
from tests.fixtures import make_something_fixture, make_video_hdf5
from tests.test_torch_fusion import MODEL_KW, carried_params, model_inputs, port_config

TRAIN_HP = dict(lr=3e-4, weight_decay=0.1, clip_val=0.01, warmup=2, total=8, steps=4)
LOSS_TOL = dict(atol=2e-5, rtol=1e-5)
PARAM_ATOL = 1e-5
NORM_RTOL = 2e-5
TRAIN_KW = dict(MODEL_KW, num_fusion_layers=1, use_pallas=False, hidden_dropout_prob=0.0)
NUM_CLASSES = MODEL_KW["num_classes"]
CLIPS = 3


@pytest.fixture
def no_encoder_dropout(monkeypatch):
    """The appearance encoder's torch-default dropout set to 0 in both
    packages (read when a model is built), for this test only."""
    monkeypatch.setattr(jax_appearance, "TORCH_ENCODER_DROPOUT", 0.0)
    monkeypatch.setattr(port_appearance, "TORCH_ENCODER_DROPOUT", 0.0)


def jax_train_model(name, frames=7, **overrides):
    cfg_cls = {"stlt": jax_configs.StltModelConfig, "resnet3d": jax_configs.AppearanceModelConfig,
               "resnet3d-transformer": jax_configs.AppearanceModelConfig}.get(
                   name, jax_configs.MultimodalModelConfig)
    fields = {f.name for f in dataclasses.fields(cfg_cls)}
    kw = dict(TRAIN_KW, layout_num_frames=frames, **overrides)
    cfg = cfg_cls(**{k: v for k, v in kw.items() if k in fields})
    return cfg, jax_models[name](cfg)


def train_batch(frames, dataset, seed):
    """A CLIPS-clip multimodal batch (the appearance models read its frames
    only) with labels and a last padded row (``valid`` False)."""
    batch = model_inputs(frames, (3, frames), seed, clips=CLIPS)
    rng = np.random.default_rng(seed + 2)
    if dataset == "something":
        batch["labels"] = rng.integers(0, NUM_CLASSES, CLIPS).astype(np.int32)
    else:
        batch["labels"] = (rng.random((CLIPS, NUM_CLASSES)) < 0.4).astype(np.float32)
    batch["valid"] = np.arange(CLIPS) < CLIPS - 1
    return batch


def _recording(tx, trainable):
    """``tx`` whose state also holds the global norm of the last update's
    trainable gradients (the norm ``clip_by_global_norm`` reads inside the
    trainable partition)."""
    keep = jax.tree_util.tree_leaves(trainable)

    def init(params):
        return tx.init(params), jnp.zeros((), jnp.float32)

    def update(grads, state, params=None):
        leaves = [g for g, t in zip(jax.tree_util.tree_leaves(grads), keep) if t]
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, optax.global_norm(leaves))

    return optax.GradientTransformation(init, update)


def jax_dynamics(model, params, batch, dataset, freeze_backbone=False):
    """JAX's per-step losses and clip norms and its final parameters."""
    hp = TRAIN_HP
    tx = jax_opt.make_optimizer(
        params, learning_rate=hp["lr"], weight_decay=hp["weight_decay"], clip_val=hp["clip_val"],
        num_warmup_steps=hp["warmup"], num_training_steps=hp["total"],
        freeze_backbone=freeze_backbone, no_decay_names=jax_opt.model_no_decay_names(model))
    trainable = jax_opt.frozen_stats_mask(params)
    if freeze_backbone:
        trainable = jax.tree_util.tree_map(lambda a, b: a and b, trainable,
                                           jax_opt.frozen_backbone_mask(params, True))
    recording = _recording(tx, trainable)
    state = create_train_state(params, recording)
    step = jax.jit(jax_make_train_step(model, recording, jax_make_criterion(dataset)))
    losses, norms = [], []
    for _ in range(hp["steps"]):
        state, loss = step(state, batch, np.uint32(7))
        losses.append(float(loss))
        norms.append(float(state.opt_state[1]))
    return losses, norms, state.params


def _twins(params):
    """Port parameter names with a JAX counterpart: what the converter fills
    from the tree (not its zeros for the dead classifiers and
    score_embeddings, not its copy into the dead encoder_layer prototype)."""
    ones = jax_params_to_state_dict(jax.tree_util.tree_map(np.ones_like, params))
    return {k for k, v in ones.items() if ".encoder_layer." not in k and bool((v == 1).all())}


def port_dynamics(name, cfg, params, batch, dataset, freeze_backbone=False):
    """The port's model after TRAIN_HP's steps, its state before, the
    per-step losses and clip norms."""
    model = models_factory[name](port_config(name, cfg))
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    hp = TRAIN_HP
    optimizer, scheduler = port_opt.make_optimizer(
        model, learning_rate=hp["lr"], weight_decay=hp["weight_decay"],
        num_warmup_steps=hp["warmup"], num_training_steps=hp["total"],
        no_decay_names=port_opt.model_no_decay_names(model), freeze_backbone=freeze_backbone)
    step = make_train_step(model, optimizer, scheduler, make_criterion(dataset), hp["clip_val"])
    tensors = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    losses, norms = [], []
    for i in range(hp["steps"]):
        loss, norm = step(tensors, step_generator(0, i))
        losses.append(float(loss))
        norms.append(float(norm))
    return model, before, losses, norms


def check_dynamics(name, frames=7, dataset="something", seed=0, freeze_backbone=False,
                   **overrides):
    """Four steps of ``name`` through both packages from the same weights:
    losses, clip norms and parameters; frozen parameters (every
    FrozenBatchNorm's, and the backbone with ``freeze_backbone``) and
    twinless ones bit-unchanged. Returns the port's model and its state
    before the steps."""
    cfg, model = jax_train_model(name, frames, freeze_backbone=freeze_backbone, **overrides)
    batch = train_batch(frames, dataset, seed)
    inputs = {k: v for k, v in batch.items() if k not in ("labels", "valid")}
    params = carried_params(name, cfg, model, inputs, seed)
    want_losses, want_norms, want_params = jax_dynamics(model, params, batch, dataset,
                                                        freeze_backbone)
    port, before, losses, norms = port_dynamics(name, cfg, params, batch, dataset, freeze_backbone)
    assert max(norms) > TRAIN_HP["clip_val"], "the clip never engaged"
    np.testing.assert_allclose(losses, want_losses, **LOSS_TOL)
    np.testing.assert_allclose(norms, want_norms, rtol=NORM_RTOL)
    want = jax_params_to_state_dict(want_params)
    twins = _twins(params)
    trainable = {n for n, p in port.named_parameters() if p.requires_grad}
    state = port.state_dict()
    for key, value in state.items():
        if key in twins and key in trainable:
            np.testing.assert_allclose(value.numpy(), want[key].numpy(), atol=PARAM_ATOL, rtol=0,
                                       err_msg=f"{name}: {key}")
        else:
            torch.testing.assert_close(value, before[key], atol=0, rtol=0, msg=f"{name}: {key}")
    frozen_bn = [k for k in state if k.rpartition(".")[0] + ".running_var" in state]
    assert bool(frozen_bn) == (name != "stlt")
    assert not any(k.rpartition(".")[0] + ".running_var" in state for k in trainable)
    return port, before


# --- the optimizer's masks --------------------------------------------------------


def _jax_mask(params, mask, names):
    """A JAX mask tree as {port parameter name: bool}, on ``names``."""
    as_arrays = jax.tree_util.tree_map(lambda p, m: np.full(np.shape(p), m, np.float32), params, mask)
    return {k: bool(v.all()) for k, v in jax_params_to_state_dict(as_arrays).items() if k in names}


@pytest.mark.parametrize("name", ["resnet3d-transformer", "cacnf"])
@pytest.mark.parametrize("kind", ["weight_decay", "frozen_stats", "frozen_backbone"])
def test_optimizer_masks_match_jax(name, kind):
    """``weight_decay_mask`` with the model's no-decay names (only
    ``TransformerResnet`` declares ``pos_embed`` and ``cls_token``; CACNF's
    decay), ``frozen_stats_mask`` (every FrozenBatchNorm's weight and bias)
    and ``frozen_backbone_mask`` (CACNF's ``backbone``), each on the
    parameters against JAX's mask on the same tree."""
    cfg, model = jax_train_model(name)
    inputs = {k: v for k, v in train_batch(7, "something", 0).items()
              if k not in ("labels", "valid")}
    params = carried_params(name, cfg, model, inputs, 0)
    port = models_factory[name](port_config(name, cfg))
    twins = _twins(params) & {n for n, _ in port.named_parameters()}
    if kind == "weight_decay":
        names = port_opt.model_no_decay_names(port)
        assert names == jax_opt.model_no_decay_names(model)
        assert set(names) == ({"pos_embed", "cls_token"} if name == "resnet3d-transformer" else set())
        got = port_opt.weight_decay_mask(port, names)
        want = _jax_mask(params, jax_opt.weight_decay_mask(params, names), twins)
    elif kind == "frozen_stats":
        got = port_opt.frozen_stats_mask(port)
        want = _jax_mask(params, jax_opt.frozen_stats_mask(params), twins)
    else:
        got = port_opt.frozen_backbone_mask(port, True)
        want = _jax_mask(params, jax_opt.frozen_backbone_mask(params, True), twins)
        assert all(port_opt.frozen_backbone_mask(port, False).values())
    assert set(got) == {n for n, _ in port.named_parameters()} and len(want) > 10
    assert {k: got[k] for k in want} == want
    if kind != "frozen_backbone" or name == "cacnf":
        assert any(want.values()) and not all(want.values())


# --- the Kinetics R3D load --------------------------------------------------------


def test_kinetics_r3d_load_matches_jax(tmp_path):
    """A fabricated Kinetics-format R3D state_dict (``conv1``, ``bn1``,
    ``layer1.0...``, an ``fc`` that is dropped, wrapped in ``state_dict``)
    loaded into every R3D trunk of a CACNF: the port's tree equals JAX's
    ``load_kinetics_r3d`` on the same file, exactly."""
    cfg, model = jax_train_model("cacnf")
    inputs = {k: v for k, v in train_batch(7, "something", 1).items()
              if k not in ("labels", "valid")}
    params = carried_params("cacnf", cfg, model, inputs, 1)
    port = models_factory["cacnf"](port_config("cacnf", cfg))
    trunk = port.backbone.appearance_branch.resnet.resnet
    names = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2", "6": "layer3", "7": "layer4"}
    gen = torch.Generator().manual_seed(3)
    kinetics = {}
    for key, value in trunk.state_dict().items():
        head, _, rest = key.partition(".")
        if value.is_floating_point():
            value = torch.randn(value.shape, generator=gen)
            if key.endswith("running_var"):
                value = value.abs() + 0.5
        kinetics[f"{names[head]}.{rest}"] = value
    kinetics["fc.weight"] = torch.randn(1139, 512, generator=gen)
    kinetics["fc.bias"] = torch.randn(1139, generator=gen)
    path = str(tmp_path / "r3d_kinetics.pth")
    torch.save({"state_dict": kinetics}, path)

    want = jax_params_to_state_dict(jax_load_kinetics_r3d(params, path))
    port.load_state_dict(jax_params_to_state_dict(params), strict=True)
    load_kinetics_r3d(port, path)
    got = port.state_dict()
    loaded = [k for k in got if ".resnet.resnet." in k and not k.endswith("num_batches_tracked")]
    assert len(loaded) > 20
    for key in _twins(params):
        torch.testing.assert_close(got[key], want[key], atol=0, rtol=0, msg=key)
    torch.testing.assert_close(got[loaded[0]], kinetics["conv1.weight"], atol=0, rtol=0)
    with pytest.raises(KeyError, match="no Kinetics R3D parameter"):
        torch.save({k: v for k, v in kinetics.items() if not k.startswith("layer4")}, path)
        load_kinetics_r3d(port, path)


# --- four-step dynamics -----------------------------------------------------------


@pytest.mark.parametrize("name,dataset", [
    ("resnet3d", "something"),
    ("resnet3d-transformer", "something"),
    ("resnet3d-transformer", "action_genome"),
    ("lcf", "something"),
])
def test_train_dynamics_match_jax(name, dataset, no_encoder_dropout):
    """Four steps under CE (Something) and once under BCE (Action Genome):
    the R3D convolutions train, every FrozenBatchNorm stays put and out of
    the clip's norm, ``TransformerResnet``'s ``pos_embed`` and ``cls_token``
    take no weight decay."""
    port, before = check_dynamics(name, dataset=dataset, seed=4)
    moved = [k for k, v in port.state_dict().items() if not torch.equal(v, before[k])]
    assert any(".resnet.0.weight" in k or k == "resnet.0.weight" for k in moved)


@pytest.mark.parametrize("name", ["cacnf", "stlt"])
def test_frozen_backbone_step_matches_jax(name, no_encoder_dropout):
    """CACNF (and STLT) with a loaded, frozen backbone: JAX runs the
    backbone deterministically and gives it zero updates outside the clip;
    the port runs it in eval mode under ``torch.no_grad`` with no gradient.
    The losses, clip norms and heads equal JAX's; the backbone and every
    FrozenBatchNorm parameter are bit-unchanged."""
    port, before = check_dynamics(name, seed=6, freeze_backbone=True,
                                  load_backbone_path="backbone.pt")
    assert not port.backbone.training and port.training
    for key, value in port.state_dict().items():
        if key.startswith("backbone."):
            torch.testing.assert_close(value, before[key], atol=0, rtol=0, msg=key)
    heads = [k for k, v in port.state_dict().items() if not torch.equal(v, before[k])]
    assert heads and not any(k.startswith("backbone.") for k in heads)


# --- the appearance train data path ---------------------------------------------


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("appearance_train"))
    paths, _, _, sizes = make_something_fixture(root, num_videos=5)
    return dict(paths, videos_path=make_video_hdf5(root, sizes, num_frames=9))


@pytest.mark.parametrize("dataset_type", ["appearance", "multimodal"])
def test_train_loader_batches_match_jax(archive, dataset_type):
    """Two shuffled train epochs through each package's Loader (per-sample
    generators seeded from (seed, epoch); the train sampler, one colour
    jitter draw and one random crop per clip): every batch, with the
    multimodal collate's layout streams and its padded last row, equals
    JAX's exactly."""
    kw = dict(dataset_name="something", train=True, layout_num_frames=4, appearance_num_frames=4,
              spatial_size=64, **archive)
    port_cfg, jax_cfg = DataConfig(**kw), jax_configs.DataConfig(**kw)
    port = Loader(datasets_factory[dataset_type](port_cfg), 2,
                  collaters_factory[dataset_type](port_cfg), shuffle=True, seed=5, workers=2)
    want = JaxLoader(jax_datasets[dataset_type](jax_cfg), 2, jax_collaters[dataset_type](jax_cfg),
                     shuffle=True, seed=5, workers=2)
    for _ in range(2):
        got_batches, want_batches = list(port), list(want)
        assert len(got_batches) == len(want_batches) == 3
        for got, ref in zip(got_batches, want_batches):
            assert set(got) == set(ref)
            for key in ref:
                np.testing.assert_array_equal(got[key], np.asarray(ref[key]), err_msg=key)
    assert got["video_frames"].shape == (2, 4, 64, 64, 3) and not got["valid"][1]
