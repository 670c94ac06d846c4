"""``--grad_accum_steps``: the port's microbatched train step
(``stlt_tpu_torch/training/loop.py::make_train_step(grad_accum=k)``, plain
versions on the CPU) against the JAX package's
``stlt_tpu.training.loop.make_train_step(grad_accum=k)`` and against its own
one-microbatch step.

Four f32 AdamW steps at k = 2 from the same weights on the same batch:
STLT on a batch with a padded row (``valid`` False; the strided split puts
it in the second microbatch) and on one without, at
``tests/test_torch_train.py``'s hyperparameters (a clip that engages, a
learning rate at which one schedule step of difference moves the
parameters far past the tolerance); and LCF with weights carried from a
seeded port model into JAX's tree
(``tests/test_torch_fusion.py::carried_params``) on four clips of
``tests/test_torch_appearance_train.py``'s batch (the last padded) at its
hyperparameters (a learning rate of 3e-4, 0 at the first step). Dropout 0
in both packages. Losses, clip norms and parameters within 1e-5 (losses
and norms relative 1e-5 too): the same f32 functions, with the
per-microbatch sums taken in another order. LCF's first gradients are also
held against JAX's microbatch sum at k = 2 within 1e-5.

LCF's fourth step is held to limits set from readings: its forward puts
one input of a ReLU in the R3D's second stage (128 channels), 4.3e-7 from
0, on the other side of 0 at k = 2 than at k = 1 (the stage's f32 sums,
taken over microbatches of two clips, differ from the whole batch's by up
to 5e-6), which opens or closes that unit's gradient path: the step's R3D
convolution gradients differ by up to 1.05e-3, the clip norm by 3.1e-5
relative, the updated weights by up to 1.1e-4 (JAX's k = 2 and k = 1 keep
the input on one side; the first three steps agree within 4.8e-7). A
non-dividing k is refused in JAX's words, by the CLI's flag check and by
the step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlt_tpu.configs import StltModelConfig as JaxStltConfig
from stlt_tpu.models import models_factory as jax_models
from stlt_tpu.training import optimizer as jax_opt
from stlt_tpu.training.criterion import make_criterion as jax_make_criterion
from stlt_tpu.training.loop import create_train_state, make_train_step as jax_make_train_step
from stlt_tpu_torch import train as port_train
from stlt_tpu_torch.configs import StltModelConfig
from stlt_tpu_torch.models import models_factory
from stlt_tpu_torch.parser import build_parser
from stlt_tpu_torch.training import optimizer as port_opt
from stlt_tpu_torch.training.criterion import make_criterion
from stlt_tpu_torch.training.loop import (
    loss_and_grads,
    make_train_step,
    microbatches,
    step_generator,
)
from stlt_tpu_torch.utils.convert import jax_params_to_state_dict
from tests.test_torch_appearance_train import NUM_CLASSES as APPEARANCE_CLASSES
from tests.test_torch_appearance_train import TRAIN_HP as APPEARANCE_HP
from tests.test_torch_appearance_train import (  # noqa: F401 (no_encoder_dropout: a fixture)
    _twins,
    carried_params,
    jax_train_model,
    no_encoder_dropout,
    port_config,
)
from tests.test_torch_fusion import model_inputs
from tests.test_torch_train import CATEGORIES, MODEL_KW, NUM_CLASSES, TRAIN_HP, _batch

TOL = 1e-5
GRAD_ACCUM = 2
# LCF's fourth step (module docstring): the weights within twice the 1.1e-4
# read, the clip norm within three times the 3.1e-5 relative.
LCF_FOURTH_STEP_ATOL, LCF_FOURTH_NORM_RTOL = 2e-4, 1e-4


def _stlt_case(padded: bool):
    batch = _batch("something")
    if not padded:
        batch["valid"] = np.ones_like(batch["valid"])
    cfg = JaxStltConfig(num_classes=NUM_CLASSES["something"],
                        unique_categories=CATEGORIES["something"], **MODEL_KW)
    model = jax_models["stlt"](cfg)
    inputs = {k: v for k, v in batch.items() if k not in ("labels", "valid")}
    params = model.init(jax.random.PRNGKey(0), inputs)["params"]
    port_cfg = StltModelConfig(num_classes=NUM_CLASSES["something"],
                               unique_categories=CATEGORIES["something"], **MODEL_KW)
    return "stlt", port_cfg, model, params, batch, TRAIN_HP


def _lcf_case():
    """LCF on four clips of the appearance harness's batch (its
    ``train_batch`` with one clip more), the last padded."""
    cfg, model = jax_train_model("lcf")
    clips = 4
    batch = model_inputs(7, (3, 7), 4, clips=clips)
    batch["labels"] = np.random.default_rng(6).integers(0, APPEARANCE_CLASSES, clips).astype(np.int32)
    batch["valid"] = np.arange(clips) < clips - 1
    inputs = {k: v for k, v in batch.items() if k not in ("labels", "valid")}
    params = carried_params("lcf", cfg, model, inputs, seed=4)
    return "lcf", port_config("lcf", cfg), model, params, batch, APPEARANCE_HP


@functools.lru_cache(maxsize=None)
def _case(which: str):
    return _lcf_case() if which == "lcf" else _stlt_case(padded=which == "stlt padded")


@functools.lru_cache(maxsize=None)
def _jax_step(name: str):
    """(optimizer, jitted train step at GRAD_ACCUM) of JAX's ``name`` case:
    one compile for the cases that share a model."""
    _, _, model, params, _, hp = _case(name)
    tx = jax_opt.make_optimizer(params, learning_rate=hp["lr"], weight_decay=hp["weight_decay"],
                                clip_val=hp["clip_val"], num_warmup_steps=hp["warmup"],
                                num_training_steps=hp["total"],
                                no_decay_names=jax_opt.model_no_decay_names(model))
    return tx, jax.jit(jax_make_train_step(model, tx, jax_make_criterion("something"),
                                           grad_accum=GRAD_ACCUM))


@functools.lru_cache(maxsize=None)
def _jax_steps(which: str):
    """JAX's per-step losses and its parameters after each step (as the
    port's state_dict)."""
    _, _, _, params, batch, hp = _case(which)
    tx, step = _jax_step("lcf" if which == "lcf" else "stlt padded")
    state = create_train_state(params, tx)
    losses, states = [], []
    for _ in range(hp["steps"]):
        state, loss = step(state, batch, np.uint32(7))
        losses.append(float(loss))
        states.append(jax_params_to_state_dict(state.params))
    return losses, states


def _jax_first_grads(which: str):
    """JAX's gradients of the first step at GRAD_ACCUM: its microbatch sum
    (``stlt_tpu/training/loop.py:86-168``, strided, each microbatch's
    criterion times its valid rows, the sum over the valid rows), as the
    port's state_dict."""
    _, _, model, params, batch, _ = _case(which)
    criterion = jax_make_criterion("something")

    @jax.jit
    def loss_sum_grads(params, micro):
        inputs = {k: v for k, v in micro.items() if k not in ("labels", "valid")}
        rows = micro["valid"].sum().astype(jnp.float32)
        return jax.grad(lambda p: criterion(model.apply({"params": p}, inputs, deterministic=True),
                                            micro["labels"], micro["valid"]) * rows)(params), rows

    total, rows = None, 0.0
    for j in range(GRAD_ACCUM):
        grads, n = loss_sum_grads(params, {k: np.asarray(v)[j::GRAD_ACCUM] for k, v in batch.items()})
        total = grads if total is None else jax.tree_util.tree_map(jnp.add, total, grads)
        rows += float(n)
    return jax_params_to_state_dict(jax.tree_util.tree_map(lambda g: g / max(rows, 1.0), total))


@functools.lru_cache(maxsize=None)
def _port_steps(which: str, grad_accum: int):
    """The port's per-step losses and clip norms, its parameters with a JAX
    twin after each step, its first step's gradients and its whole state
    before the last step."""
    name, cfg, _, params, batch, hp = _case(which)
    model = models_factory[name](cfg)
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    optimizer, scheduler = port_opt.make_optimizer(
        model, learning_rate=hp["lr"], weight_decay=hp["weight_decay"],
        num_warmup_steps=hp["warmup"], num_training_steps=hp["total"],
        no_decay_names=port_opt.model_no_decay_names(model))
    criterion = make_criterion("something")
    step = make_train_step(model, optimizer, scheduler, criterion, hp["clip_val"],
                           grad_accum=grad_accum)
    tensors = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    twins = _twins(params) & {n for n, p in model.named_parameters() if p.requires_grad}
    loss_and_grads(model, criterion, tensors, step_generator(0, 0), grad_accum)
    first_grads = {n: p.grad.clone() for n, p in model.named_parameters() if n in twins}
    losses, norms, states = [], [], []
    for i in range(hp["steps"]):
        if i == hp["steps"] - 1:
            before_last = {k: v.clone() for k, v in model.state_dict().items()}
        loss, norm = step(tensors, step_generator(0, i))
        losses.append(float(loss))
        norms.append(float(norm))
        states.append({k: v.clone() for k, v in model.state_dict().items() if k in twins})
    return losses, norms, states, first_grads, before_last


def _assert_params(got, want, atol, label):
    assert set(got) <= set(want) and got
    for key in got:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), atol=atol, rtol=0,
                                   err_msg=f"{label}: {key}")


@pytest.mark.parametrize("which", ["stlt padded", "stlt unpadded", "lcf"])
def test_grad_accum_dynamics_match_jax_and_one_microbatch(which, no_encoder_dropout):
    """k = 2 against JAX's ``grad_accum=2`` and the port's k = 1: losses,
    clip norms and every parameter with a JAX twin within 1e-5 after each
    step (LCF's fourth: see the module docstring); the clip engages."""
    hp = _case(which)[5]
    want_losses, want_states = _jax_steps(which)
    losses, norms, states, _, _ = _port_steps(which, GRAD_ACCUM)
    one_losses, one_norms, one_states, _, _ = _port_steps(which, 1)
    assert max(norms) > hp["clip_val"], "the clip never engaged"
    np.testing.assert_allclose(losses, want_losses, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(losses, one_losses, atol=TOL, rtol=TOL)
    held = hp["steps"] - (which == "lcf")
    np.testing.assert_allclose(norms[:held], one_norms[:held], atol=TOL, rtol=TOL)
    for i in range(hp["steps"]):
        atol = TOL if i < held else LCF_FOURTH_STEP_ATOL
        _assert_params(states[i], want_states[i], atol, f"{which}, step {i + 1}, against JAX")
        _assert_params(states[i], one_states[i], atol, f"{which}, step {i + 1}, against k = 1")
    if held < hp["steps"]:
        np.testing.assert_allclose(norms[held:], one_norms[held:], rtol=LCF_FOURTH_NORM_RTOL)


def test_lcf_first_gradients_match_jax_grad_accum(no_encoder_dropout):
    """LCF's first step at k = 2: every gradient with a JAX twin against
    JAX's microbatch sum within 1e-5."""
    grads = _port_steps("lcf", GRAD_ACCUM)[3]
    _assert_params(grads, _jax_first_grads("lcf"), TOL, "lcf, first gradients")


def test_lcf_fourth_step_parts_at_one_relu_input_next_to_zero(monkeypatch, no_encoder_dropout):
    """The cause of LCF's fourth-step limit: after three steps at k = 2 and
    at k = 1, the fourth forward's ReLU inputs (the R3D's and the appearance
    encoder's; k = 2: its two strided microbatches, put back in batch order)
    lie on the same side of 0 as k = 1's everywhere but at one input at
    most, which is within 1e-6 of 0."""
    name, cfg, _, _, batch, hp = _case("lcf")
    tensors = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    relu, seen = torch.nn.functional.relu, []

    def keep(x, *args, **kw):
        seen.append(x.detach().clone())
        return relu(x, *args, **kw)

    inputs = {}
    for k in (1, GRAD_ACCUM):
        model = models_factory[name](cfg)
        model.load_state_dict(_port_steps("lcf", k)[4], strict=True)
        model.train()
        monkeypatch.setattr(torch.nn.functional, "relu", keep)
        parts = []
        with torch.no_grad():
            for micro in microbatches(tensors, k):
                seen.clear()
                model({n: v for n, v in micro.items() if n not in ("labels", "valid")},
                      step_generator(0, hp["steps"] - 1))
                parts.append(list(seen))
        monkeypatch.setattr(torch.nn.functional, "relu", relu)
        whole = []
        for site in zip(*parts):  # each microbatch's rows back at rows j, j + k, ...
            x = torch.empty((sum(p.shape[0] for p in site), *site[0].shape[1:]))
            for j, p in enumerate(site):
                x[j::k] = p
            whole.append(x)
        inputs[k] = whole
    assert len(inputs[1]) == len(inputs[GRAD_ACCUM]) > 0
    crossed = torch.cat([a[(a > 0) != (b > 0)].flatten()
                         for a, b in zip(inputs[1], inputs[GRAD_ACCUM])])
    assert crossed.numel() <= 1 and bool((crossed.abs() < 1e-6).all()), crossed


def test_a_padded_row_counted_is_caught(no_encoder_dropout):
    """The padded STLT case with its padded row counted as valid (the
    second microbatch weighted 2 where JAX weights it 1) moves the
    parameters past the tolerance: the check sees the valid-row weights."""
    name, cfg, _, params, batch, hp = _case("stlt padded")
    want = _jax_steps("stlt padded")[1][-1]
    model = models_factory[name](cfg)
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    optimizer, scheduler = port_opt.make_optimizer(
        model, learning_rate=hp["lr"], weight_decay=hp["weight_decay"],
        num_warmup_steps=hp["warmup"], num_training_steps=hp["total"],
        no_decay_names=port_opt.model_no_decay_names(model))
    step = make_train_step(model, optimizer, scheduler, make_criterion("something"),
                           hp["clip_val"], grad_accum=GRAD_ACCUM)
    counted = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    counted["valid"] = torch.ones_like(counted["valid"])
    for i in range(hp["steps"]):
        step(counted, step_generator(0, i))
    held = _twins(params) & dict(model.named_parameters()).keys()
    moved = max(float((model.state_dict()[k] - want[k]).abs().max()) for k in want if k in held)
    assert moved > 10 * TOL


def test_microbatches_are_strided():
    batch = {"labels": torch.arange(6), "x": torch.arange(12).reshape(6, 2)}
    parts = microbatches(batch, 3)
    assert [p["labels"].tolist() for p in parts] == [[0, 3], [1, 4], [2, 5]]
    assert parts[1]["x"].tolist() == [[2, 3], [8, 9]] and parts[1]["x"].is_contiguous()


def test_a_non_dividing_grad_accum_is_refused():
    args = build_parser("test").parse_args(
        ["--dataset_name", "something", "--dataset_type", "layout", "--model_name", "stlt",
         "--batch_size", "6", "--grad_accum_steps", "4"])
    with pytest.raises(ValueError, match="--grad_accum_steps 4 must divide --batch_size 6"):
        port_train.check_flags(args)
    with pytest.raises(ValueError, match="grad_accum=4 does not divide batch 6"):
        microbatches({"labels": torch.zeros(6)}, 4)
