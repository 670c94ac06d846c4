"""Optimizer, clip and learning-rate schedule of the train step.

Own copy of the semantics of ``stlt_tpu/training/optimizer.py``
(``optax.clip_by_global_norm`` then ``optax.adamw``):

- the global-norm clip scales every gradient by ``clip / norm`` only when
  ``norm >= clip`` (optax's rule; torch's ``clip_grad_norm_`` adds 1e-6 and
  is not used);
- AdamW (b1 0.9, b2 0.999, eps 1e-8) in two parameter groups: weight decay
  where :func:`weight_decay_mask` says, none elsewhere;
- the HF linear warmup then linear decay, per step, evaluated at the step
  count before the update (``linear_warmup_decay``, as optax calls its
  schedule);
- frozen parameters (``optax.multi_transform``'s ``set_to_zero``
  partition): every ``FrozenBatchNorm``'s weight and bias
  (:func:`frozen_stats_mask`; its statistics are buffers, never updated),
  and with ``freeze_backbone`` the ``backbone`` subtree
  (:func:`frozen_backbone_mask`). JAX clips the trainable partition only,
  so :func:`make_optimizer` sets ``requires_grad_(False)`` on every frozen
  parameter: it gets no gradient, stays out of the clip's norm and is
  neither updated nor decayed.

Parameters that get no gradient (the dead ``encoder_layer`` prototype,
``score_embeddings`` without scores in the batch, the appearance branch's
dead classifiers) stay out of the norm and are neither updated nor
decayed: the JAX parameter tree has no counterpart of them.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch
from torch import nn


def model_no_decay_names(model: nn.Module) -> Tuple[str, ...]:
    """The model's declared no-weight-decay names
    (``stlt_tpu/training/optimizer.py:28``): asked of the model, never
    inferred from its name. Only ``TransformerResnet`` declares them; the
    fusion models do not, so their ``pos_embed`` and ``cls_token`` decay."""
    fn = getattr(model, "no_weight_decay", None)
    return tuple(fn()) if callable(fn) else ()


def weight_decay_mask(model: nn.Module, no_decay_names: Tuple[str, ...] = ()) -> Dict[str, bool]:
    """True where weight decay applies: parameters of more than one
    dimension, not named ``*.bias`` and not one of ``no_decay_names``
    (``stlt_tpu/training/optimizer.py:40``)."""
    return {
        name: p.dim() > 1 and name.split(".")[-1] not in ("bias", *no_decay_names)
        for name, p in model.named_parameters()
    }


def frozen_stats_mask(model: nn.Module) -> Dict[str, bool]:
    """True where the parameter is trainable; False for the weight and bias
    of every module that holds ``running_mean`` and ``running_var`` (a
    ``FrozenBatchNorm``; ``stlt_tpu/training/optimizer.py:64``)."""
    frozen = {name for name, module in model.named_modules()
              if hasattr(module, "running_mean") and hasattr(module, "running_var")}
    return {name: name.rpartition(".")[0] not in frozen for name, _ in model.named_parameters()}


def frozen_backbone_mask(model: nn.Module, frozen: bool) -> Dict[str, bool]:
    """True where the parameter is trainable; with ``frozen`` False for the
    ``backbone`` subtree (``stlt_tpu/training/optimizer.py:55``)."""
    return {name: not (frozen and name.split(".")[0] == "backbone")
            for name, _ in model.named_parameters()}


def linear_warmup_decay(num_warmup_steps: int, num_training_steps: int):
    """The schedule's factor of the base learning rate at a step count."""

    def factor(step: int) -> float:
        if step < num_warmup_steps:
            return step / max(1.0, num_warmup_steps)
        return max(0.0, (num_training_steps - step) / max(1.0, num_training_steps - num_warmup_steps))

    return factor


def make_optimizer(
    model: nn.Module,
    *,
    learning_rate: float,
    weight_decay: float,
    num_warmup_steps: int,
    num_training_steps: int,
    no_decay_names: Tuple[str, ...] = (),
    freeze_backbone: bool = False,
) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]:
    """AdamW over two groups of the trainable parameters and its per-step
    schedule; the frozen ones (FrozenBatchNorm, and the ``backbone`` with
    ``freeze_backbone``) are set ``requires_grad_(False)``. Call
    ``scheduler.step()`` after every ``optimizer.step()``."""
    mask = weight_decay_mask(model, no_decay_names)
    stats, backbone = frozen_stats_mask(model), frozen_backbone_mask(model, freeze_backbone)
    params = {}
    for name, p in model.named_parameters():
        if stats[name] and backbone[name]:
            params[name] = p
        else:
            p.requires_grad_(False)
    groups = [
        {"params": [params[n] for n in params if mask[n]], "weight_decay": weight_decay},
        {"params": [params[n] for n in params if not mask[n]], "weight_decay": 0.0},
    ]
    optimizer = torch.optim.AdamW(groups, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, linear_warmup_decay(num_warmup_steps, num_training_steps)
    )
    return optimizer, scheduler


@torch.no_grad()
def clip_by_global_norm_(params: Iterable[torch.Tensor], clip: float) -> torch.Tensor:
    """Scale the gradients of ``params`` in place by ``clip / norm`` when
    their global norm reaches ``clip``; returns the norm before clipping, on
    the gradients' device (no host sync)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    factor = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
    torch._foreach_mul_(grads, factor)
    return norm
