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
  schedule).

Parameters that get no gradient (the dead ``encoder_layer`` prototype,
``score_embeddings`` without scores in the batch) stay out of the norm and
are neither updated nor decayed: the JAX parameter tree has no counterpart
of them.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch
from torch import nn


def weight_decay_mask(model: nn.Module) -> Dict[str, bool]:
    """True where weight decay applies: parameters of more than one
    dimension and not named ``*.bias`` (``stlt_tpu/training/optimizer.py:40-52``;
    STLT declares no further no-decay names)."""
    return {
        name: p.dim() > 1 and name.split(".")[-1] != "bias"
        for name, p in model.named_parameters()
    }


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
) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]:
    """AdamW over two groups and its per-step schedule. Call
    ``scheduler.step()`` after every ``optimizer.step()``."""
    mask = weight_decay_mask(model)
    params = dict(model.named_parameters())
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
