"""Loss functions of the train step.

Own copy of ``stlt_tpu/training/criterion.py``: cross-entropy for
Something(-Else), sigmoid BCE for Action Genome, averaged over all logit
heads, each a mean over the batch masked by the optional per-sample
``valid`` flags (the padded rows of a final partial batch do not count).
With ``count`` (a data rank's share of a global batch) each head's sum over
the rank's valid rows is divided by ``count``, the valid rows of the whole
global batch, so the ranks' losses and gradients add up to the one
process's.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F


def _masked_mean(per_sample: torch.Tensor, valid: Optional[torch.Tensor],
                 count: Optional[torch.Tensor] = None) -> torch.Tensor:
    if valid is None and count is None:
        return per_sample.mean()
    valid = torch.ones_like(per_sample) if valid is None else valid.to(per_sample.dtype)
    total = valid.sum() if count is None else count.to(per_sample.dtype)
    return (per_sample * valid).sum() / torch.clamp(total, min=1.0)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  valid: Optional[torch.Tensor] = None,
                  count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax cross-entropy with integer labels, in f32."""
    per_sample = F.cross_entropy(logits.to(torch.float32), labels.long(), reduction="none")
    return _masked_mean(per_sample, valid, count)


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                    valid: Optional[torch.Tensor] = None,
                    count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Element-wise sigmoid BCE, meaned over classes, in f32."""
    per_sample = F.binary_cross_entropy_with_logits(
        logits.to(torch.float32), labels.to(torch.float32), reduction="none"
    ).mean(dim=-1)
    return _masked_mean(per_sample, valid, count)


def make_criterion(dataset_name: str):
    loss_fn = cross_entropy if dataset_name == "something" else bce_with_logits

    def criterion(logits: Dict[str, torch.Tensor], labels: torch.Tensor,
                  valid: Optional[torch.Tensor] = None,
                  count: Optional[torch.Tensor] = None) -> torch.Tensor:
        losses = [loss_fn(v, labels, valid, count) for v in logits.values()]
        return sum(losses) / len(losses)

    return criterion
