"""Evaluators of the train CLI's validation pass.

Own copy of ``stlt_tpu/training/evaluation.py`` (itself a port of the
reference's ``src/utils/evaluation.py``):

- ``EvaluatorSomething``: streaming per-head top-1/top-5 correct counts;
  ``is_best`` = the mean over all top-1 and top-5 metrics beats the running
  best.
- ``EvaluatorActionGenome``: accumulates sigmoid predictions and computes
  Charades mAP with the -inf fill for rows without ground truth; reads only
  the ``stlt`` head.

``process`` takes an optional boolean ``valid`` mask, so the padded rows of a
final partial batch do not count. ``process_counts``/``process_probs`` take
what the on-device steps of ``training/loop.py`` gathered.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


class EvaluatorSomething:
    def __init__(self, total_instances: int, total_classes: int, logit_names: Tuple[str, ...]):
        self.total_instances = total_instances
        self.total_classes = total_classes
        self.logit_names = tuple(logit_names)
        self.best_acc = 0.0
        self.reset()

    def reset(self):
        self.corrects = {}
        for name in self.logit_names:
            self.corrects[f"{name}_top1"] = 0
            self.corrects[f"{name}_top5"] = 0

    def process(self, logits: Dict[str, np.ndarray], labels: np.ndarray, valid: Optional[np.ndarray] = None):
        labels = np.asarray(labels)
        if valid is None:
            valid = np.ones(labels.shape[0], dtype=bool)
        valid = np.asarray(valid, dtype=bool)
        for name in self.logit_names:
            arr = np.asarray(logits[name])
            top1 = arr.argmax(-1) == labels
            # top-5: label among the 5 largest logits
            top5_idx = np.argpartition(-arr, kth=min(5, arr.shape[-1]) - 1, axis=-1)[:, :5]
            top5 = (top5_idx == labels[:, None]).any(axis=1)
            self.corrects[f"{name}_top1"] += int((top1 & valid).sum())
            self.corrects[f"{name}_top5"] += int((top5 & valid).sum())

    def process_counts(self, counts: Dict[str, Tuple[int, int]]):
        """Streaming path for on-device accumulated (top1, top5) correct
        counts (loop.make_eval_counts_step) — two ints per head per batch
        instead of [B, C] logits."""
        for name in self.logit_names:
            top1, top5 = counts[name]
            self.corrects[f"{name}_top1"] += int(top1)
            self.corrects[f"{name}_top5"] += int(top5)

    def evaluate(self) -> Dict[str, float]:
        metrics = {}
        for name in self.logit_names:
            metrics[f"{name}_top1_accuracy"] = (
                self.corrects[f"{name}_top1"] / self.total_instances
            )
            metrics[f"{name}_top5_accuracy"] = (
                self.corrects[f"{name}_top5"] / self.total_instances
            )
        return metrics

    def is_best(self) -> bool:
        metrics = self.evaluate()
        cur = sum(metrics.values()) / len(metrics)
        if cur > self.best_acc:
            self.best_acc = cur
            return True
        return False


class EvaluatorActionGenome:
    def __init__(self, total_instances: int, total_classes: int, logit_names: Tuple[str, ...]):
        self.total_instances = total_instances
        self.total_classes = total_classes
        self.logit_names = tuple(logit_names)
        self.best_mean_average_precision = 0.0
        self.reset()

    def reset(self):
        self.index = 0
        self.predictions = np.zeros((self.total_instances, self.total_classes))
        self.ground_truths = np.zeros((self.total_instances, self.total_classes))

    def process(self, logits: Dict[str, np.ndarray], labels: np.ndarray, valid: Optional[np.ndarray] = None):
        arr = np.asarray(logits["stlt"], dtype=np.float64)
        probs = 1.0 / (1.0 + np.exp(-arr))
        self.process_probs(probs, labels, valid=valid)

    def process_probs(self, probs: np.ndarray, labels: np.ndarray, valid: Optional[np.ndarray] = None):
        """Device-accumulation path (loop.make_eval_probs_step): sigmoid was
        already applied on device; mAP depends only on the prediction
        ORDERING, so f32-on-device vs f64-on-host sigmoid is metric-identical
        (sigmoid is monotonic)."""
        probs = np.asarray(probs, dtype=np.float64)
        labels = np.asarray(labels)
        if valid is not None:
            keep = np.asarray(valid, dtype=bool)
            probs = probs[keep]
            labels = labels[keep]
        size = probs.shape[0]
        self.predictions[self.index : self.index + size] = probs
        self.ground_truths[self.index : self.index + size] = labels
        self.index += size

    def evaluate(self) -> Dict[str, float]:
        m_ap, _, _ = charades_map(self.predictions, self.ground_truths)
        return {"map": m_ap}

    def is_best(self) -> bool:
        metrics = self.evaluate()
        if metrics["map"] > self.best_mean_average_precision:
            self.best_mean_average_precision = metrics["map"]
            return True
        return False


def mean_average_precision(submission: np.ndarray, gt: np.ndarray):
    """Per-class average precision (Charades convention: classes with no
    positives contribute NaN; the mean is over all classes including NaNs,
    matching reference evaluation.py:100-124)."""
    num_classes = submission.shape[1]
    aps = np.full(num_classes, np.nan)
    for c in range(num_classes):
        order = np.argsort(-submission[:, c])
        tp = gt[order, c] == 1
        n_pos = tp.sum()
        if n_pos < 0.1:
            continue
        cum_tp = np.cumsum(tp)
        precision = cum_tp / np.arange(1, len(tp) + 1, dtype=float)
        aps[c] = precision[tp].sum() / float(n_pos)
    m_ap = np.mean(aps)
    with np.errstate(invalid="ignore"):
        w_ap = aps * gt.sum(axis=0) / float(gt.sum())
    return m_ap, w_ap, aps


def charades_map(submission: np.ndarray, gt: np.ndarray):
    """Set predictions of rows with empty ground truth to -inf before AP
    (reference evaluation.py:127-132)."""
    fixed = submission.copy()
    fixed[gt.sum(axis=1) == 0, :] = -np.inf
    return mean_average_precision(fixed, gt)


evaluators_factory = {
    "something": EvaluatorSomething,
    "action_genome": EvaluatorActionGenome,
}
