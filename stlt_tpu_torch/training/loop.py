"""The train step and the on-device eval steps.

Own copy of ``stlt_tpu/training/loop.py`` for one device:
``make_train_step`` (:65, with its ``grad_accum``), ``make_eval_step`` (:181),
``make_eval_counts_step`` (:191), ``make_eval_probs_step`` (:226) and the two
accumulators (:251-288), which keep an epoch's counts or probabilities on the
device and fetch them once.

A train step is zero_grad -> forward in train mode -> loss -> backward ->
global-norm clip -> AdamW -> schedule step. With ``grad_accum = k > 1``
(``train --grad_accum_steps``) the forward and backward run once per
microbatch, as JAX's ``lax.scan`` does (:125-178): sample ``i`` goes to
microbatch ``i % k``; each microbatch's loss is its criterion times ``n``,
its count of valid rows, so that losses and gradients accumulate as sums;
both are divided by ``max(n_total, 1)`` before the one clip, AdamW and
schedule step, and the returned loss is the weighted mean. The
microbatches draw their dropout seeds from the step's generator in
microbatch order. Under a context mesh (``train
--context_parallel C``) every rank runs the step on its frames of the same
global batch, and after the backward each parameter of the frame-sharded
modules (every ``StltBackbone``: STLT's backbone, the fusion models' layout
branch; :func:`ring_sharded_parameters`) holds this rank's part of the
gradient, summed over the ring in f32 in one flat bucket before the clip
(JAX's GSPMD step computes the whole gradient at once). Every other
parameter (STLT's head; the fusion models' appearance branch, fusion
blocks and heads, which run replicated on the ring after the layout
stream's gather; the R3D models whole) already holds its whole gradient,
which every rank computes from the same inputs, and is not summed: a sum
would count it C times. The ranks do not always compute it to the same
bits: on the card the R3D stem's max-pool backward adds
with atomics, in no fixed order. So they are replaced by the ring's rank
0's, in one flat f32 broadcast over the ring (:func:`sync_over_ring_`).
The clip and AdamW then see the same gradients on every rank, and the
ranks' weights stay equal bit for bit.
Its random draws (every layer's
dropout seeds, the embedding-dropout masks) come from one explicit
``torch.Generator`` built from (seed, step) by :func:`step_generator`; the
global RNG is never used. Flax's ``make_rng`` stream cannot be reproduced,
so the bits differ from the JAX package's while the distribution is the same.

Under a data mesh (``train --num_processes N``) every rank holds its
contiguous rows of each global batch (``Loader(rows=...)``) and draws the
same seeds; the models hash every dropout site at the global clips
(``parallel/mesh.clip_span``), so with ``grad_accum = k`` (k dividing the
rank's B / N rows: the strided microbatch j of the global batch is then
rank-invariant, rank r holding its rows from ``r B / (N k)``) each rank
computes its part of the one process's step. Its loss is the sum over its
valid rows divided by the global batch's count of valid rows (the batch's
``VALID_TOTAL``, known on the host), every gradient and the loss are
summed over the ranks in one flat f32 bucket before the clip, and the
clip and AdamW then see the same gradients on every rank: the ranks'
weights stay equal bit for bit and differ from one process's only in the
order of sums. The accumulators sum Something's counts over the ranks and
gather Action Genome's probabilities in global order once per pass.

Under a model mesh (``train --model_parallel M``: ``parallel/sharding.py``)
the M ranks of a model group take one process's step together: each runs
the forward and backward on the same rows with its shards (the layers'
``model_sum`` and ``model_copy`` sum the row-parallel partials and the
column-parallel inputs' gradients over the group), so a sharded
parameter's gradient is the rank's shard of the whole one and a
replicated parameter's is the whole one on every rank, and neither is
summed over the group (a sum would count the replicated ones M times).
The ranks do not always compute a replicated gradient to the same bits on
the card (the R3D stem's atomics, as under a ring), so
:func:`sync_over_model_` replaces them by the group's rank 0's in one flat
broadcast after the backward; the clip's norm then adds the shards'
squares over the group (``training/optimizer.py``). Under a data axis as
well, the data group (the ranks of one model index) then sums every
gradient as above: each model index sums its own shards.

Under both (``train --num_processes D C --context_parallel C``: D rings of
C ranks, ``parallel/mesh.py``) each ring takes its data index's rows and
every rank its frames of them. After the backward the gradients are made
the ring's (the frame-sharded modules' summed over the ring, the rest its
rank 0's), then every gradient and the loss summed over the data group (the D ranks of the rank's
context index): those modules are summed over the whole grid, the rest
over the data group only (each ring's ranks hold the same replicated
gradients), and the loss is divided by the global batch's valid count. The two sums run in this one
order on every rank, the ring's sum and broadcast give each of a ring's
ranks the same bits, so every data group sums the same values: all D C ranks' weights
stay equal bit for bit. Every collective of the eval accumulators runs
over the data group, so each data row counts once.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from stlt_tpu_torch.data.loader import VALID_TOTAL
from stlt_tpu_torch.parallel.mesh import (Mesh, active_context_mesh, active_data_mesh, active_model_mesh,
                                          all_gather, all_sum, broadcast)
from stlt_tpu_torch.training.optimizer import clip_by_global_norm_


# Batch entries whose dim 1 is the layout frame axis, which a context mesh
# shards (``stlt_tpu/training/loop.py:24-48``).
FRAME_AXIS_KEYS = ("categories", "boxes", "scores", "frame_types")


def shard_frames(batch: Dict[str, torch.Tensor], context: int, index: int):
    """This context rank's frames of a global batch: (the batch with each
    FRAME_AXIS_KEYS entry cut to frames [index t, (index + 1) t), the offset
    index t), t = frames / context. Every rank builds the same global batch
    (the loader's order is deterministic) and keeps its slice."""
    frames = batch["frame_types"].shape[1]
    for key in FRAME_AXIS_KEYS:
        if key in batch and batch[key].shape[1] % context:
            raise ValueError(
                f"context_parallel={context} does not divide the frame axis ({key} has "
                f"{batch[key].shape[1]} frames). The train/inference CLIs pad via "
                "DataConfig.frames_multiple; non-CLI callers must pad the frame axis to a "
                "multiple of the context axis themselves."
            )
    t = frames // context
    out = dict(batch)
    for key in FRAME_AXIS_KEYS:
        if key in out:
            out[key] = out[key][:, index * t:(index + 1) * t]
    return out, index * t


def _model_inputs(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in batch.items() if k not in ("labels", "valid", VALID_TOTAL)}


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of train step ``step`` of a run seeded ``seed``."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def sum_grads_over_ring_(params, mesh: Mesh, loss: Optional[torch.Tensor] = None, group=None):
    """Replace each gradient of ``params`` by its sum over the ranks of
    ``group`` (``mesh.ring_group`` or ``mesh.data_group``; None: every
    rank): one all-reduce of a flat f32 bucket, ``loss`` (a device scalar)
    at its end when given, whose sum is returned. Parameters without a
    gradient (the same ones on every rank) stay without."""
    grads = [p.grad for p in params if p.grad is not None]
    parts = [g.reshape(-1).to(torch.float32) for g in grads]
    if loss is not None:
        parts.append(loss.reshape(1).to(torch.float32))
    if not parts:
        return None
    flat = all_sum(torch.cat(parts), *((mesh,) if group is None else (mesh, group)))
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return None if loss is None else flat[-1]


def ring_sharded_parameters(model):
    """The parameters whose gradient a context ring's ranks each hold in
    part: those of every ``StltBackbone`` in ``model`` (the modules that run
    frame-sharded under a context mesh), in module order. The train step
    sums these alone over the ring."""
    from stlt_tpu_torch.models.stlt import StltBackbone  # the models import this module

    return [p for module in model.modules() if isinstance(module, StltBackbone)
            for p in module.parameters()]


def sync_over_ring_(model, ring: Mesh) -> None:
    """A ring rank's gradients made the whole ring's: those of
    :func:`ring_sharded_parameters` summed over the ring, every other one
    replaced by the ring's rank 0's (one flat f32 broadcast over its
    group): see the module docstring."""
    sharded = ring_sharded_parameters(model)
    sum_grads_over_ring_(sharded, ring, group=ring.ring_group)
    ids = {id(p) for p in sharded}
    _broadcast_grads_([p.grad for p in model.parameters() if id(p) not in ids and p.grad is not None],
                      ring, ring.ring_rank(0), ring.ring_group)


def _broadcast_grads_(grads, mesh: Mesh, src: int, group) -> None:
    """Replace ``grads`` by global rank ``src``'s, in one flat f32
    broadcast over ``group``."""
    if grads:
        flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads])
        flat = broadcast(flat, mesh, src, group=group)
        torch._foreach_copy_(grads, [x.view_as(g) for x, g in zip(flat.split([g.numel() for g in grads]),
                                                                   grads)])


def sync_over_model_(model, mesh: Mesh) -> None:
    """A model rank's replicated gradients (every parameter that
    ``parallel/sharding.shard_model_`` left whole) replaced by its model
    group's rank 0's, in one flat f32 broadcast: see the module
    docstring. The sharded ones are the rank's own and stay."""
    _broadcast_grads_([p.grad for p in model.parameters()
                       if getattr(p, "model_shard_dim", None) is None and p.grad is not None],
                      mesh, mesh.model_rank(0), mesh.model_group)


def microbatches(batch: Dict[str, torch.Tensor], grad_accum: int):
    """The ``grad_accum`` strided microbatches of a batch: sample ``i`` in
    microbatch ``i % grad_accum`` (``stlt_tpu/training/loop.py:141-147``),
    each entry contiguous."""
    batch_size = batch["labels"].shape[0]
    if batch_size % grad_accum:
        raise ValueError(f"grad_accum={grad_accum} does not divide batch {batch_size}")
    return [{k: v[j::grad_accum].contiguous() for k, v in batch.items()}
            for j in range(grad_accum)]


def loss_and_grads(model, criterion: Callable, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator, grad_accum: int = 1) -> torch.Tensor:
    """The train step up to the clip: the model in train mode, its gradients
    set to None, the forward and backward of ``batch`` (``grad_accum``
    microbatches: see the module docstring), under a context mesh the
    gradients made the ring's after the last microbatch
    (:func:`sync_over_ring_`),
    then the division by the valid rows; under a data mesh
    :func:`_data_rank_loss_and_grads` (after the ring's sum, when there is
    a ring). Returns the loss, a device scalar; the gradients are in the
    parameters' ``.grad``."""
    model.train()
    model.zero_grad(set_to_none=True)
    data = active_data_mesh()
    if data is not None:
        return _data_rank_loss_and_grads(model, criterion, batch, generator, grad_accum, data)
    n = None
    if grad_accum == 1:
        logits = model(_model_inputs(batch), generator)
        loss = criterion(logits, batch["labels"], batch.get("valid"))
        loss.backward()
        loss = loss.detach()
    else:
        loss, n = 0.0, 0.0
        for micro in microbatches(batch, grad_accum):
            valid, labels = micro.get("valid"), micro["labels"]
            rows = (valid.sum(dtype=torch.float32) if valid is not None
                    else torch.tensor(float(labels.shape[0]), device=labels.device))
            part = criterion(model(_model_inputs(micro), generator), labels, valid) * rows
            part.backward()
            loss, n = loss + part.detach(), n + rows
    ring = active_context_mesh()
    if ring is not None:
        sync_over_ring_(model, ring)
    _sync_model_axis_(model)
    if n is not None:
        n = torch.clamp(n, min=1.0)
        torch._foreach_div_([p.grad for p in model.parameters() if p.grad is not None], n)
        loss = loss / n
    return loss


def _data_rank_loss_and_grads(model, criterion, batch, generator, grad_accum: int, mesh: Mesh):
    """A data rank's part of the step: each microbatch's criterion over the
    rank's valid rows divided by the global batch's valid count
    (``VALID_TOTAL``), its backward, under a ring the gradients made the
    ring's (:func:`sync_over_ring_`), then the gradients and the loss summed over the
    data group in one bucket (see the module docstring)."""
    if VALID_TOTAL not in batch:
        raise ValueError(f"a data rank's batch carries {VALID_TOTAL!r}, the valid rows of the "
                         "global batch (Loader(rows=...))")
    count = batch[VALID_TOTAL].to(torch.float32)
    batch = {k: v for k, v in batch.items() if k != VALID_TOTAL}
    loss = torch.zeros((), dtype=torch.float32, device=count.device)
    for micro in microbatches(batch, grad_accum) if grad_accum > 1 else [batch]:
        part = criterion(model(_model_inputs(micro), generator), micro["labels"],
                         micro.get("valid"), count)
        part.backward()
        loss = loss + part.detach()
    ring = active_context_mesh()
    if ring is not None:
        sync_over_ring_(model, ring)
    _sync_model_axis_(model)
    return sum_grads_over_ring_(model.parameters(), mesh, loss, group=mesh.data_group)


def _sync_model_axis_(model) -> None:
    model_mesh = active_model_mesh()
    if model_mesh is not None:
        sync_over_model_(model, model_mesh)


def make_train_step(model, optimizer, scheduler, criterion: Callable, clip_val: float,
                    grad_accum: int = 1) -> Callable:
    """Returns ``train_step(batch, generator) -> (loss, grad_norm)``, both
    device scalars: :func:`loss_and_grads`, the clip (``grad_norm`` is the
    global norm before it), AdamW and the schedule's step."""
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(batch: Dict[str, torch.Tensor], generator: torch.Generator):
        loss = loss_and_grads(model, criterion, batch, generator, grad_accum)
        grad_norm = clip_by_global_norm_(params, clip_val)
        optimizer.step()
        scheduler.step()
        return loss, grad_norm

    return train_step


def make_eval_step(model) -> Callable:
    @torch.inference_mode()
    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.eval()
        return model(_model_inputs(batch))

    return eval_step


def make_eval_counts_step(model) -> Callable:
    """Forward plus on-device top-1/top-5 correct counts of every head
    (Something metrics): two device ints per head and batch."""
    eval_step = make_eval_step(model)

    @torch.inference_mode()
    def eval_counts_step(batch: Dict[str, torch.Tensor]):
        logits = eval_step(batch)
        labels = batch["labels"].long()
        valid = batch.get("valid")
        if valid is None:
            valid = torch.ones(labels.shape, dtype=torch.bool, device=labels.device)
        counts = {}
        for name, arr in logits.items():
            k = min(5, arr.shape[-1])
            top1 = (arr.argmax(dim=-1) == labels) & valid
            top5 = (arr.topk(k, dim=-1).indices == labels[:, None]).any(dim=-1) & valid
            counts[name] = (top1.sum(), top5.sum())
        return counts

    return eval_counts_step


def make_eval_probs_step(model) -> Callable:
    """Forward plus on-device sigmoid of the ``stlt`` head (the only head the
    Action Genome evaluator reads)."""
    eval_step = make_eval_step(model)

    @torch.inference_mode()
    def eval_probs_step(batch: Dict[str, torch.Tensor]):
        probs = torch.sigmoid(eval_step(batch)["stlt"].to(torch.float32))
        valid = batch.get("valid")
        if valid is None:
            valid = torch.ones(probs.shape[0], dtype=torch.bool, device=probs.device)
        return probs, batch["labels"], valid

    return eval_probs_step


class EvalCountAccumulator:
    """Sums ``eval_counts_step`` outputs on the device; ``flush_into`` fetches
    them once."""

    def __init__(self):
        self.totals = None

    def add(self, counts) -> None:
        if self.totals is None:
            self.totals = counts
        else:
            self.totals = {k: tuple(a + b for a, b in zip(self.totals[k], counts[k]))
                           for k in counts}

    def flush_into(self, evaluator) -> None:
        """Under a data mesh the counts are first summed over the data group
        (one all-reduce), so every rank feeds the evaluator the global
        counts."""
        if self.totals is not None:
            names = list(self.totals)
            counts = torch.stack([torch.stack(self.totals[k]) for k in names])
            data = active_data_mesh()
            if data is not None:
                counts = all_sum(counts, data, data.data_group)  # exact: counts below 2**24
            counts = counts.tolist()
            evaluator.process_counts({k: tuple(pair) for k, pair in zip(names, counts)})
        self.totals = None


class EvalProbsAccumulator:
    """Keeps each batch's (probs, labels, valid) on the device; ``flush_into``
    fetches them once and feeds the evaluator."""

    def __init__(self):
        self.items = []

    def add(self, triple) -> None:
        self.items.append(triple)

    def flush_into(self, evaluator) -> None:
        """Under a data mesh every data rank's rows are gathered first (one
        all-gather each of probs, labels and valid over the data group) and
        put in global order: batch by batch, rank by rank."""
        if self.items:
            parts = [torch.cat(parts) for parts in zip(*self.items)]
            data = active_data_mesh()
            if data is not None:
                batches = len(self.items)
                parts = [_global_order(all_gather(x.to(torch.uint8) if x.dtype == torch.bool else x,
                                                  data, data.data_group).to(x.dtype), batches)
                         for x in parts]
            probs, labels, valid = (x.cpu().numpy() for x in parts)
            evaluator.process_probs(probs, labels, valid=valid)
        self.items = []


def _global_order(gathered: torch.Tensor, batches: int) -> torch.Tensor:
    """[ranks, batches * b, ...] (each rank's rows of every batch, in batch
    order) -> [batches * ranks * b, ...] in the global batches' row order."""
    ranks, rows = gathered.shape[:2]
    x = gathered.reshape(ranks, batches, rows // batches, *gathered.shape[2:])
    return x.transpose(0, 1).reshape(ranks * rows, *gathered.shape[2:])
