"""Training CLI of the port.

Port of ``stlt_tpu/train.py`` (``train`` :143, ``TrainResult`` :112, ``main``
:412) for one process on one device, with the JAX package's flags
(``parser.py``) and semantics: logging that refuses to overwrite a log file,
datasets and loaders, the model config from ``num_classes =
len(val_dataset.labels)``, the criterion, AdamW over two groups with the
global-norm clip, the per-step linear warmup and decay over ``epochs x
(len(train) // batch_size)`` steps, a validation pass per epoch with
on-device counts (Something) or probabilities (Action Genome), and the best
checkpoint (and with ``--save_backbone_path`` the backbone's) saved as
flax's ``.msgpack``, the JAX package's format, when the path ends in
``.msgpack`` (the parser's default), else as a reference-format ``.pt``
state_dict (``utils/convert.save_checkpoint``); the port's ``predict`` loads
either with ``strict=True``, as ``--load_backbone_path`` reads either.

The JAX train CLI's levers: ``--grad_accum_steps k`` splits every step into
``k`` strided microbatches whose valid-row-weighted gradients are summed
before one update (``training/loop.py``; ``k`` must divide
``--batch_size``); ``--remat`` checkpoints every encoder layer, whose
forward the backward recomputes (``models/layers.TransformerEncoder``);
``--resume_dir D`` writes a step checkpoint (model, AdamW, schedule, step,
epoch) after each epoch's validation, keeps the newest three and resumes
from the newest at start (``training/checkpoint.py``; the loader's shuffle
and every step's dropout generator are keyed on the epoch and the global
step, so a resumed run takes the steps an uninterrupted one takes; the
evaluator's best score is not restored, as in JAX); ``--profile_dir P
--profile_window START,STOP`` records a ``torch.profiler`` session (CPU
activity, and CUDA on the card) from before step START to after step
STOP - 1 into a Chrome trace under ``P``, every step inside a
``train_step`` range (``stlt_tpu/train.py:157-167, 338-347``).

Every factory model trains: ``stlt`` on ``--dataset_type layout``,
``resnet3d`` and ``resnet3d-transformer`` on ``appearance``, ``lcf``,
``caf`` and ``cacnf`` on ``multimodal``. As in ``stlt_tpu/train.py:257-273``
a Kinetics R3D (``--resnet_model_path``) is loaded into every R3D trunk
first, then a ``.pt`` backbone (``--load_backbone_path``, the models with a
``backbone``: STLT and CACNF) overrides it; with ``--freeze_backbone`` too,
the backbone gets no update, stays out of the clip's norm and runs
deterministically. Every ``FrozenBatchNorm`` parameter is frozen, and the
model's ``no_weight_decay`` names (``TransformerResnet``'s ``pos_embed``
and ``cls_token``) take no weight decay.

It runs on the GPU unless ``--platform cpu`` is given; without a GPU it
raises and never falls back to the CPU. Flags of later slices raise with the
``ROADMAP.md`` item they wait for. Long clips train as they serve:
``--layout_num_frames 256`` puts the temporal attention on the short flash
kernels, ``512`` on the blockwise ones (forward and backward).
``--live_prefix`` has no effect here and says so in the log: the train
sampler fills every frame slot of every clip, so no capacity that holds for
the train set cuts anything (``configs.live_prefix_caps`` returns ``(None,
None)`` for it), and the model runs uncapped, where JAX's capacities
(``stlt_tpu/train.py:40-59``) would drop sampled frames (``ROADMAP.md``
section C).

Every model trains over N processes with ``--num_processes N --process_id
r --coordinator_address host:port`` (the data axis, ``parallel/``): each
rank loads its rows [r B / N, (r + 1) B / N) of every global batch (the
epoch order and the augmentation seeds of the whole batch, so the data
stream is the one process's), hashes every dropout site at the global
clips, and sums its gradients and loss with the other ranks' in one flat
f32 all-reduce before the clip (``training/loop.py``): N ranks take the one
process's step on the global batch, dropout included, and their weights
stay equal bit for bit. ``--grad_accum_steps k`` must divide each rank's
B / N rows. Validation sums the counts (gathers the probabilities) over the
ranks; every rank restores ``--resume_dir`` after a barrier.

Every model trains over a context ring of C processes with
``--context_parallel C --num_processes C --process_id r
--coordinator_address host:port``, as it serves (``predict``,
``parallel/``): every rank builds the same global batches (the same loader
seed, the layout frame axis padded to a multiple of C) and the same seeded
model. STLT's backbone and the fusion models' layout branch keep the
rank's frames and run the temporal attention as a ring forward and
backward (``ops/ring.py``); CAF and CACNF gather the layout stream over the
ring and run the rest replicated (``models/fusion.py``); the R3D models run
whole on every rank. Before the clip each rank sums the frame-sharded
modules' gradients over the ring and takes the ring's rank 0's for the
replicated rest (``training/loop.py``), so the ranks' weights stay equal
bit for bit; the convolutions take fixed, deterministic algorithms
(``predict.set_conv_algorithms``); validation runs the same forward. With
``--num_processes D C --context_parallel C`` it trains on a grid of D
such rings: ring d takes the rows [d B / D, (d + 1) B / D), and after the
ring's sum every gradient and the loss are summed over the data group (the
ranks of one context index), so all D C ranks take the one process's step
and keep equal weights. Only the coordinator (rank 0) writes the log file
and the checkpoints. The flags the serving CLIs refuse (a model axis, fewer
processes than C) are refused here too.

    python -m stlt_tpu_torch.train --dataset_name something --dataset_type layout \
        --model_name stlt --train_dataset_path train.json --val_dataset_path val.json \
        --labels_path labels.json --videoid2size_path sizes.json \
        --save_model_path best.pt --compute_dtype bfloat16 --use_pallas
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time
from typing import Any, Dict, List

import torch

from stlt_tpu_torch.data import collaters_factory, datasets_factory
from stlt_tpu_torch.data.loader import Loader, to_device
from stlt_tpu_torch.models import models_factory
from stlt_tpu_torch.parallel import distributed
from stlt_tpu_torch.parser import build_parser
from stlt_tpu_torch.predict import (
    build_data_config,
    build_model_config,
    loader_rows,
    set_conv_algorithms,
    start_processes,
    stop_processes,
)
from stlt_tpu_torch.predict import check_flags as check_serving_flags
from stlt_tpu_torch.training import checkpoint as ckpt
from stlt_tpu_torch.training.criterion import make_criterion
from stlt_tpu_torch.training.evaluation import evaluators_factory
from stlt_tpu_torch.training.loop import (
    EvalCountAccumulator,
    EvalProbsAccumulator,
    make_eval_counts_step,
    make_eval_probs_step,
    make_train_step,
    step_generator,
)
from stlt_tpu_torch.training.optimizer import make_optimizer, model_no_decay_names
from stlt_tpu_torch.utils.convert import load_kinetics_r3d, read_state_dict, save_checkpoint

# The factory models with a ``backbone`` (the subtree --load_backbone_path,
# --freeze_backbone and --save_backbone_path act on).
BACKBONE_MODELS = ("stlt", "cacnf")


@dataclasses.dataclass
class TrainResult:
    """What :func:`train` returns: the trained model, its optimizer, the
    number of steps taken and the per-epoch records (steps, seconds, loss,
    metrics, whether the epoch was the best)."""

    model: Any
    optimizer: Any
    step: int
    epochs: List[Dict[str, Any]]


def check_flags(args) -> None:
    """The serving CLIs' checks (``predict.check_flags``: an unknown model or
    dataset type, A9's and A10's flags, a batch the data axis does not
    divide); a backbone flag for a model without a backbone raises naming
    those that have one; ``--grad_accum_steps`` must divide ``--batch_size``
    (each data rank's share of it) and ``--profile_window`` be START,STOP
    with 0 <= START < STOP, each raised in JAX's words
    (``stlt_tpu/train.py:159-167, 291-296``)."""
    check_serving_flags(args)
    for flag in ("load_backbone_path", "save_backbone_path"):
        if getattr(args, flag) and args.model_name not in BACKBONE_MODELS:
            raise ValueError(f"--{flag} acts on a model's backbone: --model_name is one of "
                             f"{BACKBONE_MODELS}, got {args.model_name!r}")
    grad_accum = max(args.grad_accum_steps, 1)
    data = max(args.num_processes, 1) // args.context_parallel
    rows = args.batch_size // data
    if rows % grad_accum:
        per_rank = "" if data == 1 else f" / {data} data ranks = {rows} rows a rank"
        raise ValueError(f"--grad_accum_steps {grad_accum} must divide --batch_size "
                         f"{args.batch_size}{per_rank}")
    profile_window(args)


def profile_window(args):
    """(START, STOP) of ``--profile_dir``'s trace, or None without it."""
    if not args.profile_dir:
        return None
    start, stop = (int(x) for x in args.profile_window.split(","))
    if not 0 <= start < stop:
        raise ValueError(f"--profile_window must be START,STOP with 0 <= START < STOP, "
                         f"got {args.profile_window!r}")
    return start, stop


def step_profiler(args, device: torch.device, first_step: int):
    """``--profile_dir``: a ``torch.profiler`` session over global steps
    [START, STOP) of a run whose first step is ``first_step`` (CPU activity,
    and CUDA on the card), advanced by ``step()`` after each train step and
    written as the Chrome trace ``train_steps_START_STOP.json`` under the
    directory (a rank's own ``..._rankR.json`` under ``--num_processes``)
    when the window or the run ends. A resumed run past START traces
    nothing, as in JAX. Without the flag, a null context."""
    window = profile_window(args)
    if window is None or window[0] < first_step:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile, schedule

    start, stop = window
    suffix = f"_rank{args.process_id}" if args.num_processes > 1 else ""
    path = os.path.join(args.profile_dir, f"train_steps_{start}_{stop}{suffix}.json")

    def write(session):
        os.makedirs(args.profile_dir, exist_ok=True)
        session.export_chrome_trace(path)
        logging.info("Wrote profiler trace to %s", path)

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    warmup = min(start - first_step, 1)  # the step before the window readies the tracer
    return profile(activities=activities, on_trace_ready=write,
                   schedule=schedule(wait=start - first_step - warmup, warmup=warmup,
                                     active=stop - start, repeat=1))


def setup_logging(log_filepath, *, coordinator: bool = True) -> None:
    """Log to ``log_filepath`` (refusing to overwrite one) on the
    coordinator, to stderr elsewhere."""
    if log_filepath and coordinator:
        if os.path.exists(log_filepath):
            raise ValueError(f"There is a log at {log_filepath}!")
        logging.basicConfig(level=logging.INFO, filename=log_filepath, filemode="w")
    else:
        logging.basicConfig(level=logging.INFO)


def train(args) -> TrainResult:
    check_flags(args)
    setup_logging(args.log_filepath, coordinator=getattr(args, "process_id", 0) == 0)
    device = start_processes(args)
    try:
        return _train(args, device)
    finally:
        stop_processes()


def _train(args, device) -> TrainResult:
    logging.info("Device: %s", torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")
    train_cfg = build_data_config(args, train=True, dataset_path=args.train_dataset_path)
    val_cfg = build_data_config(args, train=False, dataset_path=args.val_dataset_path)
    train_dataset = datasets_factory[args.dataset_type](train_cfg)
    val_dataset = datasets_factory[args.dataset_type](val_cfg)
    num_classes = len(val_dataset.labels)
    logging.info("Training on %d, validating on %d", len(train_dataset), len(val_dataset))
    loader_kw = dict(prefetch=max(args.num_workers, 2), workers=max(args.num_workers, 1),
                     rows=loader_rows(args.batch_size))
    train_loader = Loader(train_dataset, args.batch_size, collaters_factory[args.dataset_type](train_cfg),
                          shuffle=True, seed=args.seed, **loader_kw)
    val_loader = Loader(val_dataset, args.batch_size, collaters_factory[args.dataset_type](val_cfg),
                        **loader_kw)

    if args.live_prefix:
        logging.info("--live_prefix has no effect in training: the train sampler fills every "
                     "frame slot, so the ragged levers would cut nothing")
    model_config = build_model_config(args, val_dataset, val_cfg)
    logging.info("The model's configuration is:\n%s", model_config)
    model = models_factory[args.model_name](model_config, torch.Generator().manual_seed(args.seed))
    if args.resnet_model_path:
        # Kinetics first: a loaded backbone overrides it (stlt_tpu/train.py:257-273).
        load_kinetics_r3d(model, args.resnet_model_path)
        logging.info("Loaded Kinetics R3D from %s", args.resnet_model_path)
    if args.load_backbone_path:
        model.backbone.load_state_dict(read_state_dict(args.load_backbone_path, model.backbone),
                                       strict=True)
        logging.info("Loaded backbone from %s", args.load_backbone_path)
    set_conv_algorithms(device)  # as predict: timed, or fixed and deterministic on a ring
    model = model.to(device)

    criterion = make_criterion(args.dataset_name)
    num_batches = len(train_dataset) // args.batch_size
    optimizer, scheduler = make_optimizer(
        model,
        learning_rate=args.learning_rate,
        weight_decay=args.weight_decay,
        num_warmup_steps=args.warmup_epochs * num_batches,
        num_training_steps=args.epochs * num_batches,
        no_decay_names=model_no_decay_names(model),
        freeze_backbone=bool(args.freeze_backbone and args.load_backbone_path),
    )
    train_step = make_train_step(model, optimizer, scheduler, criterion, args.clip_val,
                                 grad_accum=max(args.grad_accum_steps, 1))
    evaluator = evaluators_factory[args.dataset_name](len(val_dataset), num_classes, model.logit_names)
    # Something counts top-1/top-5 hits; Action Genome keeps probabilities.
    count_path = hasattr(evaluator, "process_counts")
    eval_counts_step = make_eval_counts_step(model)
    eval_probs_step = make_eval_probs_step(model)

    global_step, start_epoch = 0, 0
    if args.resume_dir:
        distributed.barrier()  # every rank reads the step checkpoints as they stand
        restored = ckpt.restore_train_state(args.resume_dir, model, optimizer, scheduler)
        if restored is not None:
            global_step = restored
            start_epoch = restored // max(1, len(train_loader))
            # The loader's shuffle and augmentation are keyed on (seed, epoch).
            train_loader.epoch = start_epoch
            logging.info("Resumed at step %d (epoch %d)", global_step, start_epoch)
    # Only the coordinator writes the best model and the step checkpoints.
    coordinator = distributed.is_coordinator()
    scores = args.dataset_name == "action_genome"  # flax builds score_embeddings for them only

    logging.info("Starting training...")
    records = []
    with step_profiler(args, device, global_step) as profiler:
        for epoch in range(start_epoch, args.epochs):
            epoch_start = time.time()
            # Losses stay on the device through the epoch; one fetch at its end.
            losses = []
            for batch in to_device(train_loader, device):
                with torch.profiler.record_function("train_step"):
                    loss, _ = train_step(batch, step_generator(args.seed, global_step))
                losses.append(loss)
                global_step += 1
                if profiler is not None:
                    profiler.step()
            epoch_loss = float(torch.stack(losses).mean()) if losses else 0.0
            train_seconds = time.time() - epoch_start
            logging.info("Epoch %d: train loss %.6f (%d steps, %.3fs)",
                         epoch + 1, epoch_loss, len(losses), train_seconds)

            eval_start = time.time()
            evaluator.reset()
            counts, probs = EvalCountAccumulator(), EvalProbsAccumulator()
            for batch in to_device(val_loader, device):
                if count_path:
                    counts.add(eval_counts_step(batch))
                else:
                    probs.add(eval_probs_step(batch))
            counts.flush_into(evaluator)
            probs.flush_into(evaluator)
            metrics = evaluator.evaluate()
            is_best = evaluator.is_best()
            if is_best:
                logging.info("Found new best on epoch %d!", epoch + 1)
                if coordinator:
                    save_checkpoint(args.save_model_path, model, scores=scores)
                    if args.save_backbone_path:
                        save_checkpoint(args.save_backbone_path, model.backbone, scores=scores)
            if args.resume_dir and coordinator:
                ckpt.save_train_state(args.resume_dir, global_step, epoch + 1, model, optimizer,
                                      scheduler)
            for m, v in metrics.items():
                logging.info("%s: %s", m, round(v * 100, 2))
            records.append({
                "epoch": epoch + 1,
                "global_step": global_step,
                "steps": len(losses),
                "train_seconds": round(train_seconds, 6),
                "train_loss": epoch_loss,
                "eval_seconds": round(time.time() - eval_start, 6),
                "metrics": {k: float(v) for k, v in metrics.items()},
                "is_best": is_best,
            })
    return TrainResult(model=model, optimizer=optimizer, step=global_step, epochs=records)


def main(argv=None) -> TrainResult:
    parser = build_parser("Trains a model, currently STLT, LCF, CAF, and CACNF.")
    return train(parser.parse_args(argv))


if __name__ == "__main__":
    main()
