"""Training CLI of the port.

Port of ``stlt_tpu/train.py`` (``train`` :143, ``TrainResult`` :112, ``main``
:412) for one process on one device, with the JAX package's flags
(``parser.py``) and semantics: logging that refuses to overwrite a log file,
datasets and loaders, the model config from ``num_classes =
len(val_dataset.labels)``, the criterion, AdamW over two groups with the
global-norm clip, the per-step linear warmup and decay over ``epochs x
(len(train) // batch_size)`` steps, a validation pass per epoch with
on-device counts (Something) or probabilities (Action Genome), and the best
checkpoint saved as a reference-format ``.pt`` state_dict, which the port's
``predict`` loads with ``strict=True``.

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

    python -m stlt_tpu_torch.train --dataset_name something --dataset_type layout \
        --model_name stlt --train_dataset_path train.json --val_dataset_path val.json \
        --labels_path labels.json --videoid2size_path sizes.json \
        --save_model_path best.pt --compute_dtype bfloat16 --use_pallas
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Dict, List

import torch

from stlt_tpu_torch.data import collaters_factory, datasets_factory
from stlt_tpu_torch.data.loader import Loader, to_device
from stlt_tpu_torch.models import models_factory
from stlt_tpu_torch.parser import build_parser
from stlt_tpu_torch.predict import build_data_config, build_model_config, resolve_device
from stlt_tpu_torch.predict import check_flags as check_serving_flags
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
from stlt_tpu_torch.utils.convert import load_kinetics_r3d, read_state_dict

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
    dataset type, A9's and A10's flags); a backbone flag for a model without
    a backbone raises naming those that have one; the train flags of later
    slices raise with the ``ROADMAP.md`` item they wait for."""
    check_serving_flags(args)
    for flag in ("load_backbone_path", "save_backbone_path"):
        if getattr(args, flag) and args.model_name not in BACKBONE_MODELS:
            raise ValueError(f"--{flag} acts on a model's backbone: --model_name is one of "
                             f"{BACKBONE_MODELS}, got {args.model_name!r}")
    later = [
        (args.grad_accum_steps > 1, "--grad_accum_steps > 1", "A4 (rest) / A6"),
        (args.remat, "--remat", "A4 (rest) / A6"),
        (args.resume_dir is not None, "--resume_dir", "A4 (rest) / A9"),
        (args.profile_dir is not None, "--profile_dir", "A2"),
    ]
    for hit, flag, item in later:
        if hit:
            raise NotImplementedError(
                f"{flag} is not ported yet: it waits for ROADMAP.md item {item}"
            )
    if args.save_model_path.endswith(".msgpack"):
        raise ValueError(
            f"--save_model_path {args.save_model_path}: the port saves reference-format "
            ".pt state_dicts; give a path ending in .pt"
        )


def setup_logging(log_filepath) -> None:
    if log_filepath:
        if os.path.exists(log_filepath):
            raise ValueError(f"There is a log at {log_filepath}!")
        logging.basicConfig(level=logging.INFO, filename=log_filepath, filemode="w")
    else:
        logging.basicConfig(level=logging.INFO)


def _save(state_dict, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)


def train(args) -> TrainResult:
    check_flags(args)
    device = resolve_device(getattr(args, "platform", None))
    setup_logging(args.log_filepath)
    logging.info("Device: %s", torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")
    train_cfg = build_data_config(args, train=True, dataset_path=args.train_dataset_path)
    val_cfg = build_data_config(args, train=False, dataset_path=args.val_dataset_path)
    train_dataset = datasets_factory[args.dataset_type](train_cfg)
    val_dataset = datasets_factory[args.dataset_type](val_cfg)
    num_classes = len(val_dataset.labels)
    logging.info("Training on %d, validating on %d", len(train_dataset), len(val_dataset))
    loader_kw = dict(prefetch=max(args.num_workers, 2), workers=max(args.num_workers, 1))
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
        model.backbone.load_state_dict(read_state_dict(args.load_backbone_path), strict=True)
        logging.info("Loaded backbone from %s", args.load_backbone_path)
    if device.type == "cuda":
        # cuDNN picks its convolution algorithms for the appearance branch's
        # shapes; f32 convolutions stay f32 (no TF32), as in predict.
        torch.backends.cudnn.benchmark = True
        torch.backends.cudnn.allow_tf32 = False
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
    train_step = make_train_step(model, optimizer, scheduler, criterion, args.clip_val)
    evaluator = evaluators_factory[args.dataset_name](len(val_dataset), num_classes, model.logit_names)
    # Something counts top-1/top-5 hits; Action Genome keeps probabilities.
    count_path = hasattr(evaluator, "process_counts")
    eval_counts_step = make_eval_counts_step(model)
    eval_probs_step = make_eval_probs_step(model)

    logging.info("Starting training...")
    global_step = 0
    records = []
    for epoch in range(args.epochs):
        epoch_start = time.time()
        # Losses stay on the device through the epoch; one fetch at its end.
        losses = []
        for batch in to_device(train_loader, device):
            loss, _ = train_step(batch, step_generator(args.seed, global_step))
            losses.append(loss)
            global_step += 1
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
            _save(model.state_dict(), args.save_model_path)
            if args.save_backbone_path:
                _save(model.backbone.state_dict(), args.save_backbone_path)
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
