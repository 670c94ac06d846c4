"""Evaluation CLI of the port.

Port of ``stlt_tpu/inference.py`` (:48-170) for one process on one device,
for every factory model (the multimodal ones on ``--dataset_type
multimodal``, evaluated on each of their heads): the test dataset and
loader, the model config (``position_table_rows``, and with
``--live_prefix --use_pallas`` the ragged capacities, as JAX gates them),
the checkpoint load (``strict=True``, then ``strict=False`` with a
warning), the on-device eval steps with their accumulators (top-1/top-5
counts for Something, probabilities for Action Genome), and the metrics
logged x100 to two decimals and returned.

It runs on the GPU unless ``--platform cpu`` is given; without a GPU it
raises and never falls back to the CPU. Checkpoints are reference-format
``.pt`` state_dicts. Under ``--num_processes N`` (the data axis) each rank
evaluates its rows of every global batch and the accumulators sum the
counts, or gather the probabilities in global order, over the ranks, so
the metrics cover every rank's rows. Every model evaluates under
``--context_parallel C --num_processes C`` as ``predict`` serves it (STLT's
backbone and the fusion models' layout branch frame-sharded, the rest
replicated), the accumulators on the coordinator only (every rank has the
same logits), and on a grid (``--num_processes D C``) over each rank's
data group, so every row counts once.
The coordinator logs and returns the metrics; the other ranks return an
empty dict.

    python -m stlt_tpu_torch.inference --dataset_name something --dataset_type layout \\
        --model_name stlt --test_dataset_path val.json --labels_path labels.json \\
        --videoid2size_path sizes.json --checkpoint_path best.pt \\
        --layout_num_frames 512 --compute_dtype bfloat16 --use_pallas --live_prefix
"""

from __future__ import annotations

import logging
from typing import Dict

from stlt_tpu_torch.configs import live_prefix_caps
from stlt_tpu_torch.data import collaters_factory, datasets_factory
from stlt_tpu_torch.data.loader import Loader, to_device
from stlt_tpu_torch.parallel import distributed
from stlt_tpu_torch.parallel.mesh import active_data_mesh
from stlt_tpu_torch.parser import build_parser
from stlt_tpu_torch.predict import (
    build_data_config,
    build_model_config,
    check_flags,
    load_served_model,
    loader_rows,
    start_processes,
    stop_processes,
)
from stlt_tpu_torch.training.evaluation import evaluators_factory
from stlt_tpu_torch.training.loop import (
    EvalCountAccumulator,
    EvalProbsAccumulator,
    make_eval_counts_step,
    make_eval_probs_step,
)


def inference(args) -> Dict[str, float]:
    check_flags(args)
    return distributed.run_ranks(args, _inference_rank)


def _inference_rank(args) -> Dict[str, float]:
    """One rank of :func:`inference` (``parallel/distributed.run_ranks``)."""
    device = start_processes(args)
    try:
        return evaluate(args, device)
    finally:
        stop_processes()


def evaluate(args, device) -> Dict[str, float]:
    """The metrics of ``args``' test set on ``device`` (this rank's, under
    ``--num_processes``; {} on every rank but the coordinator)."""
    data_cfg = build_data_config(args, train=False, dataset_path=args.test_dataset_path)
    test_dataset = datasets_factory[args.dataset_type](data_cfg)
    logging.info("Inference on %d", len(test_dataset))
    loader = Loader(
        test_dataset,
        args.batch_size,
        collaters_factory[args.dataset_type](data_cfg),
        prefetch=max(args.num_workers, 2),
        workers=max(args.num_workers, 1),
        rows=loader_rows(args.batch_size),
    )
    num_classes = len(test_dataset.labels)
    # --live_prefix: frame-axis truncation and the spatial live-prefix fold,
    # both bounded by the dataset's longest clip (so every batch fits).
    live_cap, frame_cap = live_prefix_caps(args, (test_dataset, data_cfg))
    model_config = build_model_config(args, test_dataset, data_cfg, spatial_live_capacity=live_cap,
                                      temporal_frame_capacity=frame_cap)
    logging.info("The model's configuration is:\n%s", model_config)
    model = load_served_model(args, model_config, device)

    evaluator = evaluators_factory[args.dataset_name](len(test_dataset), num_classes,
                                                      model.logit_names)
    logging.info("Starting inference...")
    # Something counts top-1/top-5 hits; Action Genome keeps probabilities.
    count_path = hasattr(evaluator, "process_counts")
    eval_step = make_eval_counts_step(model) if count_path else make_eval_probs_step(model)
    acc = EvalCountAccumulator() if count_path else EvalProbsAccumulator()
    coordinator = distributed.is_coordinator()
    # Data ranks each hold their rows (the flush sums or gathers them on
    # every rank); ring ranks hold the same logits (the coordinator's count).
    accumulate = coordinator or active_data_mesh() is not None
    for batch in to_device(loader, device):
        out = eval_step(batch)  # every rank runs the forward: the ring needs all of them
        if accumulate:
            acc.add(out)
    if accumulate:
        acc.flush_into(evaluator)
    if not coordinator:
        return {}
    metrics = evaluator.evaluate()
    logging.info("The metrics are:")
    for m, v in metrics.items():
        logging.info("%s: %s", m, round(v * 100, 2))
    return metrics


def main(argv=None) -> Dict[str, float]:
    parser = build_parser("Inference with a model, currently STLT, LCF, CAF, and CACNF.")
    return inference(parser.parse_args(argv))


if __name__ == "__main__":
    main()
