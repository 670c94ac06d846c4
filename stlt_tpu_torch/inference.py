"""Evaluation CLI of the port.

Port of ``stlt_tpu/inference.py`` (:48-170) for one process on one device:
the test dataset and loader, the model config (``position_table_rows``, and
with ``--live_prefix --use_pallas`` the ragged capacities, as JAX gates
them), the checkpoint load (``strict=True``, then ``strict=False`` with a
warning), the on-device eval steps with their accumulators (top-1/top-5
counts for Something, probabilities for Action Genome), and the metrics
logged x100 to two decimals and returned.

It runs on the GPU unless ``--platform cpu`` is given; without a GPU it
raises and never falls back to the CPU. Checkpoints are reference-format
``.pt`` state_dicts.

    python -m stlt_tpu_torch.inference --dataset_name something --dataset_type layout \\
        --model_name stlt --test_dataset_path val.json --labels_path labels.json \\
        --videoid2size_path sizes.json --checkpoint_path best.pt \\
        --layout_num_frames 512 --compute_dtype bfloat16 --use_pallas --live_prefix
"""

from __future__ import annotations

import logging
from typing import Dict

from stlt_tpu_torch.configs import (
    category2id_for,
    live_prefix_caps,
    make_model_config,
    position_table_rows,
)
from stlt_tpu_torch.data import collaters_factory, datasets_factory
from stlt_tpu_torch.data.loader import Loader, to_device
from stlt_tpu_torch.models import models_factory
from stlt_tpu_torch.parser import build_parser
from stlt_tpu_torch.predict import build_data_config, resolve_device
from stlt_tpu_torch.training.evaluation import evaluators_factory
from stlt_tpu_torch.training.loop import (
    EvalCountAccumulator,
    EvalProbsAccumulator,
    make_eval_counts_step,
    make_eval_probs_step,
)
from stlt_tpu_torch.utils.convert import load_checkpoint


def check_flags(args) -> None:
    """Flags of later slices raise with the ``ROADMAP.md`` item they wait for."""
    later = [
        (args.dataset_type != "layout", "--dataset_type other than layout", "A7/A8"),
        (args.model_name != "stlt", "--model_name other than stlt", "A7/A8"),
        (args.model_parallel > 1 or args.context_parallel > 1,
         "--model_parallel/--context_parallel > 1", "A9"),
        (args.num_processes > 1 or args.coordinator_address is not None,
         "--num_processes/--coordinator_address", "A9"),
    ]
    for hit, flag, item in later:
        if hit:
            raise NotImplementedError(f"{flag} is not ported yet: it waits for ROADMAP.md item {item}")


def inference(args) -> Dict[str, float]:
    check_flags(args)
    device = resolve_device(getattr(args, "platform", None))
    logging.basicConfig(level=logging.INFO)
    data_cfg = build_data_config(args, train=False, dataset_path=args.test_dataset_path)
    test_dataset = datasets_factory[args.dataset_type](data_cfg)
    logging.info("Inference on %d", len(test_dataset))
    loader = Loader(
        test_dataset,
        args.batch_size,
        collaters_factory[args.dataset_type](data_cfg),
        prefetch=max(args.num_workers, 2),
        workers=max(args.num_workers, 1),
    )
    num_classes = len(test_dataset.labels)
    # --live_prefix: frame-axis truncation and the spatial live-prefix fold,
    # both bounded by the dataset's longest clip (so every batch fits).
    live_cap, frame_cap = live_prefix_caps(args, (test_dataset, data_cfg))
    model_config = make_model_config(
        args.model_name,
        num_classes=num_classes,
        layout_num_frames=position_table_rows(data_cfg),
        unique_categories=len(category2id_for(args.dataset_name)),
        num_spatial_layers=args.num_spatial_layers,
        num_temporal_layers=args.num_temporal_layers,
        hidden_size=args.hidden_size,
        hidden_dropout_prob=args.hidden_dropout_prob,
        num_attention_heads=args.num_attention_heads,
        compute_dtype=args.compute_dtype,
        use_pallas=args.use_pallas,
        remat=args.remat,
        spatial_live_capacity=live_cap,
        temporal_frame_capacity=frame_cap,
    )
    logging.info("The model's configuration is:\n%s", model_config)
    model = models_factory[args.model_name](model_config)
    load_checkpoint(args.checkpoint_path, model)
    model = model.to(device).eval()

    evaluator = evaluators_factory[args.dataset_name](len(test_dataset), num_classes,
                                                      model.logit_names)
    logging.info("Starting inference...")
    # Something counts top-1/top-5 hits; Action Genome keeps probabilities.
    count_path = hasattr(evaluator, "process_counts")
    eval_step = make_eval_counts_step(model) if count_path else make_eval_probs_step(model)
    acc = EvalCountAccumulator() if count_path else EvalProbsAccumulator()
    for batch in to_device(loader, device):
        acc.add(eval_step(batch))
    acc.flush_into(evaluator)
    metrics = evaluator.evaluate()
    logging.info("The metrics are:")
    for m, v in metrics.items():
        logging.info("%s: %s", m, round(v * 100, 2))
    return metrics


def main(argv=None) -> Dict[str, float]:
    parser = build_parser("Inference with a model, currently STLT.")
    return inference(parser.parse_args(argv))


if __name__ == "__main__":
    main()
