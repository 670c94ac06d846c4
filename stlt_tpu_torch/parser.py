"""CLI flag schema of the port: ``build_parser`` copied verbatim from
``stlt_tpu/parser.py`` so the JAX package's command lines work unchanged.

In the port, ``--platform`` picks the torch device (``cpu``, or ``cuda`` by
default), ``--compute_dtype`` the compute dtype, and ``--use_pallas`` is
parsed but does not change the dispatch: a CUDA tensor always runs the
hand-written kernels (``ops/fused_encoder.py``).
"""

from __future__ import annotations

import argparse


def build_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    # --- reference-compatible flags ---
    p.add_argument("--dataset_name", type=str, default=None,
                   help="The name of the dataset, either something or action_genome")
    p.add_argument("--dataset_type", type=str, default=None,
                   help="The type of the dataset - layout, appearance or multimodal.")
    p.add_argument("--log_filepath", type=str, default=None,
                   help="Where to log the progress.")
    p.add_argument("--train_dataset_path", type=str, default=None,
                   help="Path to the train dataset.")
    p.add_argument("--val_dataset_path", type=str, default=None,
                   help="Path to the val dataset.")
    p.add_argument("--test_dataset_path", type=str, default=None,
                   help="Path to the test dataset.")
    p.add_argument("--labels_path", type=str, default=None,
                   help="Path to the labels.")
    p.add_argument("--videoid2size_path", type=str, default="data/videoid2size.json",
                   help="Path to the videoid2size json file.")
    p.add_argument("--videos_path", type=str, default=None,
                   help="Path to the videos saved as HDF5.")
    p.add_argument("--layout_num_frames", type=int, default=16,
                   help="The number of layout frames to sample per video.")
    p.add_argument("--appearance_num_frames", type=int, default=32,
                   help="The number of appearance frames to sample per video.")
    p.add_argument("--score_threshold", type=float, default=0.5,
                   help="The score threshold for the categories.")
    p.add_argument("--spatial_size", type=int, default=112,
                   help="RGB crop size (reference DataConfig knob, configs.py:28).")
    p.add_argument("--num_spatial_layers", type=int, default=4,
                   help="The number of spatial transformer layers.")
    p.add_argument("--num_temporal_layers", type=int, default=8,
                   help="The number of temporal transformer layers.")
    p.add_argument("--batch_size", type=int, default=64, help="The batch size.")
    p.add_argument("--learning_rate", type=float, default=5e-5, help="The learning rate.")
    p.add_argument("--weight_decay", type=float, default=1e-3, help="The weight decay.")
    p.add_argument("--num_workers", type=int, default=0,
                   help="The number of processor workers (prefetch depth here).")
    p.add_argument("--clip_val", type=float, default=5.0,
                   help="The gradient clipping value.")
    p.add_argument("--epochs", type=int, default=20,
                   help="The number of epochs to train the model.")
    p.add_argument("--warmup_epochs", type=int, default=2,
                   help="The number warmup epochs.")
    p.add_argument("--model_name", type=str, default=None, help="The name of the model.")
    p.add_argument("--resnet_model_path", type=str, default=None,
                   help="Path to the pre-trained ResNet3D.")
    p.add_argument("--save_model_path", type=str, default="models/best.msgpack",
                   help="Where to save the model.")
    p.add_argument("--save_backbone_path", type=str, default=None,
                   help="Where to save the STLT backbone.")
    p.add_argument("--load_backbone_path", type=str, default=None,
                   help="From where to load the STLT backbone (.msgpack or torch .pt).")
    p.add_argument("--freeze_backbone", action="store_true",
                   help="Whether to freeze the backbone.")
    p.add_argument("--features_path", type=str, default=None,
                   help="Whether to use video features. (Unused; kept for CLI parity.)")
    p.add_argument("--checkpoint_path", type=str, default="models/best.msgpack",
                   help="Checkpoint to a trained model (.msgpack or torch .pt).")
    # --- architecture overrides (hard-coded in the reference configs) ---
    p.add_argument("--hidden_size", type=int, default=768, help="Transformer width.")
    p.add_argument("--hidden_dropout_prob", type=float, default=0.1, help="Dropout rate.")
    p.add_argument("--num_attention_heads", type=int, default=12, help="Attention heads.")
    p.add_argument("--num_appearance_layers", type=int, default=4,
                   help="Appearance transformer layers.")
    p.add_argument("--num_fusion_layers", type=int, default=4,
                   help="Cross-modal fusion layers.")
    p.add_argument("--resnet_depth", type=int, default=50,
                   help="R3D depth (10/18/34/50/101/152/200).")
    # --- TPU-native flags (no reference counterpart) ---
    p.add_argument("--platform", type=str, default=None,
                   help="Force a JAX platform (e.g. cpu, tpu). Applied before "
                        "backend init; overrides JAX_PLATFORMS.")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="Tensor-parallel axis size (must divide device count).")
    p.add_argument("--grad_accum_steps", type=int, default=1,
                   help="Microbatches per optimizer step (same update as the "
                        "full batch at 1/k the activation memory).")
    p.add_argument("--context_parallel", type=int, default=1,
                   help="Sequence-parallel axis size over the layout frame dim.")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=("float32", "bfloat16"), help="Matmul/activation dtype.")
    p.add_argument("--fast_decode", action="store_true",
                   help="JPEG DCT-scaled decode (~3x faster host path; "
                        "training-safe, slightly different pixels).")
    p.add_argument("--device_normalize", action="store_true",
                   help="Ship uint8 RGB crops and normalize on device "
                        "(4x less host->device transfer; numerically identical).")
    p.add_argument("--native_decode", action="store_true",
                   help="C++ JPEG decode/resize/jitter host stage (~2x faster "
                        "appearance pipeline; resize+jitter bit-identical to PIL).")
    p.add_argument("--remat", action="store_true",
                   help="Per-layer activation rematerialization (larger train batches).")
    p.add_argument("--use_pallas", action="store_true",
                   help="Use fused Pallas attention kernels.")
    p.add_argument("--live_prefix", action="store_true",
                   help="Ragged long-context speedups: truncate the layout "
                        "frame axis to the dataset's longest live prefix "
                        "(temporal_frame_capacity) and run the spatial fold "
                        "at a static live-row capacity (both derived from "
                        "the dataset's longest clip — safe for every batch; "
                        "only help when clips are shorter than the frame "
                        "axis). Requires --use_pallas; no-op under "
                        "--context_parallel. A/B kills: STLT_FRAME_CAP=0, "
                        "STLT_LIVE_PREFIX=0.")
    p.add_argument("--seed", type=int, default=42, help="Global RNG seed.")
    # --- multi-host runtime (jax.distributed) ---
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of process 0 for jax.distributed. Setting "
                        "it alone triggers auto-discovery init (TPU pods).")
    p.add_argument("--num_processes", type=int, default=0,
                   help="Total number of training processes (0/1 = single).")
    p.add_argument("--process_id", type=int, default=0,
                   help="This process's rank in [0, num_processes).")
    p.add_argument("--resume_dir", type=str, default=None,
                   help="Orbax checkpoint dir for step checkpoints + resume.")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="If set, dump a jax.profiler trace of a few steps here.")
    p.add_argument("--profile_window", type=str, default="10,15",
                   help="START,STOP global steps for the profiler trace "
                        "(with --profile_dir). Short runs: e.g. '1,3'.")
    return p
