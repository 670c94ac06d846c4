#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``stlt_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. print the card's name and power limit, build every kernel from
   ``stlt_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel);
2. hold each kernel against its plain PyTorch version on the card, in bf16
   and f32, at the shapes the main paths give it (spatial: rows = B*17,
   T = 8, ragged ``rows_live``; temporal: rows = B, T = 17, causal plus
   padding bias, ragged ``tokens_live``; the eval attention and both train
   kernels also at T = 33, the 32-frame temporal stage), and time kernel,
   plain version and a composition of PyTorch library calls (a yardstick
   only) with CUDA events: the eval kernels at B = 64 and 1024, the train
   kernels (dropout 0.1 and 0) at B = 64 and, in bf16, 512; and the two
   long-clip attention kernels: the short one at T = 65, 257 and 512 (causal
   plus padding bias), the blockwise one at T = 513 and 1025 (ragged
   kv_lengths with 1 and T among them), timed at B = 64, T = 257 and
   B = 32, T = 513 against ``scaled_dot_product_attention``; then the
   long-clip train kernels: both forwards' dropout variants (rate 0.1 and
   0.5, the short one with its lse) and both backwards against
   ``attention_bwd_plain`` (T = 65, 257, 512 and 513, 1025; full and ragged
   lengths; dropout 0 and 0.1; dead rows, NaN and determinism checks), timed
   at B = 32, T = 257 and B = 16, T = 513 against the autograd backward of
   ``scaled_dot_product_attention``; then the fused train tail's forward and
   three backward kernels against their plain versions at 2,056 tokens (bf16
   and f32, dropout 0 and 0.1, GELU with full and ragged live tokens, ReLU
   with ragged ones, a 1e30 cotangent on dead tokens; dead outputs zero, no
   NaN, two launches bit-identical) and at 8,224 ragged tokens (three
   splits of the weight products), then checked the same way and timed at
   the 256-frame step's shapes (65,792 spatial and 8,224 temporal tokens:
   264 row blocks, 17 and 3 splits) and at the 17-frame B = 512 spatial
   shape (69,632 tokens) against its plain version, the
   autograd of ``F.dropout``/``F.layer_norm``/``F.linear``/``F.gelu`` (the
   backward's once, rows 12-14 jointly) and its bound, with the op-level
   A/B of the fused op against the layer's plain chain; then the fusion
   models' kernels: ``fused_cross_attention`` at (T, S) = (17, 33), (33,
   17), (8, 64) and (64, 8), with and without a key-padding bias, at B = 64
   and 1024, against ``F.linear`` + ``scaled_dot_product_attention`` +
   ``F.linear``; the blockwise kernel's dense-bias mode at 513 x 513 (a
   causal+padding bias, with and without the causal flag), 513 x 33 (no
   bias) and 33 x 513 (key padding) at B = 16 and 32, out and lse, against
   ``scaled_dot_product_attention`` with the same mask; and the layer
   tail's ReLU / eps 1e-5 variant (the appearance encoder) at T = 33; then
   the fusion models' train-path attention: the short kernel's dropout
   forward and its backward at the train cross-attention's (T, S) = (17,
   33) and (33, 17), B = 32, and the blockwise kernels' dense-bias mode at
   the same four cases as the forward's, B = 16 and 32, dropout 0 and 0.1:
   the forward with dropout, and the backward against
   ``attention_bwd_plain`` (two launches bit-identical), timed at B = 16
   against the autograd backward of ``scaled_dot_product_attention``;
3. write a synthetic Something-Else dataset, save a randomly initialised
   full-width bf16 STLT as a reference-format ``.pt`` and serve it with
   ``python -m stlt_tpu_torch.predict``'s entry point (3 batches of 64 clips,
   ragged lengths): the row count, finite scores and the launch counts are
   asserted, and one batch's logits are held against the plain path on the
   card;
4. train a full-width bf16 STLT (dropout 0.1, learning rate 1e-3) with
   ``python -m stlt_tpu_torch.train``'s entry point: 256 train and 64
   validation clips, batch 64, 2 epochs, so 8 AdamW steps and 2 validation
   passes. Finite losses, two epoch records, a best ``.pt`` that loads with
   ``strict=True``, and the launch counts (each train kernel 12 per step,
   each eval kernel 12 per validation batch, no train-tail kernel: below 256
   frames the tail is the plain chain) are asserted. Then one train
   step from the same weights, batch and seeds, kernels against the plain
   path on the card: loss and gradients, and the step times at B = 64 and
   512, with a ``torch.profiler`` breakdown of one kernel-path step by
   kernel group;
5. serve a random full-width bf16 STLT through ``predict`` at
   ``--layout_num_frames 256`` (2 batches of 64 clips of 256-300 frames, every
   slot live: the temporal attention on the short flash kernel) and 512 (2
   batches of 32 clips of 32-256 frames: the blockwise kernel), asserting
   rows, finite scores, the launch counts (per forward: 4 fused projection
   attentions, 12 layer tails, 8 of the long-clip kernel, none of the other)
   and one batch's logits against the plain path; then evaluate the 512-frame
   set through ``inference`` with and without ``--live_prefix --use_pallas``
   (finite metrics, the spatial attention on the live capacity's rows, one
   batch's capped logits against the uncapped ones) and print the forward
   times, kernels against plain;
6. train a full-width bf16 STLT (dropout 0.1) through ``train`` at
   ``--layout_num_frames 256`` (B = 32) and 512 (B = 16, clips of 32-256
   frames, which the train sampler stretches over every slot), two steps
   and one validation batch each: finite losses and the launch counts (per step
   4 + 4 of the train op's kernels, 8 + 8 of the long-clip forward and
   backward, 12 of each of the fused train tail's four kernels; the eval tail
   only in the validation batch) are asserted; then one step from the
   trained weights, kernels against the plain path (the train step's limits
   below), the step times and peak memory of both and a ``torch.profiler``
   breakdown by kernel group;
7. serve random full-width bf16 fusion models (``bench.py::bench_cacnf``'s
   config: the STLT layout branch, R3D-50 and 4 appearance layers over 32
   frames of 112 px, 4 fusion layers; weights from the port's seeded init,
   saved as reference-format ``.pt``) through ``predict`` on fabricated JPEG
   frames (the ``<video_id>/<index>.jpg`` directory that
   ``tools/frames2hdf5.py`` packs into the HDF5 archive; the card's machine
   has no h5py, so ``frames_directory_videos`` hands the dataset those
   frames in the archive's place): CACNF at 16 layout frames (2 batches of 32
   clips) and once through ``inference``, CAF and LCF (one batch each, from
   CACNF's weights), and CACNF at 512 layout frames (B = 16, clips of 32-256
   frames). Rows, finite scores and metrics and the launch counts per
   forward are asserted (CACNF at 16 frames: 28 fused projection+attention,
   16 layer tails, 8 fused cross-attentions; at 512 frames 12 dense-bias
   blockwise launches beside the 8 of the temporal encoder's lengths mode),
   and one batch's logits of every head are held against the plain path on
   the card, with the forward times and a ``torch.profiler`` breakdown;
8. train random full-width bf16 CACNF (``bench.py::bench_cacnf_train_device``'s
   config: dropout 0.1, AdamW lr 1e-4, wd 1e-3, clip 5.0, uint8 frames
   normalised on the device) through ``train`` on fabricated JPEG frames at
   16 layout frames (B = 32) and 512 (B = 16): two steps and one validation
   batch each, finite losses and the launch counts asserted (per step at 16
   frames 28 + 28 of the train op's kernels and 8 + 8 of the short kernel
   and its backward; at 512 frames 16 + 16, 8 + 8 of the blockwise lengths
   mode, 12 + 12 of its dense-bias mode and 12 of each fused train-tail
   kernel); then from the trained weights one step kernels against plain
   (at 512 frames also in f32), step times, peak memory and a profile by
   kernel group; at 16 frames a
   fine-tune of the saved backbone with ``--load_backbone_path
   --freeze_backbone`` (the backbone on the eval kernels, rows 1, 2 and 5,
   no backward kernel, bit-unchanged) and one train step each of
   ``resnet3d-transformer``, LCF and CAF with their launch counts;
9. print the kernel table as one JSON line, then the result line.

Tolerances (kernel against plain version, same inputs, same rounding
points, same keep bits; the two differ only in the order of their sums):

- f32 ops: atol = rtol = 1e-4. Sums run over up to 3072 products, and
  LayerNorm divides by the row's spread, so reordering moves the last bits
  of an f32 value; 1e-4 holds that with margin and nothing more. One
  flipped dropout bit moves an output by a probability times a value
  (about 1e-2) and fails it.
- bf16 ops: atol = 6e-2, rtol = 2e-2. A reordered f32 sum can round to the
  neighbouring bf16 value (2**-8 relative), and a flipped intermediate moves
  a LayerNorm output by a few bf16 steps.
- summed weight gradients (dWo, dbo and the five gradients of the train
  op): relative Frobenius-norm error 1e-5 in f32, 2e-2 in bf16. Each is a
  sum over every token, so elementwise bounds would track the sum's size;
  the relative norm holds the rounding of the summands (2**-8 in bf16).
- the long-clip attention kernels (out and lse): the same OP_TOL. Their sums
  run over up to 1025 keys and the kernels take the softmax online over
  chunks of 64 keys, which moves only the last bits of an f32 value; in
  bf16 the output is rounded once, so a reordered sum can land on the
  neighbouring bf16 value.
- the long-clip forwards with dropout in f32: atol = rtol = 1e-5 (a
  flipped keep bit moves an output by a probability times a value, far
  more). Their backwards: dq, dk and dv each within a relative
  Frobenius-norm error of BWD_REL, 1e-5 in f32 and 1e-3 in bf16; the same
  OP_TOL elementwise only as a guard on finite values and dead rows, whose
  dq is exactly zero. Sound kernels read at most 2.2e-4 in bf16 and 1.3e-7
  in f32 (H100). In bf16 an elementwise bound is about as large as a dk or
  dv element, so it cannot see a fault confined to the tensor-core
  products; the norm can: multiplying p or dz on the tensor cores without
  the hi + lo split (2**-9 relative on each probability) reads 2.5e-3 to
  2.7e-3, dropping dsum from dz 0.6 (``python -m
  stlt_tpu_torch.utils.bwd_tolerance``, H100; PERF.md, PR 4).
- the fused train tail: y, r2, dr2, dx and dattn within the same OP_TOL;
  dx and dattn each within a relative Frobenius-norm error of TAIL_BWD_REL,
  1e-5 in f32 and 5e-4 in bf16; dr2 and the summed gradients (dn1s, dn1b,
  dW1, db1, dW2, db2, dn2s, dn2b) each within TAIL_SUM_REL, 1e-5 in f32 and
  5e-4 in bf16. In bf16 sound kernels read at most 8.7e-5 for dx and dattn
  and 9e-5 for the sums; act' taken on the bf16-rounded z1 instead of the
  f32 one reads 1.1e-3 and the input kernel's dh2 without its keep bits
  7.0e-2, both over the limit, which the elementwise OP_TOL would not be.
  Faults in the weight kernel read over the sums' limit in dW1 and dW2:
  each split's partial rounded to bf16 1.7e-3, the last split left out
  6.0e-2 to 6.5e-2, at 4,112 and at 65,792 tokens (``python -m
  stlt_tpu_torch.utils.bwd_tolerance tail``, H100; PERF.md §6).
- the fused cross-attention (row 5) and the blockwise forward's dense-bias
  mode (row 8): the same OP_TOL elementwise, and in bf16 the output within
  a relative Frobenius-norm error of CROSS_REL (1.2e-3) and DENSE_REL
  (5e-4). A typical cross-attention output is about as large as the bf16
  atol, so the elementwise bound alone would pass a kernel that drops bo
  or bkv; the norm can see it. Sound kernels read at most 8.9e-4 (row 5:
  a neighbouring bf16 value of q, kv or o_h, taken where the two f32 sums
  straddle a rounding boundary, moves a near-uniform softmax's output, an
  average of values several times its size) and 1.0e-4 (row 8 dense).
  Planted faults read: row 5 with q_h not rounded 1.7e-3 to 2.6e-3, bkv
  left out 2.5e-2 to 0.11, bo left out 4.3e-2 to 0.19, a head left out
  0.29; row 8 dense without the hi + lo split 1.8e-3 to 2.2e-3, its causal
  key range one key short 7.1e-3 (``python -m
  stlt_tpu_torch.utils.bwd_tolerance cross dense``, H100; PERF.md, PR 6).
- the blockwise backward's dense-bias mode (rows 9 and 10): dq, dk and dv
  each within a relative Frobenius-norm error of DENSE_BWD_REL (1e-3) in
  bf16 and BWD_REL (1e-5) in f32, the same OP_TOL elementwise as a guard.
  Sound kernels read at most 1.3e-4 in bf16; without the hi + lo split
  2.5e-3 to 2.7e-3, dsum left out 0.14 to 0.74, the dq kernel's causal key
  range one key short 6.1e-3 to 7.2e-3 (flag cases), the dk/dv kernel's
  bias read with its t and s strides swapped up to 80 (``python -m
  stlt_tpu_torch.utils.bwd_tolerance dense_bwd``, H100; PERF.md §6).
- bf16 logits of the whole model (every head of the fusion models):
  atol = 5e-2. The whole bf16 path differs
  from the f32 path by 2.5e-2 at most at this config (randomly initialised
  STLT, 4 clips, CPU); kernel and plain differ by less than bf16 itself.
- one full-width bf16 train step, kernels against plain: loss atol 5e-2
  (the logits' tolerance); each parameter's gradient within a relative norm
  of 3e-2, and all of them joined within 5e-2: twelve layers of bf16
  roundings taken at the same points but by other sums. The worst single
  tensor measured 8.2e-3 (H100), so 3e-2 leaves room for that rounding and
  still catches a backward fault confined to a few layers' attention
  weights, which the joined norm, led by the largest gradients, would hide.
- the fusion train step (phase 8): the same limits, but each gradient of
  the appearance branch (R3D trunk, projector, ReLU encoder) within 6e-2 in
  bf16. Its gradients pass ReLU gates, and the two paths' bf16 roundings of
  the encoder's pre-activations flip a few of them, each flip a whole
  element of dh1: the appearance branch read 3.0e-2 to 3.5e-2 (linear1 of
  the last encoder layers; the R3D layer1 convolutions below them), the
  rest at most 1.1e-2 (H100; PERF.md §6). The same step in f32, where
  rounding flips a gate only now and then, holds every tensor: loss atol
  1e-5, each gradient within 1e-4 (sound 2.1e-6) and in the appearance
  branch within 1e-3 (sound 1.0e-5 and 1.4e-4 in two runs: a few flipped
  gates), joined within 3e-4 (sound 1.3e-6 and 2.7e-5), so a kernel fault
  confined to a few tensors of any branch still shows.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

H, HEADS, FF = 768, 12, 3072
NUM_FRAMES, NUM_BOXES = 17, 8  # 16 sampled frames + the extract frame; CLS + 7 boxes
SPATIAL_LAYERS, TEMPORAL_LAYERS = 4, 8
NUM_CLASSES = 174
BATCH, NUM_BATCHES = 64, 3
THROUGHPUT_BATCH = 1024
TRAIN_BATCH = 512  # bench.py::bench_stlt_train's batch
LONG_FRAMES = 33  # the 32-frame configuration's temporal T
TRAIN_CLIPS, VAL_CLIPS, TRAIN_EPOCHS, TRAIN_LABELS = 256, 64, 2, 5
DROPOUT = 0.1
EPS = 1e-12
SEED = 0

# H100 SXM data-sheet peaks (dense), see PERF.md.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12

OP_TOL = {
    torch.float32: dict(atol=1e-4, rtol=1e-4),
    torch.bfloat16: dict(atol=6e-2, rtol=2e-2),
}
LOGITS_ATOL = 5e-2
GRAD_REL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
STEP_LOSS_ATOL, STEP_GRAD_REL, STEP_TENSOR_REL = 5e-2, 5e-2, 3e-2
# The fusion train step (phase 8), (loss atol, joined, each, each in the
# appearance branch): in bf16 the appearance branch's gradients (the R3D
# trunk, its projector, the ReLU encoder) each within
# APPEARANCE_STEP_TENSOR_REL; the same step in f32 within FUSION_STEP_F32.
APPEARANCE_STEP_TENSOR_REL = 6e-2
FUSION_STEP_BF16 = (STEP_LOSS_ATOL, STEP_GRAD_REL, STEP_TENSOR_REL, APPEARANCE_STEP_TENSOR_REL)
FUSION_STEP_F32 = (1e-5, 3e-4, 1e-4, 1e-3)

REPLACES = {
    "fused_proj_attention": "stlt_tpu/ops/fused_encoder.py:154",
    "fused_layer_tail": "stlt_tpu/ops/fused_encoder.py:456",
    "fused_proj_attention_train": "stlt_tpu/ops/fused_encoder.py:1011",
    "fused_proj_attention_train_bwd": "stlt_tpu/ops/fused_encoder.py:737",
    "flash_attention": "stlt_tpu/ops/flash.py:119",
    "blockwise_attention": "stlt_tpu/ops/flash.py:397",
    "flash_attention_bwd": "stlt_tpu/ops/flash.py:166",
    # One launch runs both TPU kernels' work: _blockwise_dq_kernel (:655)
    # and _blockwise_dkdv_kernel (:745).
    "blockwise_attention_bwd": "stlt_tpu/ops/flash.py:655",
    "fused_layer_tail_train": "stlt_tpu/ops/fused_tail_train.py:191",
    "fused_tail_train_bwd_row": "stlt_tpu/ops/fused_tail_train.py:284",
    "fused_tail_train_bwd_input": "stlt_tpu/ops/fused_tail_train.py:350",
    "fused_tail_train_bwd_weight": "stlt_tpu/ops/fused_tail_train.py:459",
    "fused_cross_attention": "stlt_tpu/ops/fused_encoder.py:1135",
    # The dense-bias mode of _blockwise_attn_kernel (_block_bias reading bias_arr).
    "blockwise_attention_dense": "stlt_tpu/ops/flash.py:397",
    # The dense-bias mode of _blockwise_dq_kernel (:655) and
    # _blockwise_dkdv_kernel (:745), one launch for both.
    "blockwise_attention_bwd_dense": "stlt_tpu/ops/flash.py:655",
}
EVAL_KERNELS = ("fused_proj_attention", "fused_layer_tail")
TRAIN_KERNELS = ("fused_proj_attention_train", "fused_proj_attention_train_bwd")
TAIL_KERNELS = ("fused_layer_tail_train", "fused_tail_train_bwd_row", "fused_tail_train_bwd_input",
                "fused_tail_train_bwd_weight")
FUSION_KERNELS = ("fused_cross_attention", "blockwise_attention_dense")
# Long clips (bench.py:154-266): --layout_num_frames -> (batch, the clips'
# frame counts). 256 frames: every slot live (long_context); 512 frames:
# clips of 32-256 frames, ~28 % of the slots live (long_context_512_ragged).
LONG_CLIPS = {256: (64, (256, 301)), 512: (32, (32, 257))}
LONG_NUM_BATCHES = 2
CHECK_CLIPS = 6  # clips of the long-clip kernel checks
# Long-clip training (bench.py:355-425, long_context_train, B = 16 at 513
# frames): --layout_num_frames -> (batch, the clips' frame counts). The
# train sampler fills every frame slot of every clip, so each train batch is
# B x (frames + 1) live slots whatever the clips' lengths.
LONG_TRAIN = {256: (32, (256, 301)), 512: (16, (32, 257))}
LONG_TRAIN_STEPS = 2  # one epoch of two AdamW steps and one validation batch
FWD_DROP_TOL = dict(atol=1e-5, rtol=1e-5)  # f32 forward with dropout: one flipped bit fails it
BWD_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}  # long-clip backwards, relative norm
TAIL_BWD_REL = {torch.float32: 1e-5, torch.bfloat16: 5e-4}  # the train tail's dx, dattn, relative norm
# The train tail's dr2 and its eight summed gradients, relative norm.
TAIL_SUM_REL = {torch.float32: 1e-5, torch.bfloat16: 5e-4}
# bf16 outputs of the fused cross-attention and of the blockwise forward's
# dense-bias mode, relative norm (f32: OP_TOL alone).
CROSS_REL, DENSE_REL = 1.2e-3, 5e-4
# dq, dk, dv of the blockwise backward's dense-bias mode in bf16, relative
# norm (f32: BWD_REL): sound 1.3e-4, the smallest planted fault 2.5e-3.
DENSE_BWD_REL = 1e-3
# The fused train tail's main-path shapes (tokens): the spatial and the
# temporal stage of a 256-frame step (B = 32: 32 x 257 x 8 and 32 x 257), and
# the spatial stage of the 17-frame step at B = 512 (the gate keeps that one
# on the plain chain; timed for the op-level A/B only).
TAIL_SHAPES = (("spatial 256 frames", 32 * 257 * NUM_BOXES), ("temporal 256 frames", 32 * 257),
               ("spatial 17 frames", TRAIN_BATCH * NUM_FRAMES * NUM_BOXES))


def log(msg: str) -> None:
    print(msg, flush=True)


# --- phase 2: each kernel against its plain version ---------------------------


def _uniform(shape, bound, gen, device):
    return ((torch.rand(shape, generator=gen) * 2 - 1) * bound).to(device)


def make_weights(gen, device):
    """Full-width layer weights, input-major, f32, drawn like the model's
    init (plus nonzero attention biases)."""
    return {
        "wqkv": _uniform((H, 3 * H), math.sqrt(6.0 / (4 * H)), gen, device),
        "bqkv": _uniform((3 * H,), 0.02, gen, device),
        "wo": _uniform((H, H), 1 / math.sqrt(H), gen, device),
        "bo": _uniform((H,), 0.02, gen, device),
        "n1s": 1 + _uniform((H,), 0.1, gen, device),
        "n1b": _uniform((H,), 0.1, gen, device),
        "w1": _uniform((H, FF), 1 / math.sqrt(H), gen, device),
        "b1": _uniform((FF,), 1 / math.sqrt(H), gen, device),
        "w2": _uniform((FF, H), 1 / math.sqrt(FF), gen, device),
        "b2": _uniform((H,), 1 / math.sqrt(FF), gen, device),
        "n2s": 1 + _uniform((H,), 0.1, gen, device),
        "n2b": _uniform((H,), 0.1, gen, device),
    }


def make_stage(stage: str, clips: int, dtype, gen, device, frames: int = NUM_FRAMES):
    """Inputs one encoder layer of ``stage`` sees at ``clips`` clips of
    ``frames`` frames: (x, attn_out, bias, live kwargs, [rows, T] bool of the
    tokens the attention computes, [rows, T] bool of the tokens the tail
    computes)."""
    from stlt_tpu_torch.ops import masks

    lengths = torch.randint(4, frames + 1, (clips,), generator=gen)
    frame_live = torch.arange(frames)[None, :] < lengths[:, None]  # [clips, F]
    if stage == "spatial":
        rows, T = clips * frames, NUM_BOXES
        boxes = torch.randint(1, NUM_BOXES + 1, (rows,), generator=gen)
        pad = torch.arange(T)[None, :] >= boxes[:, None]  # slot 0 (CLS) is always live
        bias = masks.key_padding_bias(pad)  # [rows, 1, 1, T]
        rows_live = frame_live.reshape(rows)
        live_kw = {"rows_live": rows_live.to(device)}
        proj_live = tail_live = rows_live[:, None].expand(rows, T)
    else:
        rows, T = clips, frames
        bias = masks.causal_bias(T) + masks.key_padding_bias(~frame_live)  # [rows, 1, T, T]
        live_kw = {"tokens_live": frame_live.to(device)}
        proj_live = torch.ones((rows, T), dtype=torch.bool)  # temporal attention skips no row
        tail_live = frame_live
    x = torch.randn((rows, T, H), generator=gen).to(device, dtype)
    attn = (0.5 * torch.randn((rows, T, H), generator=gen)).to(device, dtype)
    return x, attn, bias.to(device), live_kw, proj_live.to(device), tail_live.to(device)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, after warmup."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def proj_bound(x, bias, live, dtype):
    """(ms, "bytes" | "operations") for fused_proj_attention on these
    inputs: live rows' flops at the dtype's peak against each input read
    once (live rows of x) and the whole output written once."""
    rows, T, _ = x.shape
    live_rows = int(live[:, 0].sum())
    es = x.element_size()
    flops = live_rows * (8 * T * H * H + 4 * T * T * H)
    nbytes = (2 * live_rows * T * H * es if live_rows else 0) + (rows - live_rows) * T * H * es
    nbytes += (4 * H * H + 4 * H) * es + bias.numel() * 4 + rows
    return _bound(flops, nbytes, dtype)


def tail_bound(x, live, dtype):
    tokens = x.shape[0] * x.shape[1]
    live_tokens = int(live.sum())
    es = x.element_size()
    flops = live_tokens * 4 * H * FF
    nbytes = 2 * live_tokens * H * es + tokens * H * es  # x and attn_out read, out written
    nbytes += 2 * H * FF * es + (FF + 5 * H) * 4 + tokens
    return _bound(flops, nbytes, dtype)


def _bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def library_proj(w, dtype):
    """``F.linear`` + ``scaled_dot_product_attention`` + ``F.linear``: the
    same function from PyTorch's library calls, a yardstick only."""
    wqkv, bqkv = w["wqkv"].t().contiguous().to(dtype), w["bqkv"].to(dtype)
    wo, bo = w["wo"].t().contiguous().to(dtype), w["bo"].to(dtype)
    D = H // HEADS

    def run(x, bias):
        rows, T, _ = x.shape
        q, k, v = F.linear(x, wqkv, bqkv).view(rows, T, 3, HEADS, D).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
        return F.linear(o.transpose(1, 2).reshape(rows, T, H), wo, bo)

    return run


def library_tail(w, dtype, activation: str = "gelu", eps: float = EPS):
    """``F.layer_norm`` / ``F.linear`` / ``F.gelu`` (or ``F.relu``): the same
    function from PyTorch's library calls, a yardstick only."""
    c = {k: w[k].to(dtype) for k in ("n1s", "n1b", "b1", "b2", "n2s", "n2b")}
    w1, w2 = w["w1"].t().contiguous().to(dtype), w["w2"].t().contiguous().to(dtype)
    approximate = "tanh" if dtype == torch.bfloat16 else "none"
    act = F.relu if activation == "relu" else lambda h: F.gelu(h, approximate=approximate)

    def run(x, a):
        u = F.layer_norm(x + a, (H,), c["n1s"], c["n1b"], eps)
        h = act(F.linear(u, w1, c["b1"]))
        return F.layer_norm(u + F.linear(h, w2, c["b2"]), (H,), c["n2s"], c["n2b"], eps)

    return run


def _check_close(name, got, want, live, tol):
    err = (got.float() - want.float()).abs()
    bad = err > tol["atol"] + tol["rtol"] * want.float().abs()
    if bad.any() or not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel disagrees with its plain version: "
                             f"max_abs_err {err.max().item():.3e}, {int(bad.sum())} elements out of tolerance")
    dead = ~live
    if dead.any() and got[dead].abs().max().item() != 0.0:
        raise AssertionError(f"{name}: dead rows are not exact zeros")
    return err.max().item()


def _measure(name, stage, dtype, clips, x, kernel, plain, library, bound, live, tol, rel_tol=None,
             **extra):
    """Check ``kernel()`` against ``plain()`` (one output, elementwise, and
    with ``rel_tol`` also in the relative Frobenius norm) and time kernel,
    plain version and library yardstick; returns the row."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    label = f"{name} {stage} {dtype} B={clips} T={x.shape[1]}"
    err = _check_close(label, got, want, live, tol)
    if rel_tol is not None:
        extra.update(rel_err=_rel(got, want), rel_tol=rel_tol)
        if extra["rel_err"] > rel_tol:
            raise AssertionError(f"{label}: relative norm error {extra['rel_err']:.3e} over {rel_tol}")
    iters = 20 if clips == BATCH else 5
    bound_ms, bound_by = bound
    row = {
        "name": name, "stage": stage, "dtype": str(dtype).split(".")[1], "clips": clips,
        "rows": x.shape[0], "T": x.shape[1], **extra,
        "live_fraction": round(float(live.float().mean()), 4), "max_abs_err": err, "tol": tol,
        "ms": cuda_ms(kernel, iters), "plain_ms": cuda_ms(plain, iters),
        "library_ms": cuda_ms(library, iters), "bound_ms": bound_ms, "bound_by": bound_by,
    }
    log("kernel_check " + json.dumps(row))
    return row


def check_kernels(device):
    """Compare and time both eval kernels; returns the rows of the kernel
    table, keyed by kernel name, measured at the main-path batch in bf16 on
    the spatial stage (the larger one), with every other measurement
    printed."""
    from stlt_tpu_torch.ops import fused_encoder as fe

    gen = torch.Generator().manual_seed(SEED)
    w = make_weights(gen, device)
    table = {}
    for dtype in (torch.bfloat16, torch.float32):
        tol = OP_TOL[dtype]
        lib_p, lib_t = library_proj(w, dtype), library_tail(w, dtype)
        for stage, clips, frames in (("spatial", BATCH, NUM_FRAMES),
                                     ("spatial", THROUGHPUT_BATCH, NUM_FRAMES),
                                     ("temporal", BATCH, NUM_FRAMES),
                                     ("temporal", THROUGHPUT_BATCH, NUM_FRAMES),
                                     ("temporal", BATCH, LONG_FRAMES)):
            if clips == THROUGHPUT_BATCH and dtype != torch.bfloat16:
                continue
            x, a, bias, live_kw, proj_live, tail_live = make_stage(
                stage, clips, dtype, gen, device, frames)
            proj_args = (x, w["wqkv"], w["bqkv"], w["wo"], w["bo"], bias)
            proj_kw = dict(num_heads=HEADS, compute_dtype=dtype, rows_live=live_kw.get("rows_live"))
            row = _measure(
                "fused_proj_attention", stage, dtype, clips, x,
                lambda: fe.fused_proj_attention(*proj_args, **proj_kw),
                lambda: fe.fused_proj_attention_plain(*proj_args, **proj_kw),
                lambda: lib_p(x, bias.to(dtype)), proj_bound(x, bias, proj_live, dtype),
                proj_live, tol,
            )
            if stage == "spatial" and clips == BATCH and dtype == torch.bfloat16:
                table["fused_proj_attention"] = row
            if frames == LONG_FRAMES:
                continue  # the tail's shapes do not depend on T
            tail_args = (x, a, w["n1s"], w["n1b"], w["w1"], w["b1"], w["w2"], w["b2"],
                         w["n2s"], w["n2b"])
            tail_kw = dict(eps=EPS, compute_dtype=dtype, activation="gelu",
                           gelu_approximate=dtype == torch.bfloat16, **live_kw)
            row = _measure(
                "fused_layer_tail", stage, dtype, clips, x,
                lambda: fe.fused_layer_tail(*tail_args, **tail_kw),
                lambda: fe.fused_layer_tail_plain(*tail_args, **tail_kw),
                lambda: lib_t(x, a), tail_bound(x, tail_live, dtype), tail_live, tol,
            )
            if stage == "spatial" and clips == BATCH and dtype == torch.bfloat16:
                table["fused_layer_tail"] = row
            del x, a, bias, live_kw, proj_live, tail_live
            torch.cuda.empty_cache()
    return table


# --- phase 2, train: the train op's forward and backward kernels --------------


def train_bwd_bound(x, bias, live, dtype):
    """(ms, "bytes" | "operations") for the backward kernel on these inputs:
    per live row 10*T*H^2 + 12*T^2*H flops (q/k/v and do recompute 6TH^2 +
    2TH^2, dWo 2TH^2, the attention recompute 4T^2H and its backward 8T^2H)
    against x and g read (live rows), dqkv written (every row), Wqkv, bqkv and
    Wo read and dWo, dbo written once. The wrapper's three GEMMs (dx, dWqkv,
    dbqkv) are not the kernel's and are timed apart."""
    rows, T, _ = x.shape
    live_rows = int(live[:, 0].sum())
    es = x.element_size()
    flops = live_rows * (10 * T * H * H + 12 * T * T * H)
    nbytes = 2 * live_rows * T * H * es + rows * T * 3 * H * es
    nbytes += (4 * H * H + 3 * H) * es + (H * H + H) * 4 + bias.numel() * 4 + rows
    return _bound(flops, nbytes, dtype)


def library_train(w, dtype, rate):
    """``F.linear`` + ``scaled_dot_product_attention`` (with ``dropout_p``) +
    ``F.linear`` and its autograd backward: the same work from PyTorch's
    library calls, a yardstick only."""
    D = H // HEADS
    leaves = [w["wqkv"].t().contiguous().to(dtype), w["bqkv"].to(dtype),
              w["wo"].t().contiguous().to(dtype), w["bo"].to(dtype)]
    leaves = [t.requires_grad_() for t in leaves]

    def forward(x, bias):
        rows, T, _ = x.shape
        q, k, v = F.linear(x, leaves[0], leaves[1]).view(rows, T, 3, HEADS, D).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias, dropout_p=rate)
        return F.linear(o.transpose(1, 2).reshape(rows, T, H), leaves[2], leaves[3])

    def backward(y, x, g):
        return torch.autograd.grad(y, [x, *leaves], g, retain_graph=True)

    return forward, backward


def _rel(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30)).item()


def check_train_kernels(device):
    """Compare the train forward and backward kernels with their plain
    versions (dropout 0.1 and 0, the same seed), and the five gradients of
    the whole autograd op with the plain backward plus the wrapper's GEMMs;
    time both kernels at B = 64 and, in bf16, 512. Returns the kernel-table
    rows (spatial, bf16, B = 64, dropout 0.1)."""
    from stlt_tpu_torch.ops import fused_encoder as fe

    gen = torch.Generator().manual_seed(SEED + 1)
    w = make_weights(gen, device)
    seed = 0x5EED5EED
    table = {}
    for dtype in (torch.bfloat16, torch.float32):
        tol = OP_TOL[dtype]
        cases = [(stage, clips, frames, rate)
                 for stage, frames in (("spatial", NUM_FRAMES), ("temporal", NUM_FRAMES),
                                       ("temporal", LONG_FRAMES))
                 for clips in (BATCH, TRAIN_BATCH)
                 for rate in (DROPOUT, 0.0)
                 if (clips == BATCH or (dtype == torch.bfloat16 and frames == NUM_FRAMES
                                        and rate == DROPOUT))]
        for stage, clips, frames, rate in cases:
            x, _, bias, live_kw, proj_live, _ = make_stage(stage, clips, dtype, gen, device, frames)
            g = torch.randn(x.shape, generator=gen).to(device, dtype)
            rows_live = live_kw.get("rows_live")
            if rows_live is not None:
                g[~rows_live] = 0  # as in the model: dead rows get no cotangent
            kw = dict(num_heads=HEADS, dropout_rate=rate, compute_dtype=dtype, rows_live=rows_live)
            fwd = (x, w["wqkv"], w["bqkv"], w["wo"], w["bo"], bias, seed)
            bwd = (x, w["wqkv"], w["bqkv"], w["wo"], bias, g, seed)
            lib_f, lib_b = library_train(w, dtype, rate)
            label = f"{stage} {dtype} B={clips} T={x.shape[1]} rate={rate}"

            row_f = _measure(
                "fused_proj_attention_train", stage, dtype, clips, x,
                lambda: fe.fused_proj_attention_train(*fwd, **kw),
                lambda: fe.fused_proj_attention_train_plain(*fwd, **kw),
                lambda: lib_f(x, bias.to(dtype)), proj_bound(x, bias, proj_live, dtype),
                proj_live, tol, rate=rate,
            )
            # The wrapper on leaves that record the graph: its forward, then
            # its backward through both kernels.
            leaves = [t.detach().clone().requires_grad_() for t in fwd[:5]]
            y = fe.fused_proj_attention_train(*leaves, bias, seed, **kw)
            _check_close(f"fused_proj_attention_train (autograd) {label}", y.detach(),
                         fe.fused_proj_attention_train_plain(*fwd, **kw), proj_live, tol)
            y.backward(g)
            got, want = fe._launch_proj_bwd(*bwd, **kw), fe.fused_proj_attention_train_bwd_plain(*bwd, **kw)
            again = fe._launch_proj_bwd(*bwd, **kw)
            torch.cuda.synchronize()
            err = _check_close(f"fused_proj_attention_train_bwd dqkv {label}", got[0], want[0],
                               proj_live, tol)
            rel = {"dwo": _rel(got[1], want[1]), "dbo": _rel(got[2], want[2])}
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"backward {label}: two runs differ")
            plain = (*fe.proj_input_grads(x, w["wqkv"], want[0], dtype), want[1], want[2])
            for name, leaf, ref in zip(("dx", "dwqkv", "dbqkv", "dwo_op", "dbo_op"), leaves, plain):
                rel[name] = _rel(leaf.grad, ref)
            if max(rel.values()) > GRAD_REL[dtype] or not all(
                    torch.isfinite(t).all() for t in (*got, *(l.grad for l in leaves))):
                raise AssertionError(f"backward {label}: gradients disagree with plain: {rel}")
            dead = ~proj_live
            if dead.any() and leaves[0].grad[dead].abs().max().item() != 0.0:
                raise AssertionError(f"backward {label}: dead rows have nonzero dx")
            iters = 20 if clips == BATCH else 5
            lib_x = x.detach().requires_grad_()
            y_lib = lib_f(lib_x, bias.to(dtype))
            row_b = {
                "name": "fused_proj_attention_train_bwd", "stage": stage,
                "dtype": str(dtype).split(".")[1], "clips": clips, "rows": x.shape[0],
                "T": x.shape[1], "rate": rate, "max_abs_err": err, "rel_err": rel,
                "ms": cuda_ms(lambda: fe._launch_proj_bwd(*bwd, **kw), iters),
                "plain_ms": cuda_ms(lambda: fe.fused_proj_attention_train_bwd_plain(*bwd, **kw), iters),
                "library_ms": cuda_ms(lambda: lib_b(y_lib, lib_x, g), iters),
                "wrapper_gemms_ms": cuda_ms(lambda: fe.proj_input_grads(x, w["wqkv"], got[0], dtype), iters),
            }
            row_b["bound_ms"], row_b["bound_by"] = train_bwd_bound(x, bias, proj_live, dtype)
            log("kernel_check " + json.dumps(row_b))
            if stage == "spatial" and clips == BATCH and dtype == torch.bfloat16 and rate == DROPOUT:
                table["fused_proj_attention_train"] = row_f
                table["fused_proj_attention_train_bwd"] = row_b
            del x, g, bias, got, want, again, leaves, y, y_lib, lib_x
            torch.cuda.empty_cache()
    return table


# --- phase 2, long clips: the attention kernels of ops/flash.py ---------------


def make_heads(clips: int, T: int, dtype, gen, device):
    """q, k, v [clips, T, 12, 64]: the q/k/v thirds of one [clips, T, 3H]
    projection, read through their strides, as the model passes them."""
    qkv = torch.randn((clips, T, 3 * H), generator=gen).to(device, dtype)
    return tuple(qkv[..., i * H:(i + 1) * H].unflatten(-1, (HEADS, H // HEADS)) for i in range(3))


def ragged_lengths(clips: int, T: int, gen) -> torch.Tensor:
    """Live frame counts in 1..T, with 1 and T among them."""
    lengths = torch.randint(1, T + 1, (clips,), generator=gen)
    lengths[0], lengths[1] = 1, T
    return lengths


def flash_bound(q, bias, dtype):
    """(ms, "bytes" | "operations") for the short kernel on these inputs:
    4*D flops per (query, key, head) over every pair, against q, k, v read
    and out written once, and the bias (as given, f32) read once."""
    B, T, N, D = q.shape
    flops = 4 * D * N * B * T * T
    nbytes = 4 * B * T * N * D * q.element_size() + bias.numel() * 4
    return _bound(flops, nbytes, dtype)


def blockwise_bound(q, lengths, causal, dtype):
    """(ms, "bytes" | "operations") for the blockwise kernel in lengths mode:
    the flops of the live (query, key) pairs only (t, s < length; s <= t when
    causal), q, k, v of the live rows read, out, lse and the lengths written
    or read once."""
    B, T, N, D = q.shape
    L = lengths.to(torch.float64)
    pairs = float((L * (L + 1) / 2).sum() if causal else (L * L).sum())
    flops = 4 * D * N * pairs
    nbytes = 3 * float(L.sum()) * N * D * q.element_size() + B * T * N * D * q.element_size()
    nbytes += B * N * T * 4 + B * 4
    return _bound(flops, nbytes, dtype)


def library_attention(q, k, v, mask, rate: float = 0.0):
    """``scaled_dot_product_attention`` on the same inputs and mask (and
    ``dropout_p``): a yardstick only, never called by the port."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, dropout_p=rate)


def _causal_padding_bias(lengths, T, device):
    """The temporal stage's dense bias [B, 1, T, T]: causal plus key padding."""
    from stlt_tpu_torch.ops import masks

    pad = torch.arange(T)[None, :] >= lengths[:, None]
    return (masks.causal_bias(T) + masks.key_padding_bias(pad)).to(device)


def check_long_kernels(device):
    """The two long-clip kernels against their plain versions, bf16 and f32:
    the short kernel at T = 65, 257 and 512 (causal plus padding bias, ragged
    lengths), the blockwise kernel at T = 513 and 1025 (ragged kv_lengths with
    1 and T among them; out on live rows, dead rows exact zeros, lse on live
    rows). Then each timed against its plain version, the library yardstick
    and its bound at the main path's shape (full-length clips, as bench.py's
    long_context and long_context_512): the short kernel at B = 64, T = 257,
    the blockwise one at B = 32, T = 513. Returns the bf16 rows of the kernel
    table."""
    from stlt_tpu_torch.ops import flash

    gen = torch.Generator().manual_seed(SEED + 3)
    table = {}
    for dtype in (torch.bfloat16, torch.float32):
        tol = OP_TOL[dtype]
        for T in (65, 257, 512):
            q, k, v = make_heads(CHECK_CLIPS, T, dtype, gen, device)
            lengths = ragged_lengths(CHECK_CLIPS, T, gen)
            bias = _causal_padding_bias(lengths, T, device)
            got, want = flash.fused_attention(q, k, v, bias), flash.fused_attention_plain(q, k, v, bias)
            torch.cuda.synchronize()
            err = _check_close(f"flash_attention {dtype} T={T}", got, want,
                               torch.ones_like(got, dtype=torch.bool), tol)
            log(f"kernel_check flash_attention {dtype} B={CHECK_CLIPS} T={T} lengths "
                f"{lengths.tolist()}: max_abs_err {err:.3e}")
        for T in (513, 1025):
            q, k, v = make_heads(CHECK_CLIPS, T, dtype, gen, device)
            lengths = ragged_lengths(CHECK_CLIPS, T, gen).to(device)
            out, lse = flash.blockwise_attention(q, k, v, kv_lengths=lengths, causal=True)
            want, want_lse = flash.blockwise_attention_plain(q, k, v, kv_lengths=lengths, causal=True)
            torch.cuda.synchronize()
            live = torch.arange(T, device=device)[None, :] < lengths[:, None]  # [B, T]
            err = _check_close(f"blockwise_attention {dtype} T={T}", out, want,
                               live[:, :, None, None].expand(out.shape), tol)
            lse_err = _check_close(f"blockwise_attention lse {dtype} T={T}", lse, want_lse,
                                   live[:, None, :].expand(lse.shape), tol)
            log(f"kernel_check blockwise_attention {dtype} B={CHECK_CLIPS} T={T} lengths "
                f"{lengths.tolist()}: max_abs_err out {err:.3e}, lse {lse_err:.3e}")
            del q, k, v, out, lse, want, want_lse

        # Timing at the main path's shapes (every clip full length).
        q, k, v = make_heads(BATCH, 257, dtype, gen, device)
        full = torch.full((BATCH,), 257)
        bias = _causal_padding_bias(full, 257, device)
        row = _measure(
            "flash_attention", "temporal", dtype, BATCH, q,
            lambda: flash.fused_attention(q, k, v, bias),
            lambda: flash.fused_attention_plain(q, k, v, bias),
            library_attention(q, k, v, bias.to(dtype)), flash_bound(q, bias, dtype),
            torch.ones((BATCH, 257, HEADS, H // HEADS), dtype=torch.bool, device=device), tol,
        )
        if dtype == torch.bfloat16:
            table["flash_attention"] = row
        del q, k, v, bias
        clips = LONG_CLIPS[512][0]
        for name, lengths in (("full", torch.full((clips,), 513)),
                              ("ragged 33-257", torch.randint(33, 258, (clips,), generator=gen))):
            q, k, v = make_heads(clips, 513, dtype, gen, device)
            lengths = lengths.to(device)
            allowed = flash._lengths_dense_bias(lengths, 513, 513, True) == 0  # [B, 1, T, S]
            live = torch.arange(513, device=device)[None, :] < lengths[:, None]
            row = _measure(
                "blockwise_attention", "temporal", dtype, clips, q,
                lambda: flash.blockwise_attention(q, k, v, kv_lengths=lengths, causal=True)[0],
                lambda: flash.blockwise_attention_plain(q, k, v, kv_lengths=lengths, causal=True)[0],
                library_attention(q, k, v, allowed), blockwise_bound(q, lengths, True, dtype),
                live[:, :, None, None].expand(q.shape), tol, lengths=name,
            )
            if dtype == torch.bfloat16 and name == "full":
                table["blockwise_attention"] = row
            del q, k, v, allowed
        torch.cuda.empty_cache()
    return table


# --- phase 2, long clips in training: dropout variants and the backwards -------


def attention_bwd_bound(q, dtype, lengths=None, causal=True, bias=None):
    """(ms, "bytes" | "operations") for a backward launch on these inputs:
    10*D flops per (query, key, head) pair, five products (every pair in the
    bias mode, the live pairs in the lengths mode), against q, k, v, dO (live
    rows in the lengths mode), lse and dsum read once and dq, dk, dv written
    once, plus the f32 bias or the lengths."""
    B, T, N, D = q.shape
    es = q.element_size()
    if lengths is None:
        pairs, rows = float(B * T * T), float(B * T)
    else:
        L = lengths.to(torch.float64)
        pairs, rows = float((L * (L + 1) / 2).sum() if causal else (L * L).sum()), float(L.sum())
    flops = 10 * D * N * pairs
    nbytes = 4 * rows * N * D * es + 3 * B * T * N * D * es + 2 * B * N * T * 4
    nbytes += bias.numel() * 4 if bias is not None else B * 4
    return _bound(flops, nbytes, dtype)


def library_attention_bwd(q, k, v, mask, dout, rate):
    """The backward of ``scaled_dot_product_attention`` (same mask, the same
    ``dropout_p``) through autograd: a yardstick only, never called by the
    port."""
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, dropout_p=rate)
    dot = dout.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)


def _check_grads(label, got, want, dead, dtype, rel_tol=None):
    """dq, dk, dv of a backward kernel against the plain version: each
    within ``rel_tol`` (BWD_REL[dtype] by default) in relative norm, finite
    and within OP_TOL elementwise, dq of dead query rows exact zeros.
    Returns the largest elementwise error and the relative norm errors."""
    rel_tol = BWD_REL[dtype] if rel_tol is None else rel_tol
    errs, rel = [], {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        live = torch.ones_like(a, dtype=torch.bool)
        if name == "dq" and dead is not None:
            live = ~dead[:, :, None, None].expand(a.shape)
        errs.append(_check_close(f"{label} {name}", a, b, live, OP_TOL[dtype]))
        rel[name] = _rel(a, b)
    if max(rel.values()) > rel_tol:
        raise AssertionError(f"{label}: relative norm errors {rel} over {rel_tol}")
    return max(errs), rel


def check_long_train_kernels(device):
    """The long-clip train path's kernels against their plain versions, bf16
    and f32: the forwards' dropout variants (rate 0.1 and 0.5; f32 outputs
    within FWD_DROP_TOL, which needs equal keep bits) with the short
    kernel's lse; both backwards against ``attention_bwd_plain`` (the short
    one at T = 65, 257 and 512 with the causal plus padding bias, the
    blockwise one at T = 513 and 1025 in lengths mode, causal, full and
    ragged lengths, dropout 0 and 0.1, a cotangent of 1e30 on dead rows:
    finite, dead rows' dq exact zeros, two launches bit-identical). Then
    each backward timed at its main-path shape (B = 32, T = 257; B = 16,
    T = 513, every clip full length as train batches are, and a ragged row),
    with the dropout forwards beside them. Returns the bf16 rows of the
    kernel table."""
    from stlt_tpu_torch.ops import flash

    gen = torch.Generator().manual_seed(SEED + 5)
    seed = 0x5EED5EED
    table = {}
    for dtype in (torch.bfloat16, torch.float32):
        tol = OP_TOL[dtype]
        fwd_tol = FWD_DROP_TOL if dtype == torch.float32 else tol
        for T in (65, 257, 512, 513, 1025):
            for rate in (0.1, 0.5):
                q, k, v = make_heads(CHECK_CLIPS, T, dtype, gen, device)
                lengths = ragged_lengths(CHECK_CLIPS, T, gen).to(device)
                kw = dict(dropout_rate=rate, dropout_seed=seed)
                if T < 513:
                    bias = _causal_padding_bias(lengths.cpu(), T, device)
                    out, lse = flash.fused_attention(q, k, v, bias, with_lse=True, **kw)
                    want, want_lse = flash.fused_attention_plain(q, k, v, bias, with_lse=True, **kw)
                    live = torch.ones((CHECK_CLIPS, T), dtype=torch.bool, device=device)
                else:
                    out, lse = flash.blockwise_attention(q, k, v, kv_lengths=lengths, causal=True, **kw)
                    want, want_lse = flash.blockwise_attention_plain(q, k, v, kv_lengths=lengths,
                                                                     causal=True, **kw)
                    live = torch.arange(T, device=device)[None, :] < lengths[:, None]
                torch.cuda.synchronize()
                name = "flash_attention" if T < 513 else "blockwise_attention"
                err = _check_close(f"{name} dropout {rate} {dtype} T={T}", out, want,
                                   live[:, :, None, None].expand(out.shape), fwd_tol)
                lse_err = _check_close(f"{name} lse dropout {rate} {dtype} T={T}", lse, want_lse,
                                       live[:, None, :].expand(lse.shape), OP_TOL[torch.float32])
                log(f"kernel_check {name} dropout {rate} {dtype} B={CHECK_CLIPS} T={T}: "
                    f"max_abs_err out {err:.3e} (atol {fwd_tol['atol']}), lse {lse_err:.3e}")
        for T in (65, 257, 512, 513, 1025):
            for kind in (("ragged",) if T < 513 else ("full", "ragged")):
                for rate in (0.0, DROPOUT):
                    q, k, v = make_heads(CHECK_CLIPS, T, dtype, gen, device)
                    lengths = (ragged_lengths(CHECK_CLIPS, T, gen) if kind == "ragged"
                               else torch.full((CHECK_CLIPS,), T)).to(device)
                    dout = torch.randn((CHECK_CLIPS, T, HEADS, H // HEADS), generator=gen).to(device, dtype)
                    kw = dict(dropout_rate=rate, dropout_seed=seed if rate else None)
                    dead = None
                    if T < 513:
                        kw["bias"] = _causal_padding_bias(lengths.cpu(), T, device)
                        out, lse = flash.fused_attention(q, k, v, with_lse=True, **kw)
                        dsum = flash._dsum(dout, out, None)
                        run = lambda: flash.fused_attention_bwd(q, k, v, dout, lse, dsum, **kw)
                    else:
                        dead = torch.arange(T, device=device)[None, :] >= lengths[:, None]
                        dout[dead] = 1e30  # the backward must not read it
                        kw.update(kv_lengths=lengths, causal=True)
                        out, lse = flash.blockwise_attention(q, k, v, **kw)
                        dsum = flash._dsum(dout, out, lengths)
                        run = lambda: flash.blockwise_attention_bwd(q, k, v, dout, lse, dsum, **kw)
                    got, again = run(), run()
                    want = flash.attention_bwd_plain(q, k, v, dout, lse, dsum, **kw)
                    torch.cuda.synchronize()
                    name = "flash_attention_bwd" if T < 513 else "blockwise_attention_bwd"
                    label = f"{name} {dtype} B={CHECK_CLIPS} T={T} {kind} rate={rate}"
                    err, rel = _check_grads(label, got, want, dead, dtype)
                    if not all(torch.equal(a, b) for a, b in zip(got, again)):
                        raise AssertionError(f"{label}: two launches differ")
                    log(f"kernel_check {label}: max_abs_err {err:.3e}, relative norm errors "
                        f"{json.dumps(rel)}, dead rows zero, no NaN, two launches bit-identical")
                    del q, k, v, dout, out, lse, dsum, got, again, want
        torch.cuda.empty_cache()

        # Timing at the main path's shapes, dropout on as in training.
        rows = {}
        for name, clips, T, kind in (("flash_attention_bwd", LONG_TRAIN[256][0], 257, "full"),
                                     ("blockwise_attention_bwd", LONG_TRAIN[512][0], 513, "full"),
                                     ("blockwise_attention_bwd", LONG_TRAIN[512][0], 513, "ragged 33-257")):
            q, k, v = make_heads(clips, T, dtype, gen, device)
            lengths = (torch.full((clips,), T) if kind == "full"
                       else torch.randint(33, 258, (clips,), generator=gen)).to(device)
            dout = torch.randn((clips, T, HEADS, H // HEADS), generator=gen).to(device, dtype)
            kw = dict(dropout_rate=DROPOUT, dropout_seed=seed)
            if T < 513:
                bias = _causal_padding_bias(lengths.cpu(), T, device)
                mask = bias == 0
                fwd = lambda: flash.fused_attention(q, k, v, bias, with_lse=True, **kw)
                fwd_plain = lambda: flash.fused_attention_plain(q, k, v, bias, with_lse=True, **kw)
                out, lse = fwd()
                dsum = flash._dsum(dout, out, None)
                run = lambda: flash.fused_attention_bwd(q, k, v, dout, lse, dsum, bias, **kw)
                plain = lambda: flash.attention_bwd_plain(q, k, v, dout, lse, dsum, bias=bias, **kw)
                bound = attention_bwd_bound(q, dtype, bias=bias)
                fwd_bound = flash_bound(q, bias, dtype)
                dead = None
            else:
                mask = flash._lengths_dense_bias(lengths, T, T, True) == 0
                lkw = dict(kv_lengths=lengths, causal=True, **kw)
                fwd = lambda: flash.blockwise_attention(q, k, v, **lkw)
                fwd_plain = lambda: flash.blockwise_attention_plain(q, k, v, **lkw)
                out, lse = fwd()
                dsum = flash._dsum(dout, out, lengths)
                run = lambda: flash.blockwise_attention_bwd(q, k, v, dout, lse, dsum, **lkw)
                plain = lambda: flash.attention_bwd_plain(q, k, v, dout, lse, dsum, **lkw)
                bound = attention_bwd_bound(q, dtype, lengths=lengths, causal=True)
                fwd_bound = blockwise_bound(q, lengths, True, dtype)
                dead = torch.arange(T, device=device)[None, :] >= lengths[:, None]
            got, want = run(), plain()
            torch.cuda.synchronize()
            err, rel = _check_grads(f"{name} {dtype} B={clips} T={T} {kind}", got, want, dead, dtype)
            library = library_attention_bwd(q, k, v, mask, dout, DROPOUT)
            row = {
                "name": name, "stage": "temporal", "dtype": str(dtype).split(".")[1], "clips": clips,
                "T": T, "lengths": kind, "rate": DROPOUT, "max_abs_err": err, "rel_err": rel,
                "tol": tol, "rel_tol": BWD_REL[dtype], "ms": cuda_ms(run, 10), "plain_ms": cuda_ms(plain, 3),
                "library_ms": cuda_ms(library, 10), "bound_ms": bound[0], "bound_by": bound[1],
                "forward_dropout_ms": cuda_ms(fwd, 10), "forward_dropout_plain_ms": cuda_ms(fwd_plain, 3),
                "forward_dropout_library_ms": cuda_ms(library_attention(q, k, v, mask, DROPOUT), 10),
                "forward_dropout_bound_ms": fwd_bound[0], "forward_dropout_bound_by": fwd_bound[1],
            }
            log("kernel_check " + json.dumps(row))
            if dtype == torch.bfloat16 and kind == "full":
                table[name] = row
            del q, k, v, dout, out, lse, dsum, got, want, mask, library
            torch.cuda.empty_cache()
    return table


# --- phase 2, the fused train tail: its forward and three backward kernels ------


TAIL_GRADS = ("dx", "dattn", "dn1s", "dn1b", "dw1", "db1", "dw2", "db2", "dn2s", "dn2b")


def _tail_weights(w):
    return [w[k] for k in ("n1s", "n1b", "w1", "b1", "w2", "b2", "n2s", "n2b")]


def tail_train_bounds(tokens, live_tokens, dtype):
    """{kernel: (ms, "bytes" | "operations")} for the fused train tail's
    kernels on these shapes: live tokens' flops at the dtype's peak against
    each input read once and each output written once. Forward: two GEMMs of
    2*H*FF flops a token; x, attn and the weights in, y and r2 out. Row: its
    bytes (r2 and g in, dr2 out; its ~20 flops an element run on the f32
    pipes). Input: three GEMMs (z1, dh2 W2^T, du); x, attn, dr2 and the
    weights in, dx, dattn and the scratch the weight kernel reads (u, dh2
    [tokens, H], dh1, h1d [tokens, FF]) out. Weight: two GEMMs (dW1, dW2);
    that scratch in, dW1, dW2 and db1 out in f32."""
    es = 2 if dtype == torch.bfloat16 else 4
    act, hid = tokens * H * es, tokens * FF * es
    weights, vecs = 2 * H * FF * es, (FF + 6 * H) * 4
    gemm = 2 * live_tokens * H * FF
    row_ms, _ = _bound(20 * live_tokens * H, 0, torch.float32)
    row_bytes_ms = (3 * act + 4 * 3 * H + tokens) / HBM_BYTES_PER_S * 1e3
    return {
        "fused_layer_tail_train": _bound(2 * gemm, 4 * act + weights + vecs + tokens, dtype),
        "fused_tail_train_bwd_row": (max(row_ms, row_bytes_ms),
                                     "bytes" if row_bytes_ms >= row_ms else "operations"),
        "fused_tail_train_bwd_input": _bound(3 * gemm, 7 * act + 2 * hid + weights + vecs + tokens,
                                             dtype),
        "fused_tail_train_bwd_weight": _bound(2 * gemm, 2 * act + 2 * hid + (2 * H * FF + FF) * 4,
                                              dtype),
    }


def library_tail_train(w, dtype, rate):
    """``F.dropout`` / ``F.layer_norm`` / ``F.linear`` / ``F.gelu`` (torch's
    own dropout bits) and its autograd backward: the same work from
    PyTorch's library calls, a yardstick only."""
    leaves = [w[k].to(dtype) for k in ("n1s", "n1b", "b1", "b2", "n2s", "n2b")]
    leaves += [w["w1"].t().contiguous().to(dtype), w["w2"].t().contiguous().to(dtype)]
    leaves = [t.requires_grad_() for t in leaves]
    n1s, n1b, b1, b2, n2s, n2b, w1, w2 = leaves
    approximate = "tanh" if dtype == torch.bfloat16 else "none"

    def forward(x, a):
        u = F.layer_norm(x + F.dropout(a, rate), (H,), n1s, n1b, EPS)
        h = F.dropout(F.gelu(F.linear(u, w1, b1), approximate=approximate), rate)
        return F.layer_norm(u + F.dropout(F.linear(h, w2, b2), rate), (H,), n2s, n2b, EPS)

    def backward(y, x, a, g):
        return torch.autograd.grad(y, [x, a, *leaves], g, retain_graph=True)

    return forward, backward


def _tail_inputs(tokens, dtype, gen, device, ragged):
    """x, attn, a cotangent (1e30 on dead tokens, which the backward must not
    read) and the live flags (None, or ~70 % live with a dead first block)."""
    x = torch.randn((tokens, H), generator=gen).to(device, dtype)
    a = (0.5 * torch.randn((tokens, H), generator=gen)).to(device, dtype)
    g = torch.randn((tokens, H), generator=gen)
    live = None
    if ragged:
        live = torch.rand(tokens, generator=gen) < 0.7
        live[:40] = False
        g[~live] = 1e30
        live = live.to(device)
    return x, a, g.to(device, dtype), live


def _check_tail_case(label, x, a, g, live, weights, cfg, dtype):
    """One case of the fused train tail's four kernels against their plain
    versions: y, r2, dr2, dx and dattn within OP_TOL, dead tokens' exact
    zeros; dx and dattn within TAIL_BWD_REL, dr2 and the eight summed
    gradients within TAIL_SUM_REL in relative norm; no NaN; two launches of
    the forward and of the whole backward bit-identical. The row kernel runs
    on the plain r2, the input kernel on the plain dr2, the weight kernel on
    the input kernel's scratch. Returns the largest elementwise error of each
    kernel's first output (y, dr2, dx, dW1)."""
    from stlt_tpu_torch.ops import fused_tail_train as ftt

    tol = OP_TOL[dtype]
    tokens = x.shape[0]
    mask = (torch.ones(tokens, dtype=torch.bool, device=x.device) if live is None
            else live)[:, None].expand(tokens, H)
    y, r2 = ftt._launch_tail_train(x, a, weights, cfg, live)
    again = ftt._launch_tail_train(x, a, weights, cfg, live)
    want_y, want_r2 = ftt.fused_layer_tail_train_plain(x, a, weights, cfg, live)
    torch.cuda.synchronize()
    errs = {"y": _check_close(f"fused_layer_tail_train y {label}", y, want_y, mask, tol),
            "r2": _check_close(f"fused_layer_tail_train r2 {label}", r2, want_r2, mask, tol)}
    if not (torch.equal(y, again[0]) and torch.equal(r2, again[1])):
        raise AssertionError(f"fused_layer_tail_train {label}: two launches differ")
    del y, r2, again, want_y

    row = ftt._launch_bwd_row(want_r2, g, weights[6], cfg, live)
    want_row = ftt.tail_train_bwd_row_plain(want_r2, g, weights[6], cfg, live)
    inp = ftt._launch_bwd_input(x, a, want_row[0], weights, cfg, live)
    want_inp = ftt.tail_train_bwd_input_plain(x, a, want_row[0], weights, cfg, live)
    wgt = ftt._launch_bwd_weight(inp[4])
    want_wgt = ftt.tail_train_bwd_weight_plain(x, a, want_row[0], weights, cfg)
    torch.cuda.synchronize()
    errs["dr2"] = _check_close(f"fused_tail_train_bwd_row dr2 {label}", row[0], want_row[0], mask, tol)
    errs["dx"] = _check_close(f"fused_tail_train_bwd_input dx {label}", inp[0], want_inp[0], mask, tol)
    errs["dattn"] = _check_close(f"fused_tail_train_bwd_input dattn {label}", inp[1], want_inp[1],
                                 mask, tol)
    errs["dw1"] = (wgt[0] - want_wgt[0]).abs().max().item()
    got = (*inp[:4], *wgt, row[3], row[1], row[2])  # TAIL_GRADS' order
    want = (*want_inp, *want_wgt, want_row[3], want_row[1], want_row[2])
    rel = {name: _rel(p, q) for name, p, q in zip(TAIL_GRADS, got, want)}
    rel["dr2"] = _rel(row[0], want_row[0])
    limits = {name: TAIL_BWD_REL[dtype] if name in ("dx", "dattn") else TAIL_SUM_REL[dtype]
              for name in rel}
    over = {name: e for name, e in rel.items() if not e <= limits[name]}
    if over or not all(torch.isfinite(t).all() for t in (*got, row[0])):
        raise AssertionError(f"fused train tail backward {label}: relative norm errors "
                             f"over their limits {over} (all: {rel})")
    del row, want_row, inp, want_inp, wgt, want_wgt, got, want
    whole = ftt._launch_tail_train_bwd(x, a, want_r2, g, weights, cfg, live)
    if not all(torch.equal(p, q) for p, q in
               zip(whole, ftt._launch_tail_train_bwd(x, a, want_r2, g, weights, cfg, live))):
        raise AssertionError(f"fused train tail backward {label}: two launches differ")
    log(f"kernel_check fused_train_tail {label}: max_abs_err {json.dumps(errs)}, relative "
        f"norm errors {json.dumps(rel)} (dx/dattn limit {TAIL_BWD_REL[dtype]}, others "
        f"{TAIL_SUM_REL[dtype]}), dead tokens zero, no NaN, two launches bit-identical")
    return {"fused_layer_tail_train": errs["y"], "fused_tail_train_bwd_row": errs["dr2"],
            "fused_tail_train_bwd_input": errs["dx"], "fused_tail_train_bwd_weight": errs["dw1"]}


def check_tail_train_kernels(device):
    """The fused train tail's four kernels against their plain versions
    (``_check_tail_case``), bf16 and f32: at 2,056 tokens (8 clips of 257
    frames) with dropout 0 and 0.1, GELU (erf in f32, tanh in bf16) with full
    and ragged live tokens, ReLU with ragged ones; at 8,224 ragged tokens
    with GELU and dropout 0.1 (the weight products in three splits). Then, in
    bf16 with dropout 0.1 and every token live, at each of TAIL_SHAPES: the
    same check (264 row blocks, up to 17 splits), each kernel timed against
    its plain version, the library yardstick (the backward's once, for rows
    12-14 jointly) and its bound, and the op-level A/B, the fused op's
    forward and backward against the layer's plain chain. Returns the
    kernel-table rows (the 256-frame spatial shape)."""
    from stlt_tpu_torch.models.layers import TransformerEncoderLayer
    from stlt_tpu_torch.ops import fused_tail_train as ftt

    gen = torch.Generator().manual_seed(SEED + 7)
    w = make_weights(gen, device)
    weights = _tail_weights(w)
    seed = 0x5EED5EED
    cases = [("gelu", rate, ragged, 8 * 257) for rate in (0.0, DROPOUT) for ragged in (False, True)]
    cases += [("relu", DROPOUT, True, 8 * 257), ("gelu", DROPOUT, True, 32 * 257)]
    for dtype in (torch.bfloat16, torch.float32):
        for activation, rate, ragged, tokens in cases:
            x, a, g, live = _tail_inputs(tokens, dtype, gen, device, ragged)
            cfg = ftt.TailConfig(EPS, activation, activation == "gelu" and dtype == torch.bfloat16,
                                 rate, seed if rate else None)
            label = f"{dtype} tokens={tokens} {activation} rate={rate} {'ragged' if ragged else 'full'}"
            _check_tail_case(label, x, a, g, live, weights, cfg, dtype)
            del x, a, g, live
            torch.cuda.empty_cache()

    # At the main path's shapes (bf16, dropout 0.1, every token live): the
    # check, the timings, and the op-level A/B against the layer's plain chain.
    dtype = torch.bfloat16
    layer = TransformerEncoderLayer(H, HEADS, FF, activation="gelu", layer_norm_eps=EPS, dtype=dtype,
                                    generator=torch.Generator().manual_seed(SEED),
                                    dropout_rate=DROPOUT).to(device).train()
    with torch.no_grad():
        for mod, wk, bk in ((layer.linear1, "w1", "b1"), (layer.linear2, "w2", "b2")):
            mod.weight.copy_(w[wk].t())
            mod.bias.copy_(w[bk])
        for mod, sk, bk in ((layer.norm1, "n1s", "n1b"), (layer.norm2, "n2s", "n2b")):
            mod.weight.copy_(w[sk])
            mod.bias.copy_(w[bk])
    cfg = ftt.TailConfig(EPS, "gelu", True, DROPOUT, seed)
    lib_f, lib_b = library_tail_train(w, dtype, DROPOUT)
    table = {}
    for shape, tokens in TAIL_SHAPES:
        x, a, g, _ = _tail_inputs(tokens, dtype, gen, device, False)
        errs = _check_tail_case(f"{dtype} {shape} tokens={tokens} gelu rate={DROPOUT} full",
                                x, a, g, None, weights, cfg, dtype)
        torch.cuda.empty_cache()
        bounds = tail_train_bounds(tokens, tokens, dtype)
        r2 = ftt._launch_tail_train(x, a, weights, cfg)[1]
        dr2 = ftt._launch_bwd_row(r2, g, weights[6], cfg)[0]
        scratch = ftt._launch_bwd_input(x, a, dr2, weights, cfg)[4]
        xl, al = x.detach().requires_grad_(), a.detach().requires_grad_()
        y_lib = lib_f(xl, al)
        runs = {
            "fused_layer_tail_train": (lambda: ftt._launch_tail_train(x, a, weights, cfg),
                                       lambda: ftt.fused_layer_tail_train_plain(x, a, weights, cfg),
                                       lambda: lib_f(x, a)),
            "fused_tail_train_bwd_row": (lambda: ftt._launch_bwd_row(r2, g, weights[6], cfg),
                                         lambda: ftt.tail_train_bwd_row_plain(r2, g, weights[6], cfg),
                                         lambda: lib_b(y_lib, xl, al, g)),
            "fused_tail_train_bwd_input": (lambda: ftt._launch_bwd_input(x, a, dr2, weights, cfg),
                                           lambda: ftt.tail_train_bwd_input_plain(x, a, dr2, weights,
                                                                                  cfg),
                                           None),
            "fused_tail_train_bwd_weight": (lambda: ftt._launch_bwd_weight(scratch),
                                            lambda: ftt.tail_train_bwd_weight_plain(x, a, dr2, weights,
                                                                                    cfg),
                                            None),
        }
        for name, (kernel, plain, library) in runs.items():
            row = {
                "name": name, "shape": shape, "tokens": tokens, "dtype": "bfloat16", "rate": DROPOUT,
                "max_abs_err": errs[name], "ms": cuda_ms(kernel, 10), "plain_ms": cuda_ms(plain, 2),
                # The backward's yardstick is one autograd backward: rows 12-14 jointly.
                "library_ms": None if library is None else cuda_ms(library, 5),
                "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            }
            log("kernel_check " + json.dumps(row))
            if shape == TAIL_SHAPES[0][0]:
                table[name] = row
        del y_lib
        # The op-level A/B: the fused op (four kernels) against the layer's
        # plain chain, forward and backward, on the same inputs and seed.
        x3, a3, g3 = xl[None], al[None], g[None]
        fused = lambda: layer._fused_train_tail(x3, a3, seed, None, None).backward(g3)
        chain = lambda: layer._train_tail(x3, a3, seed).backward(g3)
        ab = {"shape": shape, "tokens": tokens, "fused_ms": cuda_ms(fused, 5),
              "chain_ms": cuda_ms(chain, 5)}
        ab["chain_over_fused"] = ab["chain_ms"] / ab["fused_ms"]
        log("tail_ab " + json.dumps(ab))
        del x, a, g, r2, dr2, scratch, xl, al, runs, x3, a3, g3
        torch.cuda.empty_cache()
    return table


# --- phase 2, the fusion models' kernels: row 5 and row 8's dense-bias mode ---


def cross_bound(x, ctx, bias, dtype):
    """(ms, "bytes" | "operations") for fused_cross_attention on these
    inputs: the q, kv and out projections (2 * H * H flops a query token for
    q and for out, 2 * H * 2H a context token) and 4 * T * S * H flops of
    attention a clip, against x, ctx, the weights and the bias read once and
    the output written once."""
    B, T, _ = x.shape
    S = ctx.shape[1]
    es = x.element_size()
    flops = B * (4 * T * H * H + 4 * S * H * H + 4 * T * S * H)
    nbytes = (2 * B * T * H + B * S * H + 4 * H * H + 4 * H) * es
    nbytes += 0 if bias is None else bias.numel() * 4
    return _bound(flops, nbytes, dtype)


def library_cross(w, dtype):
    """``F.linear`` + ``scaled_dot_product_attention`` + ``F.linear`` for
    the cross-attention sublayer: a yardstick only, never called by the port."""
    wq, bq = w["wq"].t().contiguous().to(dtype), w["bq"].to(dtype)
    wkv, bkv = w["wkv"].t().contiguous().to(dtype), w["bkv"].to(dtype)
    wo, bo = w["wo"].t().contiguous().to(dtype), w["bo"].to(dtype)
    D = H // HEADS

    def run(x, ctx, bias):
        B, T, _ = x.shape
        S = ctx.shape[1]
        q = F.linear(x, wq, bq).view(B, T, HEADS, D).transpose(1, 2)
        k, v = F.linear(ctx, wkv, bkv).view(B, S, 2, HEADS, D).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=None if bias is None else bias.to(dtype))
        return F.linear(o.transpose(1, 2).reshape(B, T, H), wo, bo)

    return run


def dense_bound(q, k, bias, dtype):
    """(ms, "bytes" | "operations") for the blockwise kernel in dense-bias
    mode: 4 * D flops per (query, key, head) whose bias lets the key through
    (what this bias needs; chunks the causal skip drops are all masked),
    against q, k, v and the bias read once and out and lse written once."""
    B, T, N, D = q.shape
    S = k.shape[1]
    pairs = B * T * S if bias is None else float((bias > -1e8).expand(B, 1, T, S).sum())
    flops = 4 * D * N * pairs
    nbytes = (2 * B * T * N * D + 2 * B * S * N * D) * q.element_size() + B * N * T * 4
    nbytes += 0 if bias is None else bias.numel() * 4
    return _bound(flops, nbytes, dtype)


# (T, S) of the cross-attention checks: the fusion models' two directions at
# 32 frames (17 layout tokens, 33 appearance tokens) and both ends of the
# kernel's range.
CROSS_SHAPES = ((17, 33), (33, 17), (8, 64), (64, 8))
# The dense-bias blockwise checks at 512 layout frames (513 tokens against
# the 33 appearance tokens): (T, S, bias, causal flag).
DENSE_CASES = ((513, 513, "causal_padding", False), (513, 513, "causal_padding", True),
               (513, 33, "none", False), (33, 513, "key_padding", False))
FUSION_BATCHES = (BATCH, THROUGHPUT_BATCH)
DENSE_BATCHES = (16, 32)


def check_fusion_kernels(device):
    """The fusion models' kernels against their plain versions, bf16 and
    f32, each timed against its plain version, the library yardstick and its
    bound: ``fused_cross_attention`` at CROSS_SHAPES with and without a
    key-padding bias at B = 64 and 1024; the blockwise kernel's dense-bias
    mode at DENSE_CASES and B = 16 and 32 (out and lse); and the layer
    tail's ReLU / eps 1e-5 variant of the appearance encoder at T = 33.
    Returns the bf16 rows of the kernel table: the cross-attention at
    (17, 33), B = 64, and the dense-bias mode at 513 x 513 without the
    causal flag (the fusion layout self-attention), B = 16."""
    from stlt_tpu_torch.ops import flash
    from stlt_tpu_torch.ops import fused_encoder as fe
    from stlt_tpu_torch.ops import masks

    gen = torch.Generator().manual_seed(SEED + 6)
    w = make_weights(gen, device)
    w.update(wq=w["wqkv"][:, :H], bq=w["bqkv"][:H], wkv=w["wqkv"][:, H:], bkv=w["bqkv"][H:])
    table = {}
    for dtype in (torch.bfloat16, torch.float32):
        tol = OP_TOL[dtype]
        lib = library_cross(w, dtype)
        for clips in FUSION_BATCHES:
            for T, S in CROSS_SHAPES:
                for padded in (False, True):
                    x = torch.randn((clips, T, H), generator=gen).to(device, dtype)
                    ctx = torch.randn((clips, S, H), generator=gen).to(device, dtype)
                    bias = None
                    if padded:
                        lengths = torch.randint(1, S + 1, (clips,), generator=gen)
                        pad = torch.arange(S)[None, :] >= lengths[:, None]
                        bias = masks.key_padding_bias(pad).to(device)  # [B, 1, 1, S]
                    args = (x, ctx, w["wq"], w["bq"], w["wkv"], w["bkv"], w["wo"], w["bo"], bias)
                    kw = dict(num_heads=HEADS, compute_dtype=dtype)
                    row = _measure(
                        "fused_cross_attention", "padded" if padded else "unpadded", dtype, clips, x,
                        lambda: fe.fused_cross_attention(*args, **kw),
                        lambda: fe.fused_cross_attention_plain(*args, **kw),
                        lambda: lib(x, ctx, bias), cross_bound(x, ctx, bias, dtype),
                        torch.ones(x.shape, dtype=torch.bool, device=device), tol,
                        rel_tol=CROSS_REL if dtype == torch.bfloat16 else None, S=S,
                    )
                    if (dtype, clips, T, S, padded) == (torch.bfloat16, BATCH, 17, 33, False):
                        table["fused_cross_attention"] = row
                    del x, ctx, bias
        for clips in DENSE_BATCHES:
            for T, S, kind, causal in DENSE_CASES:
                q, k, v = (torch.randn((clips, L, HEADS, H // HEADS), generator=gen).to(device, dtype)
                           for L in (T, S, S))
                lengths = torch.randint(1, S + 1, (clips,), generator=gen)
                lengths[0] = S
                if kind == "causal_padding":
                    bias = _causal_padding_bias(lengths, T, device)  # [B, 1, T, T]
                elif kind == "key_padding":
                    bias = masks.key_padding_bias(torch.arange(S)[None, :] >= lengths[:, None]).to(device)
                else:
                    bias = None
                kw = dict(bias=bias, causal=causal)
                out, lse = flash.blockwise_attention(q, k, v, **kw)
                want, want_lse = flash.blockwise_attention_plain(q, k, v, **kw)
                torch.cuda.synchronize()
                everything = torch.ones_like(lse, dtype=torch.bool)
                lse_err = _check_close(f"blockwise_attention_dense lse {dtype} B={clips} {T}x{S}",
                                       lse, want_lse, everything, OP_TOL[torch.float32])
                library = library_attention(q, k, v, None if bias is None else bias.to(dtype))
                row = _measure(
                    "blockwise_attention_dense", f"{T}x{S} {kind}{' causal' if causal else ''}",
                    dtype, clips, q,
                    lambda: flash.blockwise_attention(q, k, v, **kw)[0],
                    lambda: flash.blockwise_attention_plain(q, k, v, **kw)[0],
                    library, dense_bound(q, k, bias, dtype),
                    torch.ones(q.shape, dtype=torch.bool, device=device), tol,
                    rel_tol=DENSE_REL if dtype == torch.bfloat16 else None, S=S,
                    lse_max_abs_err=lse_err,
                )
                if (dtype, clips, T, S, kind, causal) == (torch.bfloat16, 16, 513, 513,
                                                          "causal_padding", False):
                    table["blockwise_attention_dense"] = row
                del q, k, v, out, lse, want, want_lse, bias
        torch.cuda.empty_cache()

        # The appearance encoder's layer tail: ReLU, eps 1e-5, T = 33.
        x, a = (torch.randn((BATCH, LONG_FRAMES, H), generator=gen).to(device, dtype) for _ in range(2))
        tail_args = (x, a, w["n1s"], w["n1b"], w["w1"], w["b1"], w["w2"], w["b2"], w["n2s"], w["n2b"])
        tail_kw = dict(eps=1e-5, compute_dtype=dtype, activation="relu")
        _measure("fused_layer_tail", "appearance relu", dtype, BATCH, x,
                 lambda: fe.fused_layer_tail(*tail_args, **tail_kw),
                 lambda: fe.fused_layer_tail_plain(*tail_args, **tail_kw),
                 lambda: library_tail(w, dtype, "relu", 1e-5)(x, a),
                 tail_bound(x, torch.ones(x.shape[:2], dtype=torch.bool), dtype),
                 torch.ones(x.shape, dtype=torch.bool, device=device), tol)
    return table


def dense_bwd_bound(q, k, bias, dtype):
    """(ms, "bytes" | "operations") for the blockwise backward in dense-bias
    mode: 10 * D flops per (query, key, head) whose bias lets the key through
    (five products; chunks the causal skip drops are all masked), against q,
    k, v, dO, lse, dsum and the bias read once and dq, dk, dv written once."""
    B, T, N, D = q.shape
    S = k.shape[1]
    pairs = B * T * S if bias is None else float((bias > -1e8).expand(B, 1, T, S).sum())
    flops = 10 * D * N * pairs
    nbytes = (3 * B * T + 4 * B * S) * N * D * q.element_size()  # q, dO, dq; k, v, dk, dv
    nbytes += 2 * B * N * T * 4 + (0 if bias is None else bias.numel() * 4)
    return _bound(flops, nbytes, dtype)


def _dense_bias(kind, lengths, T, S, device):
    """The fusion layers' dense biases at 512 layout frames: the layout
    self-attention's causal+padding [B, 1, T, T], the appearance <- layout
    key padding [B, 1, 1, S], or none (layout <- appearance)."""
    from stlt_tpu_torch.ops import masks

    if kind == "causal_padding":
        return _causal_padding_bias(lengths, T, device)
    if kind == "key_padding":
        return masks.key_padding_bias(torch.arange(S)[None, :] >= lengths[:, None]).to(device)
    return None


# (T, S) of the train cross-attention on the short kernels: 17 layout tokens
# against 33 appearance tokens and back.
SHORT_CROSS_SHAPES = ((17, 33), (33, 17))


def check_fusion_train_kernels(device):
    """The fusion models' train-path attention kernels against their plain
    versions, bf16 and f32: the short kernel's forward (with dropout and
    lse) and backward at the train cross-attention's (T, S) = (17, 33) and
    (33, 17), B = 32; the blockwise kernels' dense-bias mode at DENSE_CASES,
    B = 16 and 32, dropout 0 and 0.1: the forward with dropout (f32 within
    FWD_DROP_TOL, which needs equal keep bits) and lse, the backward against
    ``attention_bwd_plain`` within DENSE_BWD_REL (bf16) or BWD_REL (f32),
    two launches bit-identical. Then the dense backward timed at each of
    DENSE_CASES at B = 16 with dropout 0.1 (training's), against its plain
    version, the autograd backward of ``scaled_dot_product_attention`` with
    the same mask and its bound. Returns the bf16 row of the kernel table:
    513 x 513 without the causal flag (the fusion layout self-attention)."""
    from stlt_tpu_torch.ops import flash
    from stlt_tpu_torch.ops import masks

    gen = torch.Generator().manual_seed(SEED + 8)
    seed = 0xF05EF05E
    table = {}
    D = H // HEADS
    for dtype in (torch.bfloat16, torch.float32):
        fwd_tol = FWD_DROP_TOL if dtype == torch.float32 else OP_TOL[dtype]
        rel_tol = DENSE_BWD_REL if dtype == torch.bfloat16 else BWD_REL[dtype]
        clips = FUSION_TRAIN[16][0]
        for T, S in SHORT_CROSS_SHAPES:
            for rate in (0.0, DROPOUT):
                q, k, v, dout = (torch.randn((clips, L, HEADS, D), generator=gen).to(device, dtype)
                                 for L in (T, S, S, T))
                lengths = torch.randint(1, S + 1, (clips,), generator=gen)
                bias = masks.key_padding_bias(torch.arange(S)[None, :] >= lengths[:, None]).to(device)
                kw = dict(dropout_rate=rate, dropout_seed=seed if rate else None)
                out, lse = flash.fused_attention(q, k, v, bias, with_lse=True, **kw)
                want, want_lse = flash.fused_attention_plain(q, k, v, bias, with_lse=True, **kw)
                dsum = flash._dsum(dout, out, None)
                run = lambda: flash.fused_attention_bwd(q, k, v, dout, lse, dsum, bias, **kw)
                got, again = run(), run()
                want_grads = flash.attention_bwd_plain(q, k, v, dout, lse, dsum, bias=bias, **kw)
                torch.cuda.synchronize()
                label = f"flash_attention cross {dtype} B={clips} {T}<-{S} rate={rate}"
                everything = torch.ones_like(out, dtype=torch.bool)
                err = _check_close(label, out, want, everything, fwd_tol)
                lse_err = _check_close(f"{label} lse", lse, want_lse, torch.ones_like(lse, dtype=torch.bool),
                                       OP_TOL[torch.float32])
                gerr, rel = _check_grads(f"flash_attention_bwd cross {dtype} B={clips} {T}<-{S} "
                                         f"rate={rate}", got, want_grads, None, dtype)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"{label}: two backward launches differ")
                log(f"kernel_check {label}: max_abs_err out {err:.3e}, lse {lse_err:.3e}; backward "
                    f"max_abs_err {gerr:.3e}, relative norm errors {json.dumps(rel)}, bit-identical")
                del q, k, v, dout, out, lse, want, want_lse, dsum, got, again, want_grads
        for clips in DENSE_BATCHES:
            for T, S, kind, causal in DENSE_CASES:
                for rate in (0.0, DROPOUT):
                    q, k, v, dout = (torch.randn((clips, L, HEADS, D), generator=gen).to(device, dtype)
                                     for L in (T, S, S, T))
                    lengths = torch.randint(1, S + 1, (clips,), generator=gen)
                    lengths[0] = S
                    bias = _dense_bias(kind, lengths, T, S, device)
                    kw = dict(bias=bias, causal=causal, dropout_rate=rate,
                              dropout_seed=seed if rate else None)
                    out, lse = flash.blockwise_attention(q, k, v, **kw)
                    want, want_lse = flash.blockwise_attention_plain(q, k, v, **kw)
                    dsum = flash._dsum(dout, out, None)
                    run = lambda: flash.blockwise_attention_bwd(q, k, v, dout, lse, dsum, **kw)
                    got, again = run(), run()
                    want_grads = flash.attention_bwd_plain(q, k, v, dout, lse, dsum, **kw)
                    torch.cuda.synchronize()
                    label = (f"blockwise_attention_bwd_dense {dtype} B={clips} {T}x{S} {kind}"
                             f"{' causal' if causal else ''} rate={rate}")
                    everything = torch.ones_like(out, dtype=torch.bool)
                    err = _check_close(f"{label} forward", out, want, everything, fwd_tol)
                    lse_err = _check_close(f"{label} lse", lse, want_lse,
                                           torch.ones_like(lse, dtype=torch.bool), OP_TOL[torch.float32])
                    gerr, rel = _check_grads(label, got, want_grads, None, dtype, rel_tol)
                    if not all(torch.equal(a, b) for a, b in zip(got, again)):
                        raise AssertionError(f"{label}: two launches differ")
                    log(f"kernel_check {label}: forward max_abs_err {err:.3e} (atol {fwd_tol['atol']}), "
                        f"lse {lse_err:.3e}; backward max_abs_err {gerr:.3e}, relative norm errors "
                        f"{json.dumps(rel)} (limit {rel_tol}), no NaN, two launches bit-identical")
                    del q, k, v, dout, out, lse, want, want_lse, dsum, got, again, want_grads, bias
        torch.cuda.empty_cache()

        # Timing at the fusion train step's shapes (B = 16, dropout 0.1).
        clips = DENSE_BATCHES[0]
        for T, S, kind, causal in DENSE_CASES:
            q, k, v, dout = (torch.randn((clips, L, HEADS, D), generator=gen).to(device, dtype)
                             for L in (T, S, S, T))
            lengths = torch.randint(1, S + 1, (clips,), generator=gen)
            lengths[0] = S
            bias = _dense_bias(kind, lengths, T, S, device)
            kw = dict(bias=bias, causal=causal, dropout_rate=DROPOUT, dropout_seed=seed)
            out, lse = flash.blockwise_attention(q, k, v, **kw)
            dsum = flash._dsum(dout, out, None)
            run = lambda: flash.blockwise_attention_bwd(q, k, v, dout, lse, dsum, **kw)
            plain = lambda: flash.attention_bwd_plain(q, k, v, dout, lse, dsum, **kw)
            got, want = run(), plain()
            torch.cuda.synchronize()
            label = f"blockwise_attention_bwd_dense {dtype} B={clips} {T}x{S} {kind}"
            err, rel = _check_grads(label, got, want, None, dtype, rel_tol)
            mask = None if bias is None else bias.to(dtype)
            bound = dense_bwd_bound(q, k, bias, dtype)
            row = {
                "name": "blockwise_attention_bwd_dense", "stage": "fusion",
                "dtype": str(dtype).split(".")[1], "clips": clips, "T": T, "S": S, "bias": kind,
                "causal": causal, "rate": DROPOUT, "max_abs_err": err, "rel_err": rel,
                "tol": OP_TOL[dtype], "rel_tol": rel_tol, "ms": cuda_ms(run, 10),
                "plain_ms": cuda_ms(plain, 3),
                "library_ms": cuda_ms(library_attention_bwd(q, k, v, mask, dout, DROPOUT), 10),
                "bound_ms": bound[0], "bound_by": bound[1],
            }
            log("kernel_check " + json.dumps(row))
            if (dtype, T, S, kind, causal) == (torch.bfloat16, 513, 513, "causal_padding", False):
                table["blockwise_attention_bwd_dense"] = row
            del q, k, v, dout, out, lse, dsum, got, want, bias, mask
            torch.cuda.empty_cache()
    return table


# --- phase 3: the main path through the prediction entry point ----------------


def write_something_dataset(root: str, num_videos: int, seed: int, num_used: int = NUM_CLASSES,
                            frames_range=(3, 25)):
    """A synthetic dataset in the Something-Else layout schema (174 labels,
    of which the clips use the first ``num_used``; hand/object boxes, a
    frame count a clip drawn from ``frames_range`` (3..24 by default, so
    sampled lengths are ragged)). Returns the paths of {dataset, labels,
    videoid2size}."""
    rng = np.random.default_rng(seed)
    templates = [f"Doing something {i}" for i in range(NUM_CLASSES)]
    labels = {t: str(i) for i, t in enumerate(templates)}
    videos, sizes = [], {}
    for v in range(num_videos):
        vid = str(100000 + v)
        width, height = int(rng.integers(200, 480)), int(rng.integers(150, 360))
        sizes[vid] = [width, height]
        frames = []
        for _ in range(int(rng.integers(*frames_range))):
            objs = []
            for _ in range(int(rng.integers(0, 8))):
                x1, y1 = rng.uniform(0, width - 2), rng.uniform(0, height - 2)
                objs.append({
                    "category": "hand" if rng.random() < 0.4 else "object",
                    "x1": float(x1), "y1": float(y1),
                    "x2": float(x1 + rng.uniform(1, width - x1)),
                    "y2": float(y1 + rng.uniform(1, height - y1)),
                    "score": float(rng.uniform(0.3, 1.0)),
                })
            frames.append({"frame_objects": objs})
        videos.append({"id": vid, "template": templates[int(rng.integers(num_used))],
                       "frames": frames})
    paths = {name: os.path.join(root, f"{name}.json")
             for name in ("dataset", "labels", "videoid2size")}
    for name, obj in (("dataset", videos), ("labels", labels), ("videoid2size", sizes)):
        with open(paths[name], "w") as f:
            json.dump(obj, f)
    return paths


def run_main_path(device):
    from stlt_tpu_torch.configs import DataConfig, make_model_config, position_table_rows
    from stlt_tpu_torch.data import collaters_factory, datasets_factory
    from stlt_tpu_torch.data.loader import Loader, to_device
    from stlt_tpu_torch.models import models_factory
    from stlt_tpu_torch import predict
    from stlt_tpu_torch.utils.convert import load_checkpoint

    with tempfile.TemporaryDirectory(prefix="stlt_chip_smoke_") as root:
        paths = write_something_dataset(root, BATCH * NUM_BATCHES, SEED)
        data_cfg = DataConfig(dataset_name="something", dataset_path=paths["dataset"],
                              labels_path=paths["labels"],
                              videoid2size_path=paths["videoid2size"])
        model_kw = dict(
            num_classes=NUM_CLASSES, unique_categories=4, hidden_size=H,
            num_attention_heads=HEADS, num_spatial_layers=SPATIAL_LAYERS,
            num_temporal_layers=TEMPORAL_LAYERS, compute_dtype="bfloat16",
            layout_num_frames=position_table_rows(data_cfg),
        )
        model = models_factory["stlt"](
            make_model_config("stlt", **model_kw), torch.Generator().manual_seed(SEED)
        )
        ckpt = os.path.join(root, "stlt_random.pt")
        torch.save(model.state_dict(), ckpt)
        del model
        out = os.path.join(root, "predictions.jsonl")
        argv = [
            "--dataset_name", "something", "--dataset_type", "layout", "--model_name", "stlt",
            "--test_dataset_path", paths["dataset"], "--labels_path", paths["labels"],
            "--videoid2size_path", paths["videoid2size"], "--checkpoint_path", ckpt,
            "--hidden_size", str(H), "--num_attention_heads", str(HEADS),
            "--num_spatial_layers", str(SPATIAL_LAYERS),
            "--num_temporal_layers", str(TEMPORAL_LAYERS),
            "--batch_size", str(BATCH), "--compute_dtype", "bfloat16", "--use_pallas",
            "--output", out, "--top_k", "5",
        ]

        reset_all_launches()
        t0 = time.perf_counter()
        rows = predict.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = all_launches()
        log(f"predict: {len(rows)} clips in {seconds:.3f} s (checkpoint load included); "
            f"launches {launches}")

        with open(out) as f:
            written = [json.loads(line) for line in f]
        if len(rows) != BATCH * NUM_BATCHES or len(written) != len(rows):
            raise AssertionError(f"predict wrote {len(written)} rows for {BATCH * NUM_BATCHES} clips")
        for row in written:
            scores = [t["score"] for t in row["top_k"]]
            if len(scores) != 5 or not all(math.isfinite(s) and 0 <= s <= 1 for s in scores):
                raise AssertionError(f"bad scores in {row}")
        want = (SPATIAL_LAYERS + TEMPORAL_LAYERS) * NUM_BATCHES
        if any(count for name, count in launches.items() if name not in EVAL_KERNELS):
            raise AssertionError(f"predict launched a train or long-clip kernel: {launches}")
        for name in EVAL_KERNELS:
            if launches[name] != want:
                raise AssertionError(f"{name} launched {launches[name]} times on the main "
                                     f"path, expected {want} (one per layer per batch)")

        # One batch's logits, kernels against the plain path, on the card.
        model = models_factory["stlt"](make_model_config("stlt", **model_kw))
        load_checkpoint(ckpt, model)
        model = model.to(device).eval()
        dataset = datasets_factory["layout"](data_cfg)
        loader = Loader(dataset, BATCH, collaters_factory["layout"](data_cfg), prefetch=0)
        batch = next(iter(to_device(loader, device)))
        batch.pop("labels")
        batch.pop("valid")
        live_fraction = float((batch["frame_types"] != 0).float().mean())
        with torch.inference_mode():
            got = model(batch)["stlt"]
            forward_ms = cuda_ms(lambda: model(batch), 10)
            with plain_eval_path():
                want_logits = model(batch)["stlt"]
                plain_forward_ms = cuda_ms(lambda: model(batch), 10)
        err = (got - want_logits).abs().max().item()
        log(f"logits: shape {tuple(got.shape)}, max|logit| {want_logits.abs().max().item():.4f}, "
            f"max_abs_err kernels vs plain {err:.3e} (atol {LOGITS_ATOL}); "
            f"frame live fraction {live_fraction:.4f}; forward of {BATCH} clips: "
            f"kernels {forward_ms:.3f} ms, plain {plain_forward_ms:.3f} ms")
        if tuple(got.shape) != (BATCH, NUM_CLASSES) or not torch.isfinite(got).all():
            raise AssertionError(f"logits of shape {tuple(got.shape)} or not finite")
        if err > LOGITS_ATOL:
            raise AssertionError(f"logits: kernel path disagrees with the plain path ({err:.3e})")
        return launches


# --- phase 4: the train path through the train entry point -------------------


class plain_kernels:
    """Within the block, the train path's wrappers on the card run their
    plain versions (forward and backward) instead of launching the kernels:
    the train op's, the long-clip attention's forwards and backwards, and
    the fused train tail's forward and backward."""

    def __enter__(self):
        from stlt_tpu_torch.ops import flash
        from stlt_tpu_torch.ops import fused_encoder as fe
        from stlt_tpu_torch.ops import fused_tail_train as ftt

        def plain_fwd(op, x, wqkv, bqkv, wo, bo, bias, *, seed=None, dropout_rate=0.0, **kw):
            return fe.fused_proj_attention_train_plain(x, wqkv, bqkv, wo, bo, bias, seed,
                                                       dropout_rate=dropout_rate, **kw)

        def plain_short_bwd(q, k, v, dout, lse, dsum, bias=None, **kw):
            return flash.attention_bwd_plain(q, k, v, dout, lse, dsum, bias=bias, **kw)

        def plain_blockwise_bwd(q, k, v, dout, lse, dsum, offsets=None, **kw):
            return flash.attention_bwd_plain(q, k, v, dout, lse, dsum, **kw)

        self.swaps = [(fe, "_launch_proj", plain_fwd),
                      (fe, "_launch_proj_bwd", fe.fused_proj_attention_train_bwd_plain),
                      (flash, "fused_attention", flash.fused_attention_plain),
                      (flash, "blockwise_attention", flash.blockwise_attention_plain),
                      (flash, "fused_attention_bwd", plain_short_bwd),
                      (flash, "blockwise_attention_bwd", plain_blockwise_bwd),
                      (ftt, "_launch_tail_train", ftt.fused_layer_tail_train_plain),
                      (ftt, "_launch_tail_train_bwd", ftt.fused_layer_tail_train_bwd_plain)]
        self.saved = [getattr(mod, name) for mod, name, _ in self.swaps]
        for mod, name, plain in self.swaps:
            setattr(mod, name, plain)
        return self

    def __exit__(self, *exc):
        for (mod, name, _), kernel in zip(self.swaps, self.saved):
            setattr(mod, name, kernel)
        return False


def _split_dataset(paths, root, train_clips: int = TRAIN_CLIPS):
    """Train and validation files from one written dataset (shared labels
    and frame sizes): the first ``train_clips`` clips and the rest."""
    with open(paths["dataset"]) as f:
        videos = json.load(f)
    out = {}
    for name, part in (("train", videos[:train_clips]), ("val", videos[train_clips:])):
        out[name] = os.path.join(root, f"{name}.json")
        with open(out[name], "w") as f:
            json.dump(part, f)
    return out


def _one_step(model, batch, criterion):
    """Loss and gradients of one train step from the model's weights."""
    from stlt_tpu_torch.training.loop import step_generator

    model.zero_grad(set_to_none=True)
    inputs = {k: v for k, v in batch.items() if k not in ("labels", "valid")}
    loss = criterion(model(inputs, step_generator(SEED, 0)), batch["labels"], batch["valid"])
    loss.backward()
    return loss.detach(), {n: p.grad.detach().clone() for n, p in model.named_parameters()
                           if p.grad is not None}


def _step_kernels_vs_plain(label, model, batch, criterion, limits=None) -> None:
    """One step from the same weights, batch and seeds through the kernels
    and through the plain path on the card: loss within STEP_LOSS_ATOL, each
    gradient within STEP_TENSOR_REL and all of them joined within
    STEP_GRAD_REL in relative norm. ``limits`` (loss atol, joined, each, each
    in the appearance branch) replaces them (phase 8)."""
    loss_atol, joined, each, each_appearance = limits or (
        STEP_LOSS_ATOL, STEP_GRAD_REL, STEP_TENSOR_REL, STEP_TENSOR_REL)
    # The same cuDNN algorithms in both passes (the R3D convolutions), so the
    # two differ by the kernels alone.
    saved = torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = False, True
    try:
        loss_k, grads_k = _one_step(model, batch, criterion)
        with plain_kernels():
            loss_p, grads_p = _one_step(model, batch, criterion)
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = saved
    flat_k = torch.cat([grads_k[n].float().flatten() for n in grads_p])
    flat_p = torch.cat([grads_p[n].float().flatten() for n in grads_p])
    rel = _rel(flat_k, flat_p)
    per_tensor = {n: _rel(grads_k[n], grads_p[n]) for n in grads_p}
    limit = {n: each_appearance if "appearance_branch." in n else each for n in per_tensor}
    over = {n: e for n, e in per_tensor.items() if e > limit[n]}
    for group, names in (("appearance branch", [n for n in per_tensor if "appearance_branch." in n]),
                         ("the rest", [n for n in per_tensor if "appearance_branch." not in n])):
        worst = sorted(names, key=per_tensor.get, reverse=True)[:4]
        if worst:
            log(f"{label}, kernels vs plain, {group}: worst tensors "
                + ", ".join(f"{n} {per_tensor[n]:.3e}" for n in worst)
                + f" (tolerance {limit[worst[0]]} each)")
    log(f"{label}, kernels vs plain: loss {loss_k.item():.6f} vs {loss_p.item():.6f} "
        f"(atol {loss_atol}); gradient relative norm error {rel:.3e} "
        f"(tolerance {joined}) over {len(grads_p)} tensors")
    if set(grads_k) != set(grads_p) or abs(loss_k.item() - loss_p.item()) > loss_atol:
        raise AssertionError(f"{label}: kernel path disagrees with the plain path (loss)")
    if not torch.isfinite(flat_k).all() or rel > joined or over:
        raise AssertionError(f"{label}: kernel path disagrees with the plain path "
                             f"(grads; joined {rel:.3e}, tensors over their limit: {over})")


def _train_step(model, criterion):
    from stlt_tpu_torch.training.loop import make_train_step
    from stlt_tpu_torch.training.optimizer import make_optimizer

    optimizer, scheduler = make_optimizer(model, learning_rate=1e-5, weight_decay=1e-3,
                                          num_warmup_steps=1, num_training_steps=100)
    return make_train_step(model, optimizer, scheduler, criterion, 5.0)


def _step_ms(model, batch, criterion, steps: int = 5) -> float:
    """Mean wall time of a whole train step (forward, backward, clip, AdamW),
    synchronised, after two warmup steps."""
    from stlt_tpu_torch.training.loop import step_generator

    step = _train_step(model, criterion)
    for i in range(2):
        step(batch, step_generator(SEED, i))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        step(batch, step_generator(SEED, 2 + i))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


# (group, substrings of the device kernel's name); the train tail's group
# comes before any "fused_tail" one, which would catch its names.
TRAIN_TAIL_GROUP = ("train tail kernels", ("fused_tail_train", "tail_bwd_", "reduce_parts_kernel"))
KERNEL_GROUPS = (
    TRAIN_TAIL_GROUP,
    ("attention forward kernel", ("fused_proj_attn",)),
    ("attention backward kernels", ("fused_proj_bwd", "proj_bwd_dwo", "proj_bwd_finalize")),
    ("long-clip attention forward kernel", ("attention_kernel<",)),
    ("long-clip attention backward kernels", ("attention_dq_kernel", "attention_dkdv_kernel")),
    ("cuBLAS GEMMs", ("gemm", "nvjet", "cutlass", "xmma")),
)
FORWARD_GROUPS = (
    TRAIN_TAIL_GROUP,
    ("fused projection+attention kernel", ("fused_proj_attn",)),
    ("layer tail kernel", ("fused_tail",)),
    ("fused cross-attention kernels", ("cross_attn", "kv_proj")),
    ("long-clip attention kernels", ("attention_kernel<",)),
    ("cuDNN convolutions", ("fprop", "cudnn", "convolve", "implicit_gemm", "conv2d", "conv3d")),
    ("cuBLAS GEMMs", ("gemm", "nvjet", "cutlass", "xmma")),
)
OTHER = "other (elementwise, norms, reductions, copies)"


def _device_profile(label: str, run, groups, **extra) -> None:
    """Device time of one ``run()`` by kernel group (torch.profiler), beside
    its wall time: the device's idle share is 1 - busy / wall. Printed as
    one JSON line."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device events, without the optimizer's annotation range (it spans the
    # AdamW kernels, which are counted themselves).
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.key.startswith("Optimizer.")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not kernels or busy_ms == 0:
        log(f"{label} profile {extra}: device time not measured (no device events)")
        return
    groups_ms = {name: 0.0 for name, _ in groups}
    groups_ms[OTHER] = 0.0
    for e in kernels:
        name = next((g for g, keys in groups if any(k in e.key for k in keys)), OTHER)
        groups_ms[name] += e.self_device_time_total / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    log(f"{label}_profile " + json.dumps({
        **extra, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms), "groups_ms": groups_ms,
        "top_kernels": [{"name": e.key[:80], "calls": e.count,
                         "device_ms": e.self_device_time_total / 1e3} for e in top],
    }))


def _profile_step(model, batch, criterion, clips: int, **extra) -> None:
    """One kernel-path train step of ``clips`` clips, profiled by kernel group."""
    from stlt_tpu_torch.training.loop import step_generator

    step = _train_step(model, criterion)
    step(batch, step_generator(SEED, 0))
    _device_profile("train_step", lambda: step(batch, step_generator(SEED, 1)), KERNEL_GROUPS,
                    clips=clips, **extra)


def run_train_path(device):
    from stlt_tpu_torch import train as port_train
    from stlt_tpu_torch.configs import DataConfig, make_model_config, position_table_rows
    from stlt_tpu_torch.data import collaters_factory, datasets_factory
    from stlt_tpu_torch.data.loader import Loader, to_device
    from stlt_tpu_torch.models import models_factory
    from stlt_tpu_torch.training.criterion import make_criterion
    from stlt_tpu_torch.utils.convert import read_state_dict

    with tempfile.TemporaryDirectory(prefix="stlt_chip_smoke_train_") as root:
        # Five labels in use and a learning rate of 1e-3, so that eight steps
        # lift validation accuracy above 0 and an epoch saves the best
        # checkpoint (an untrained model's top-5 over 174 classes may hit none
        # of 64 clips, and then no epoch is the best one).
        paths = write_something_dataset(root, TRAIN_CLIPS + VAL_CLIPS, SEED + 2, num_used=TRAIN_LABELS)
        split = _split_dataset(paths, root)
        best = os.path.join(root, "best.pt")
        argv = [
            "--dataset_name", "something", "--dataset_type", "layout", "--model_name", "stlt",
            "--train_dataset_path", split["train"], "--val_dataset_path", split["val"],
            "--labels_path", paths["labels"], "--videoid2size_path", paths["videoid2size"],
            "--hidden_size", str(H), "--num_attention_heads", str(HEADS),
            "--num_spatial_layers", str(SPATIAL_LAYERS),
            "--num_temporal_layers", str(TEMPORAL_LAYERS), "--hidden_dropout_prob", str(DROPOUT),
            "--batch_size", str(BATCH), "--epochs", str(TRAIN_EPOCHS), "--warmup_epochs", "1",
            "--learning_rate", "1e-3",
            "--compute_dtype", "bfloat16", "--use_pallas", "--seed", str(SEED),
            "--save_model_path", best,
        ]
        reset_all_launches()
        t0 = time.perf_counter()
        result = port_train.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = all_launches()
        log(f"train: {result.step} steps, {len(result.epochs)} epochs in {seconds:.3f} s "
            f"(data and model set-up included); launches {launches}")
        for record in result.epochs:
            log("train_epoch " + json.dumps(record))
        records, steps_taken = result.epochs, result.step
        del result  # the trained model and its optimizer state

        steps_per_epoch = TRAIN_CLIPS // BATCH
        val_batches = -(-VAL_CLIPS // BATCH)
        if (len(records) != TRAIN_EPOCHS or steps_taken != TRAIN_EPOCHS * steps_per_epoch
                or not all(math.isfinite(r["train_loss"]) for r in records)):
            raise AssertionError(f"train: bad epoch records {records}")
        if not any(r["is_best"] for r in records):
            raise AssertionError(f"train: no epoch saved a best checkpoint: {records}")
        layers = SPATIAL_LAYERS + TEMPORAL_LAYERS
        want = dict.fromkeys(launches, 0)  # 17 frames: the plain tail, no long-clip kernel
        want.update({name: layers * steps_taken for name in TRAIN_KERNELS})
        want.update({name: layers * val_batches * TRAIN_EPOCHS for name in EVAL_KERNELS})
        if launches != want:
            raise AssertionError(f"train: launches {launches}, expected {want} (12 layers per "
                                 f"train step for each train kernel, per validation batch for "
                                 f"each eval kernel, none of the long-clip or train-tail kernels)")

        data_cfg = DataConfig(dataset_name="something", dataset_path=split["train"],
                              labels_path=paths["labels"], videoid2size_path=paths["videoid2size"],
                              train=True)
        model_kw = dict(
            num_classes=NUM_CLASSES, unique_categories=4, hidden_size=H,
            num_attention_heads=HEADS, num_spatial_layers=SPATIAL_LAYERS,
            num_temporal_layers=TEMPORAL_LAYERS, compute_dtype="bfloat16",
            hidden_dropout_prob=DROPOUT, layout_num_frames=position_table_rows(data_cfg),
        )
        model = models_factory["stlt"](make_model_config("stlt", **model_kw))
        model.load_state_dict(read_state_dict(best), strict=True)
        model = model.to(device).train()
        log(f"train: best checkpoint {os.path.getsize(best)} bytes loads with strict=True")

        # One step from the same weights, batch and seeds: kernels against plain.
        dataset = datasets_factory["layout"](data_cfg)
        loader = Loader(dataset, BATCH, collaters_factory["layout"](data_cfg), prefetch=0)
        batch = next(iter(to_device(loader, device)))
        criterion = make_criterion("something")
        _step_kernels_vs_plain("train step", model, batch, criterion)

        step_ms = {}
        for clips in (BATCH, TRAIN_BATCH):
            big = {k: v.repeat(clips // BATCH, *([1] * (v.dim() - 1))) for k, v in batch.items()}
            ms = _step_ms(model, big, criterion)
            with plain_kernels():
                plain_ms = _step_ms(model, big, criterion)
            step_ms[clips] = {"ms": ms, "plain_ms": plain_ms}
            log(f"train step of {clips} clips (full width, bf16, dropout {DROPOUT}): kernels "
                f"{ms:.3f} ms, plain {plain_ms:.3f} ms")
            _profile_step(model, big, criterion, clips)
            del big
            torch.cuda.empty_cache()
        return launches, step_ms


# --- phase 5: long clips through the prediction and evaluation entry points ---


def reset_all_launches() -> None:
    from stlt_tpu_torch.ops import flash
    from stlt_tpu_torch.ops import fused_encoder as fe
    from stlt_tpu_torch.ops import fused_tail_train as ftt

    fe.reset_launches()
    flash.reset_launches()
    ftt.reset_launches()


def all_launches() -> dict:
    from stlt_tpu_torch.ops import flash
    from stlt_tpu_torch.ops import fused_encoder as fe
    from stlt_tpu_torch.ops import fused_tail_train as ftt

    return {**fe.LAUNCHES, **flash.LAUNCHES, **ftt.LAUNCHES}


class plain_eval_path:
    """Within the block, every eval kernel's wrapper runs its plain version
    on the card (the fused projection+attention, tail and cross-attention,
    the short and the blockwise attention in both its modes)."""

    def __enter__(self):
        from stlt_tpu_torch.ops import flash
        from stlt_tpu_torch.ops import fused_encoder as fe

        self.swaps = [(fe, "fused_proj_attention", fe.fused_proj_attention_plain),
                      (fe, "fused_layer_tail", fe.fused_layer_tail_plain),
                      (fe, "fused_cross_attention", fe.fused_cross_attention_plain),
                      (flash, "fused_attention", flash.fused_attention_plain),
                      (flash, "blockwise_attention", flash.blockwise_attention_plain)]
        self.saved = [getattr(mod, name) for mod, name, _ in self.swaps]
        for mod, name, plain in self.swaps:
            setattr(mod, name, plain)
        return self

    def __exit__(self, *exc):
        for (mod, name, _), kernel in zip(self.swaps, self.saved):
            setattr(mod, name, kernel)
        return False


def _first_batch(data_cfg, batch_size, device, dataset_type="layout"):
    from stlt_tpu_torch.data import collaters_factory, datasets_factory
    from stlt_tpu_torch.data.loader import Loader, to_device

    dataset = datasets_factory[dataset_type](data_cfg)
    loader = Loader(dataset, batch_size, collaters_factory[dataset_type](data_cfg), prefetch=0,
                    workers=8)
    batch = next(iter(to_device(loader, device)))
    return dataset, {k: v for k, v in batch.items() if k not in ("labels", "valid")}


def _served_model(ckpt, model_kw, layout_num_frames, device, name="stlt", **capacities):
    from stlt_tpu_torch.configs import make_model_config
    from stlt_tpu_torch.models import models_factory
    from stlt_tpu_torch.utils.convert import load_checkpoint

    cfg = make_model_config(name, **dict(model_kw, layout_num_frames=layout_num_frames), **capacities)
    model = models_factory[name](cfg)
    load_checkpoint(ckpt, model)
    return model.to(device).eval()


def _check_logits(name, got, want, against):
    err = (got - want).abs().max().item()
    log(f"{name}: logits {tuple(got.shape)}, max|logit| {want.abs().max().item():.4f}, "
        f"max_abs_err {err:.3e} against {against} (atol {LOGITS_ATOL})")
    if not torch.isfinite(got).all() or err > LOGITS_ATOL:
        raise AssertionError(f"{name}: logits not finite or off by {err:.3e} against {against}")


def _kernels_vs_plain(name, model, batch):
    """One batch's logits and forward time through the kernels (with a
    ``torch.profiler`` breakdown by kernel group) and through the plain path
    on the card; the logits of every head are held against the plain path's
    at LOGITS_ATOL. Returns the kernels' logits of the model's last head."""
    with torch.inference_mode():
        got = model(batch)
        ms = cuda_ms(lambda: model(batch), 5)
        _device_profile("forward", lambda: model(batch), FORWARD_GROUPS, name=name)
        with plain_eval_path():
            plain = model(batch)
            plain_ms = cuda_ms(lambda: model(batch), 3)
    for head in model.logit_names:
        _check_logits(f"{name} {head}", got[head], plain[head], "the plain path")
    log(f"{name}: forward kernels {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return got[model.logit_names[-1]]


def run_long_clip_path(device):
    """Serve a random full-width bf16 STLT through ``predict`` at 256 frames
    (every slot live, 2 batches of 64) and 512 frames (clips of 32-256
    frames, 2 batches of 32), then evaluate the 512-frame set through
    ``inference`` with and without ``--live_prefix --use_pallas``. Asserts
    rows, finite scores and metrics, the launch counts of each run, the
    spatial rows of the levers, and one batch's logits against the plain path
    (and, with the levers, against the uncapped model). Returns the long-clip
    kernels' launches of the predict runs."""
    from stlt_tpu_torch import inference, predict
    from stlt_tpu_torch.configs import (DataConfig, frame_capacity_for, make_model_config,
                                        position_table_rows, spatial_live_capacity_for)
    from stlt_tpu_torch.models import models_factory
    from stlt_tpu_torch.ops import fused_encoder as fe

    layers = SPATIAL_LAYERS + TEMPORAL_LAYERS
    model_kw = dict(num_classes=NUM_CLASSES, unique_categories=4, hidden_size=H,
                    num_attention_heads=HEADS, num_spatial_layers=SPATIAL_LAYERS,
                    num_temporal_layers=TEMPORAL_LAYERS, compute_dtype="bfloat16")
    launches = {}
    with tempfile.TemporaryDirectory(prefix="stlt_chip_smoke_long_") as root:
        model = models_factory["stlt"](make_model_config("stlt", **model_kw, layout_num_frames=513),
                                       torch.Generator().manual_seed(SEED + 4))
        ckpt = os.path.join(root, "stlt_random_513.pt")
        torch.save(model.state_dict(), ckpt)
        del model
        for frames, (batch_size, frames_range) in LONG_CLIPS.items():
            sub = os.path.join(root, str(frames))
            os.makedirs(sub)
            paths = write_something_dataset(sub, batch_size * LONG_NUM_BATCHES, SEED + frames,
                                            frames_range=frames_range)
            common = [
                "--dataset_name", "something", "--dataset_type", "layout", "--model_name", "stlt",
                "--test_dataset_path", paths["dataset"], "--labels_path", paths["labels"],
                "--videoid2size_path", paths["videoid2size"], "--checkpoint_path", ckpt,
                "--hidden_size", str(H), "--num_attention_heads", str(HEADS),
                "--num_spatial_layers", str(SPATIAL_LAYERS),
                "--num_temporal_layers", str(TEMPORAL_LAYERS),
                "--layout_num_frames", str(frames), "--batch_size", str(batch_size),
                "--compute_dtype", "bfloat16",
            ]
            out = os.path.join(sub, "predictions.jsonl")
            kernel = "flash_attention" if frames == 256 else "blockwise_attention"
            reset_all_launches()
            t0 = time.perf_counter()
            rows = predict.main(common + ["--use_pallas", "--output", out, "--top_k", "5"])
            torch.cuda.synchronize()
            counts = all_launches()
            log(f"predict {frames} frames: {len(rows)} clips in {time.perf_counter() - t0:.3f} s "
                f"(data and checkpoint load included); launches {counts}")
            if len(rows) != batch_size * LONG_NUM_BATCHES or not all(
                    len(r["top_k"]) == 5 and all(math.isfinite(t["score"]) for t in r["top_k"])
                    for r in rows):
                raise AssertionError(f"predict {frames} frames: bad rows")
            want = dict.fromkeys(counts, 0)
            want.update({"fused_proj_attention": SPATIAL_LAYERS * LONG_NUM_BATCHES,
                         "fused_layer_tail": layers * LONG_NUM_BATCHES,
                         kernel: TEMPORAL_LAYERS * LONG_NUM_BATCHES})
            if counts != want:
                raise AssertionError(f"predict {frames} frames: launches {counts}, expected {want}")
            launches[kernel] = counts[kernel]

            data_cfg = DataConfig(dataset_name="something", dataset_path=paths["dataset"],
                                  labels_path=paths["labels"], videoid2size_path=paths["videoid2size"],
                                  layout_num_frames=frames)
            dataset, batch = _first_batch(data_cfg, batch_size, device)
            live_fraction = float((batch["frame_types"] != 0).float().mean())
            log(f"{frames} frames: batch {batch_size}, frame slots {batch['frame_types'].shape[1]}, "
                f"live fraction {live_fraction:.4f}")
            model = _served_model(ckpt, model_kw, position_table_rows(data_cfg), device)
            uncapped = _kernels_vs_plain(f"forward {frames} frames", model, batch)
            if frames != 512:
                continue

            # The ragged levers through the evaluation entry point.
            frame_cap = frame_capacity_for(dataset, data_cfg)
            live_cap = spatial_live_capacity_for(dataset, data_cfg, batch_size, frame_axis=frame_cap)
            total_rows = batch_size * data_cfg.num_total_frames
            if frame_cap is None or live_cap is None or live_cap >= total_rows:
                raise AssertionError(f"the ragged set gives no capacities ({frame_cap}, {live_cap})")
            spatial_rows = []
            real = fe.fused_proj_attention

            def spy(x, *args, **kwargs):
                if x.shape[1] == data_cfg.num_total_boxes:
                    spatial_rows.append(x.shape[0])
                return real(x, *args, **kwargs)

            for levers in (False, True):
                spatial_rows.clear()
                fe.fused_proj_attention = spy
                reset_all_launches()
                try:
                    metrics = inference.main(common + (["--use_pallas", "--live_prefix"] if levers else []))
                    torch.cuda.synchronize()
                finally:
                    fe.fused_proj_attention = real
                counts = all_launches()
                log(f"inference 512 frames, levers {levers}: metrics {metrics}; spatial rows per "
                    f"layer {sorted(set(spatial_rows))} (capacity {live_cap} of {total_rows}); "
                    f"frame capacity {frame_cap}; launches {counts}")
                if not metrics or not all(math.isfinite(m) and 0.0 <= m <= 1.0 for m in metrics.values()):
                    raise AssertionError(f"inference: bad metrics {metrics}")
                rows_want = live_cap if levers else total_rows
                if len(spatial_rows) != SPATIAL_LAYERS * LONG_NUM_BATCHES or set(spatial_rows) != {rows_want}:
                    raise AssertionError(f"inference, levers {levers}: spatial rows {spatial_rows}, "
                                         f"expected {rows_want} in each of {SPATIAL_LAYERS} layers")
                temporal = "flash_attention" if levers else "blockwise_attention"
                if counts[temporal] != TEMPORAL_LAYERS * LONG_NUM_BATCHES:
                    raise AssertionError(f"inference, levers {levers}: launches {counts}")
            capped = _served_model(ckpt, model_kw, position_table_rows(data_cfg), device,
                                   spatial_live_capacity=live_cap, temporal_frame_capacity=frame_cap)
            got = _kernels_vs_plain("forward 512 frames, levers", capped, batch)
            _check_logits("forward 512 frames, levers", got, uncapped, "the model without levers")
            del model, capped
            torch.cuda.empty_cache()
    return launches


# --- phase 6: long clips through the train entry point ----------------------


def run_long_train_path(device):
    """Train a full-width bf16 STLT (dropout 0.1) through ``train`` at
    ``--layout_num_frames 256`` (B = 32) and 512 (B = 16), one epoch of
    LONG_TRAIN_STEPS steps and one validation batch each. Asserts finite
    losses and the launch counts (per step 4 + 4 of the train op's kernels,
    8 + 8 of the long-clip forward and backward and 4 + 8 = 12 of each of the
    fused train tail's four kernels; per validation batch 4 fused
    projections, 12 eval tails, 8 long-clip forwards; no eval tail in a
    step). Then one step from the trained weights, kernels against plain
    (the tail's plain forward and backward swapped in too), the step times
    and peak memory of both paths and a profile of one kernel-path step.
    Returns the long-clip and train-tail kernels' launches (of the 256-frame
    run) and the step times."""
    from stlt_tpu_torch import train as port_train
    from stlt_tpu_torch.configs import DataConfig
    from stlt_tpu_torch.data import collaters_factory, datasets_factory
    from stlt_tpu_torch.data.loader import Loader, to_device
    from stlt_tpu_torch.training.criterion import make_criterion

    launches, step_ms = {}, {}
    criterion = make_criterion("something")
    with tempfile.TemporaryDirectory(prefix="stlt_chip_smoke_long_train_") as root:
        for frames, (clips, frames_range) in LONG_TRAIN.items():
            sub = os.path.join(root, str(frames))
            os.makedirs(sub)
            train_clips = clips * LONG_TRAIN_STEPS
            paths = write_something_dataset(sub, train_clips + clips, SEED + 10 + frames,
                                            num_used=TRAIN_LABELS, frames_range=frames_range)
            split = _split_dataset(paths, sub, train_clips)
            kernel = "flash_attention" if frames == 256 else "blockwise_attention"
            argv = [
                "--dataset_name", "something", "--dataset_type", "layout", "--model_name", "stlt",
                "--train_dataset_path", split["train"], "--val_dataset_path", split["val"],
                "--labels_path", paths["labels"], "--videoid2size_path", paths["videoid2size"],
                "--hidden_size", str(H), "--num_attention_heads", str(HEADS),
                "--num_spatial_layers", str(SPATIAL_LAYERS),
                "--num_temporal_layers", str(TEMPORAL_LAYERS),
                "--hidden_dropout_prob", str(DROPOUT), "--layout_num_frames", str(frames),
                "--batch_size", str(clips), "--epochs", "1", "--learning_rate", "1e-4",
                "--compute_dtype", "bfloat16", "--use_pallas", "--seed", str(SEED),
                "--save_model_path", os.path.join(sub, "best.pt"),
            ]
            reset_all_launches()
            t0 = time.perf_counter()
            result = port_train.main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = all_launches()
            label = f"train {frames} frames, B = {clips}"
            log(f"{label}: {result.step} steps in {seconds:.3f} s (data and model set-up "
                f"included); launches {counts}")
            for record in result.epochs:
                log("train_epoch " + json.dumps(record))
            if result.step != LONG_TRAIN_STEPS or not all(
                    math.isfinite(r["train_loss"]) for r in result.epochs):
                raise AssertionError(f"{label}: bad epoch records {result.epochs}")
            steps, val = result.step, 1
            want = dict.fromkeys(counts, 0)
            want.update({"fused_proj_attention_train": SPATIAL_LAYERS * steps,
                         "fused_proj_attention_train_bwd": SPATIAL_LAYERS * steps,
                         kernel: TEMPORAL_LAYERS * (steps + val),
                         kernel + "_bwd": TEMPORAL_LAYERS * steps,
                         "fused_proj_attention": SPATIAL_LAYERS * val,
                         "fused_layer_tail": (SPATIAL_LAYERS + TEMPORAL_LAYERS) * val})
            want.update(dict.fromkeys(TAIL_KERNELS, (SPATIAL_LAYERS + TEMPORAL_LAYERS) * steps))
            if counts != want:
                raise AssertionError(f"{label}: launches {counts}, expected {want}")
            launches[kernel + "_bwd"] = counts[kernel + "_bwd"]
            if frames == 256:
                launches.update({name: counts[name] for name in TAIL_KERNELS})
            model = result.model
            del result

            # One step from the trained weights, kernels against plain; times; profile.
            data_cfg = DataConfig(dataset_name="something", dataset_path=split["train"],
                                  labels_path=paths["labels"], videoid2size_path=paths["videoid2size"],
                                  layout_num_frames=frames, train=True)
            loader = Loader(datasets_factory["layout"](data_cfg), clips,
                            collaters_factory["layout"](data_cfg), prefetch=0)
            batch = next(iter(to_device(loader, device)))
            name = f"train step {frames} frames, B = {clips}"
            model.train()
            _step_kernels_vs_plain(name, model, batch, criterion)
            torch.cuda.reset_peak_memory_stats()
            ms = _step_ms(model, batch, criterion, steps=3)
            peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with plain_kernels():
                plain_ms = _step_ms(model, batch, criterion, steps=3)
            plain_peak = torch.cuda.max_memory_allocated()
            step_ms[frames] = {"ms": ms, "plain_ms": plain_ms, "peak_bytes": peak,
                               "plain_peak_bytes": plain_peak}
            log(f"{name} (full width, bf16, dropout {DROPOUT}): kernels {ms:.3f} ms, "
                f"plain {plain_ms:.3f} ms; peak memory kernels {peak / 2**30:.3f} GiB, "
                f"plain {plain_peak / 2**30:.3f} GiB")
            _profile_step(model, batch, criterion, clips, frames=frames)
            del model, batch, loader
            torch.cuda.empty_cache()
    return launches, step_ms


# --- phase 7: the fusion models through the prediction and evaluation entry points


# bench.py::bench_cacnf's configuration (the reference config of every
# fusion model): the STLT's layout branch, 4 appearance layers over R3D-50
# features of 32 frames at 112 px (2 x 4 x 4 = 32 tokens), 4 fusion layers.
APPEARANCE_LAYERS, FUSION_LAYERS, APPEARANCE_FRAMES = 4, 4, 32
FUSION_MODEL = dict(num_classes=NUM_CLASSES, unique_categories=4, hidden_size=H,
                    num_attention_heads=HEADS, num_spatial_layers=SPATIAL_LAYERS,
                    num_temporal_layers=TEMPORAL_LAYERS, num_appearance_layers=APPEARANCE_LAYERS,
                    num_fusion_layers=FUSION_LAYERS, appearance_num_frames=APPEARANCE_FRAMES,
                    resnet_depth=50, compute_dtype="bfloat16")
# --layout_num_frames -> (batch, the clips' frame counts, {model: batches}):
# 16 frames (17 with the extract frame) as bench_cacnf, two batches of
# CACNF and one each of CAF and LCF; 512 frames (513 tokens, B = 16) for
# CACNF, clips of 32-256 frames as long_context_512.
FUSION_RUNS = {16: (32, (3, 25), {"cacnf": 2, "caf": 1, "lcf": 1}), 512: (16, (32, 257), {"cacnf": 1})}
VIDEO_FRAMES = 34  # frames a clip holds in the archive; the eval sampler spreads 32 over them
_BLOCKWISE_FRAMES = 512  # from 512 sampled frames (513 tokens) on, the blockwise kernel


def write_video_frames(root, video_ids, seed) -> str:
    """JPEG frames in the layout ``tools/video2frames.py`` writes and
    ``tools/frames2hdf5.py`` packs into the HDF5 archive
    (``<root>/<video_id>/<index>.jpg``): VIDEO_FRAMES frames of 170 x 128 a
    clip, drawn from 16 smooth random images. ``frames_directory_videos``
    serves them to the port's appearance dataset in the archive's place."""
    import io

    from PIL import Image

    rng = np.random.default_rng(seed)
    jpegs = []
    for _ in range(16):
        small = Image.fromarray(rng.integers(0, 256, (8, 11, 3), dtype=np.uint8), "RGB")
        buf = io.BytesIO()
        small.resize((170, 128), Image.BILINEAR).save(buf, format="JPEG")
        jpegs.append(buf.getvalue())
    for vid in video_ids:
        os.makedirs(os.path.join(root, vid))
        for i in range(VIDEO_FRAMES):
            with open(os.path.join(root, vid, f"{i}.jpg"), "wb") as f:
                f.write(jpegs[int(rng.integers(len(jpegs)))])
    return root


class _FramesRoot:
    """A frames directory read like the HDF5 archive: ``root[video_id]``
    is that clip's ``_VideoFrames``."""

    def __init__(self, root: str):
        self.root = root

    def __getitem__(self, video_id: str) -> "_VideoFrames":
        return _VideoFrames(os.path.join(self.root, video_id))


class _VideoFrames:
    """One clip's frames directory read like its HDF5 group: ``len()``
    frames, each keyed by its file's stem, read as uint8 bytes."""

    def __init__(self, path: str):
        self.path = path
        self.files = {os.path.splitext(name)[0]: name for name in os.listdir(path)}

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, key: str) -> np.ndarray:
        with open(os.path.join(self.path, self.files[key]), "rb") as f:
            return np.frombuffer(f.read(), dtype=np.uint8)


class frames_directory_videos:
    """Within the block, the port's appearance dataset reads its
    ``videos_path`` as a directory of ``<video_id>/<index>.jpg`` frames
    (``write_video_frames``) instead of opening it as the HDF5 archive
    packed from such a directory: the same JPEG bytes under the same keys,
    without h5py, which the card's machine lacks. Everything past the
    frames' bytes (sampling, decode, resize, crop) is the package's."""

    def __enter__(self):
        from stlt_tpu_torch.data import appearance

        self.cls = appearance.AppearanceDataset
        self.saved = self.cls.videos
        self.cls.videos = property(lambda ds: _FramesRoot(ds.config.videos_path))
        return self

    def __exit__(self, *exc):
        self.cls.videos = self.saved
        return False


def fusion_launches(name: str, frames: int) -> dict:
    """Each kernel's launches in one forward of ``name`` at ``frames``
    layout frames: the layout branch (4 spatial, 8 temporal layers), the
    appearance encoder (4 layers at T = 33) and, for CAF and CACNF, per
    fusion layer the layout self-attention (T = 17, or the blockwise kernel's
    dense-bias mode at 513), the appearance self-attention and the
    appearance "ffn" (a self-attention, T = 33) and the shared
    cross-attention in both directions."""
    fusion = 0 if name == "lcf" else FUSION_LAYERS
    counts = dict.fromkeys(all_launches(), 0)
    counts["fused_layer_tail"] = SPATIAL_LAYERS + TEMPORAL_LAYERS + APPEARANCE_LAYERS
    if frames < _BLOCKWISE_FRAMES:
        counts["fused_proj_attention"] = SPATIAL_LAYERS + TEMPORAL_LAYERS + APPEARANCE_LAYERS + 3 * fusion
        counts["fused_cross_attention"] = 2 * fusion
    else:
        counts["fused_proj_attention"] = SPATIAL_LAYERS + APPEARANCE_LAYERS + 2 * fusion
        counts["blockwise_attention"] = TEMPORAL_LAYERS
        counts["blockwise_attention_dense"] = 3 * fusion
    return counts


def _fusion_checkpoints(root) -> dict:
    """A random full-width bf16 CACNF from the port's seeded init, saved as a
    reference-format .pt, and CAF and LCF checkpoints from the same weights
    (CAF: CACNF's backbone and fusion head; LCF: its two branches and the
    fusion head)."""
    from stlt_tpu_torch.configs import make_model_config
    from stlt_tpu_torch.models import models_factory

    model = models_factory["cacnf"](make_model_config("cacnf", **FUSION_MODEL, layout_num_frames=256),
                                    torch.Generator().manual_seed(SEED + 7))
    state = model.state_dict()
    del model
    renames = {
        "cacnf": {"": ""},
        "caf": {"backbone.": "caf_backbone.", "fusion_classifier.": "classifier."},
        "lcf": {"backbone.layout_branch.": "layout_branch.",
                "backbone.appearance_branch.": "appearance_branch.", "fusion_classifier.": "classifier."},
    }
    paths = {}
    for name, prefixes in renames.items():
        sub = {new + k[len(old):]: v for k, v in state.items()
               for old, new in prefixes.items() if k.startswith(old)}
        paths[name] = os.path.join(root, f"{name}_random.pt")
        torch.save(sub, paths[name])
    return paths


def run_fusion_path(device):
    """Serve random full-width bf16 fusion models (bench_cacnf's config)
    through ``predict`` on fabricated JPEG frames (read through
    ``frames_directory_videos``): CACNF at 16 layout
    frames (2 batches of 32 clips of 32 x 112 x 112 frames) and once through
    ``inference``, CAF and LCF (one batch each), and CACNF at 512 frames
    (B = 16). Asserts rows, finite scores and metrics, the launch counts per
    forward (``fusion_launches``) and one batch's logits against the plain
    path on the card, every head; prints the forward times. Returns the
    launches of the fusion kernels in the CACNF predict runs."""
    from stlt_tpu_torch import inference, predict
    from stlt_tpu_torch.configs import DataConfig, position_table_rows
    from stlt_tpu_torch.models import models_factory

    launches = {}
    with tempfile.TemporaryDirectory(prefix="stlt_chip_smoke_fusion_") as root, \
            frames_directory_videos():
        ckpts = _fusion_checkpoints(root)
        for frames, (batch_size, frames_range, models) in FUSION_RUNS.items():
            sub = os.path.join(root, str(frames))
            os.makedirs(sub)
            paths = write_something_dataset(sub, batch_size * max(models.values()), SEED + 7 + frames,
                                            frames_range=frames_range)
            with open(paths["dataset"]) as f:
                clips = json.load(f)
            videos = write_video_frames(os.path.join(sub, "frames"), [c["id"] for c in clips],
                                        SEED + frames)
            # The first `batches` batches of clips, the test set of a model served `batches` times.
            test_sets = {}
            for batches in set(models.values()):
                test_sets[batches] = os.path.join(sub, f"test_{batches}.json")
                with open(test_sets[batches], "w") as f:
                    json.dump(clips[:batch_size * batches], f)
            data_cfg = DataConfig(dataset_name="something", dataset_path=paths["dataset"],
                                  labels_path=paths["labels"], videoid2size_path=paths["videoid2size"],
                                  videos_path=videos, layout_num_frames=frames,
                                  appearance_num_frames=APPEARANCE_FRAMES)
            _, batch = _first_batch(data_cfg, batch_size, device, "multimodal")
            for name, num_batches in models.items():
                common = [
                    "--dataset_name", "something", "--dataset_type", "multimodal",
                    "--model_name", name, "--test_dataset_path", test_sets[num_batches],
                    "--labels_path", paths["labels"], "--videoid2size_path", paths["videoid2size"],
                    "--videos_path", videos, "--checkpoint_path", ckpts[name],
                    "--hidden_size", str(FUSION_MODEL["hidden_size"]),
                    "--num_attention_heads", str(FUSION_MODEL["num_attention_heads"]),
                    "--num_spatial_layers", str(SPATIAL_LAYERS),
                    "--num_temporal_layers", str(TEMPORAL_LAYERS),
                    "--num_appearance_layers", str(APPEARANCE_LAYERS),
                    "--num_fusion_layers", str(FUSION_LAYERS),
                    "--resnet_depth", str(FUSION_MODEL["resnet_depth"]),
                    "--appearance_num_frames", str(APPEARANCE_FRAMES),
                    "--layout_num_frames", str(frames), "--batch_size", str(batch_size),
                    "--compute_dtype", FUSION_MODEL["compute_dtype"], "--use_pallas",
                    "--num_workers", "8",
                ]
                per_forward = fusion_launches(name, frames)
                want = {k: v * num_batches for k, v in per_forward.items()}
                label = f"predict {name} {frames} frames"
                reset_all_launches()
                t0 = time.perf_counter()
                rows = predict.main(common + ["--output", os.path.join(sub, f"{name}.jsonl"),
                                              "--top_k", "5"])
                torch.cuda.synchronize()
                counts = all_launches()
                log(f"{label}: {len(rows)} clips in {time.perf_counter() - t0:.3f} s (data, model "
                    f"and checkpoint load included); launches {counts}")
                if len(rows) != batch_size * num_batches or not all(
                        len(r["top_k"]) == 5 and all(math.isfinite(t["score"]) and 0 <= t["score"] <= 1
                                                     for t in r["top_k"]) for r in rows):
                    raise AssertionError(f"{label}: bad rows")
                if counts != want:
                    raise AssertionError(f"{label}: launches {counts}, expected {want} "
                                         f"({per_forward} per forward)")
                if name == "cacnf":
                    for kernel in FUSION_KERNELS:
                        launches[kernel] = launches.get(kernel, 0) + counts[kernel]
                if name == "cacnf" and frames == 16:
                    reset_all_launches()
                    metrics = inference.main(common)
                    torch.cuda.synchronize()
                    counts = all_launches()
                    log(f"inference {name} {frames} frames: metrics {metrics}; launches {counts}")
                    heads = set(models_factory[name].logit_names)
                    if ({k.rsplit("_", 2)[0] for k in metrics} != heads or not all(
                            math.isfinite(m) and 0.0 <= m <= 1.0 for m in metrics.values())):
                        raise AssertionError(f"inference {name}: bad metrics {metrics}")
                    if counts != want:
                        raise AssertionError(f"inference {name}: launches {counts}, expected {want}")
                model = _served_model(ckpts[name], FUSION_MODEL, position_table_rows(data_cfg),
                                      device, name=name)
                _kernels_vs_plain(f"forward {name} {frames} frames, B = {batch_size}", model, batch)
                del model
                torch.cuda.empty_cache()
    return launches


# --- phase 8: the fusion models through the train entry point ---------------


# --layout_num_frames -> (batch, the clips' frame counts): bench.py::
# bench_cacnf_train_device's 17 layout tokens at B = 32, and 512 frames (513
# tokens) at B = 16, clips of 32-256 frames, which the train sampler
# stretches over every slot.
FUSION_TRAIN = {16: (32, (3, 25)), 512: (16, (32, 257))}
FUSION_TRAIN_STEPS = 2  # one epoch of two AdamW steps and one validation batch
# (group, substrings of the device kernel's name) of a fusion train step: the
# cuDNN group (forward, data and weight gradients) comes before the cuBLAS
# one, whose "xmma" would catch its names.
FUSION_TRAIN_GROUPS = (
    TRAIN_TAIL_GROUP,
    ("attention forward kernel", ("fused_proj_attn",)),
    ("attention backward kernels", ("fused_proj_bwd", "proj_bwd_dwo", "proj_bwd_finalize")),
    ("attention core forward kernel (short and blockwise)", ("attention_kernel<",)),
    ("attention core backward kernels", ("attention_dq_kernel", "attention_dkdv_kernel")),
    ("cuDNN convolutions", ("fprop", "dgrad", "wgrad", "cudnn", "convolve", "implicit_gemm",
                            "conv2d", "conv3d")),
    ("cuBLAS GEMMs", ("gemm", "nvjet", "cutlass", "xmma")),
)


def fusion_train_launches(name: str, frames: int) -> dict:
    """Each kernel's launches in one train step of ``name`` at ``frames``
    layout frames: the train op's forward and backward in every self-
    attention of up to 64 tokens (4 spatial, 8 temporal below 512 frames,
    4 appearance layers, and per fusion layer the layout self-attention below
    512 frames, the appearance self-attention and "ffn"); the shared cross-
    attention's two directions on the short kernel and its backward (17 <-
    33, 33 <- 17) or, at 512 frames, with the layout self-attention on the
    blockwise kernel's dense-bias mode forward and backward; the temporal
    encoder at 512 frames on its lengths mode; and from 256 frames the fused
    train tail's four kernels in the layout branch's 12 layers."""
    fusion = FUSION_LAYERS if name in ("caf", "cacnf") else 0
    layout = 0 if name.startswith("resnet3d") else 1
    counts = dict.fromkeys(fusion_launches("cacnf", frames), 0)
    if frames < _BLOCKWISE_FRAMES:
        proj = layout * (SPATIAL_LAYERS + TEMPORAL_LAYERS) + APPEARANCE_LAYERS + 3 * fusion
        counts.update(flash_attention=2 * fusion, flash_attention_bwd=2 * fusion)
    else:
        proj = layout * SPATIAL_LAYERS + APPEARANCE_LAYERS + 2 * fusion
        counts.update(blockwise_attention=layout * TEMPORAL_LAYERS,
                      blockwise_attention_bwd=layout * TEMPORAL_LAYERS,
                      blockwise_attention_dense=3 * fusion, blockwise_attention_bwd_dense=3 * fusion)
        counts.update(dict.fromkeys(TAIL_KERNELS, layout * (SPATIAL_LAYERS + TEMPORAL_LAYERS)))
    counts.update(fused_proj_attention_train=proj, fused_proj_attention_train_bwd=proj)
    return counts


def _scaled(counts: dict, factor: int) -> dict:
    return {k: v * factor for k, v in counts.items()}


def _added(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


def _fusion_train_argv(name, split, paths, videos, frames, clips, root, *extra):
    return [
        "--dataset_name", "something", "--dataset_type", "multimodal", "--model_name", name,
        "--train_dataset_path", split["train"], "--val_dataset_path", split["val"],
        "--labels_path", paths["labels"], "--videoid2size_path", paths["videoid2size"],
        "--videos_path", videos, "--hidden_size", str(H), "--num_attention_heads", str(HEADS),
        "--num_spatial_layers", str(SPATIAL_LAYERS), "--num_temporal_layers", str(TEMPORAL_LAYERS),
        "--num_appearance_layers", str(APPEARANCE_LAYERS), "--num_fusion_layers", str(FUSION_LAYERS),
        "--resnet_depth", str(FUSION_MODEL["resnet_depth"]),
        "--appearance_num_frames", str(APPEARANCE_FRAMES), "--layout_num_frames", str(frames),
        "--batch_size", str(clips), "--epochs", "1", "--learning_rate", "1e-4",
        "--weight_decay", "1e-3", "--clip_val", "5.0", "--hidden_dropout_prob", str(DROPOUT),
        "--compute_dtype", "bfloat16", "--use_pallas", "--device_normalize", "--num_workers", "8",
        "--seed", str(SEED), "--save_model_path", os.path.join(root, f"{name}_best.pt"), *extra,
    ]


def _run_train_cli(label, argv, want) -> object:
    """``python -m stlt_tpu_torch.train``'s entry point on ``argv``: finite
    losses and the launch counts ``want`` asserted. Returns its result."""
    from stlt_tpu_torch import train as port_train

    reset_all_launches()
    t0 = time.perf_counter()
    result = port_train.main(argv)
    torch.cuda.synchronize()
    counts = all_launches()
    log(f"{label}: {result.step} steps in {time.perf_counter() - t0:.3f} s (data, model set-up "
        f"and validation included); launches {counts}")
    for record in result.epochs:
        log("train_epoch " + json.dumps(record))
    if not result.epochs or not all(math.isfinite(r["train_loss"]) for r in result.epochs):
        raise AssertionError(f"{label}: bad epoch records {result.epochs}")
    want = {k: want.get(k, 0) for k in counts}
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")
    return result


def run_fusion_train_path(device):
    """Train random full-width bf16 CACNF (bench_cacnf_train_device's config:
    dropout 0.1, AdamW lr 1e-4, wd 1e-3, clip 5.0, uint8 frames normalised on
    the device) through ``train`` on fabricated JPEG frames, at 16 layout
    frames (B = 32) and at 512 (B = 16): one epoch of FUSION_TRAIN_STEPS
    steps and one validation batch each, finite losses and the launch counts
    (``fusion_train_launches`` per step, ``fusion_launches`` per validation
    forward) asserted. Then, from the trained weights, one step kernels
    against plain (the train step's limits), the step times and peak memory
    of both paths and a profile of one kernel-path step. At 16 frames also:
    a fine-tune of the saved backbone with ``--load_backbone_path
    --freeze_backbone`` (one step: the backbone takes the eval kernels, rows
    1, 2 and 5, and no backward kernel runs; it ends bit-unchanged), and one
    train step each of ``resnet3d-transformer``, LCF and CAF with their
    launch counts. Returns the dense-bias backward's launches in the
    512-frame run and the step times."""
    from stlt_tpu_torch.configs import DataConfig, make_model_config, position_table_rows
    from stlt_tpu_torch.data import collaters_factory, datasets_factory
    from stlt_tpu_torch.data.loader import Loader, to_device
    from stlt_tpu_torch.models import models_factory
    from stlt_tpu_torch.training.criterion import make_criterion
    from stlt_tpu_torch.training.loop import step_generator
    from stlt_tpu_torch.utils.convert import read_state_dict

    launches, step_ms = {}, {}
    criterion = make_criterion("something")
    with tempfile.TemporaryDirectory(prefix="stlt_chip_smoke_fusion_train_") as root, \
            frames_directory_videos():
        for frames, (clips, frames_range) in FUSION_TRAIN.items():
            sub = os.path.join(root, str(frames))
            os.makedirs(sub)
            train_clips = clips * FUSION_TRAIN_STEPS
            paths = write_something_dataset(sub, train_clips + clips, SEED + 20 + frames,
                                            num_used=TRAIN_LABELS, frames_range=frames_range)
            split = _split_dataset(paths, sub, train_clips)
            with open(paths["dataset"]) as f:
                videos = write_video_frames(os.path.join(sub, "frames"), [c["id"] for c in json.load(f)],
                                            SEED + 20 + frames)
            backbone = os.path.join(sub, "backbone.pt")
            label = f"train cacnf {frames} frames, B = {clips}"
            want = _added(_scaled(fusion_train_launches("cacnf", frames), FUSION_TRAIN_STEPS),
                          fusion_launches("cacnf", frames))
            argv = _fusion_train_argv("cacnf", split, paths, videos, frames, clips, sub,
                                      "--save_backbone_path", backbone)
            result = _run_train_cli(label, argv, want)
            if result.step != FUSION_TRAIN_STEPS:
                raise AssertionError(f"{label}: {result.step} steps")
            if frames == _BLOCKWISE_FRAMES:
                launches["blockwise_attention_bwd_dense"] = (
                    FUSION_TRAIN_STEPS * fusion_train_launches("cacnf", frames)["blockwise_attention_bwd_dense"])
            model = result.model
            del result

            # One step from the trained weights, kernels against plain; times; profile.
            data_cfg = DataConfig(dataset_name="something", dataset_path=split["train"],
                                  labels_path=paths["labels"], videoid2size_path=paths["videoid2size"],
                                  videos_path=videos, layout_num_frames=frames,
                                  appearance_num_frames=APPEARANCE_FRAMES, device_normalize=True,
                                  train=True)
            loader = Loader(datasets_factory["multimodal"](data_cfg), clips,
                            collaters_factory["multimodal"](data_cfg), prefetch=0, workers=8)
            batch = next(iter(to_device(loader, device)))
            name = f"train step cacnf {frames} frames, B = {clips}"
            model.train()
            _step_kernels_vs_plain(name, model, batch, criterion, FUSION_STEP_BF16)
            if frames == _BLOCKWISE_FRAMES:
                # The same step in f32 from the same weights: every kernel's
                # f32 variant, where no rounding flips a ReLU gate of the
                # appearance branch.
                f32_model = models_factory["cacnf"](
                    dataclasses.replace(model.config, compute_dtype="float32"))
                f32_model.load_state_dict(model.state_dict())
                for p32, p in zip(f32_model.parameters(), model.parameters()):
                    p32.requires_grad_(p.requires_grad)  # the frozen BN parameters
                _step_kernels_vs_plain(f"{name}, f32", f32_model.to(device).train(), batch, criterion,
                                       FUSION_STEP_F32)
                del f32_model
                torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ms = _step_ms(model, batch, criterion, steps=3)
            peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with plain_kernels():
                plain_ms = _step_ms(model, batch, criterion, steps=3)
            plain_peak = torch.cuda.max_memory_allocated()
            step_ms[frames] = {"ms": ms, "plain_ms": plain_ms, "peak_bytes": peak,
                               "plain_peak_bytes": plain_peak}
            log(f"{name} (full width, bf16, dropout {DROPOUT}): kernels {ms:.3f} ms, "
                f"plain {plain_ms:.3f} ms; peak memory kernels {peak / 2**30:.3f} GiB, "
                f"plain {plain_peak / 2**30:.3f} GiB")
            step = _train_step(model, criterion)
            step(batch, step_generator(SEED, 0))
            _device_profile("fusion_train_step", lambda: step(batch, step_generator(SEED, 1)),
                            FUSION_TRAIN_GROUPS, model="cacnf", clips=clips, frames=frames)
            del model, step
            torch.cuda.empty_cache()
            if frames == _BLOCKWISE_FRAMES:
                continue

            # A frozen backbone: the eval kernels in the step, no backward kernel.
            one_step = dict(split, train=os.path.join(sub, "train_one_batch.json"))
            with open(split["train"]) as f:
                first = json.load(f)[:clips]
            with open(one_step["train"], "w") as f:
                json.dump(first, f)
            label = f"train cacnf {frames} frames, B = {clips}, frozen backbone"
            tuned = _run_train_cli(
                label, _fusion_train_argv("cacnf", one_step, paths, videos, frames, clips, sub,
                                          "--load_backbone_path", backbone, "--freeze_backbone"),
                _scaled(fusion_launches("cacnf", frames), 2))
            loaded = read_state_dict(backbone)
            for key, value in tuned.model.backbone.state_dict().items():
                if not torch.equal(value.cpu(), loaded[key]):
                    raise AssertionError(f"{label}: backbone parameter {key} moved")
            log(f"{label}: the backbone ran the eval kernels only (rows 1, 2, 5) and is "
                "bit-unchanged after the step")
            del tuned

            # One train step of each other multimodal model, random weights.
            for other in ("resnet3d-transformer", "lcf", "caf"):
                cfg = make_model_config(other, **dict(FUSION_MODEL, hidden_dropout_prob=DROPOUT),
                                        layout_num_frames=position_table_rows(data_cfg))
                model = models_factory[other](cfg, torch.Generator().manual_seed(SEED + 9))
                model = model.to(device).train()
                reset_all_launches()
                loss, norm = _train_step(model, criterion)(batch, step_generator(SEED, 0))
                torch.cuda.synchronize()
                counts = all_launches()
                want = fusion_train_launches(other, frames)
                want = {k: want.get(k, 0) for k in counts}
                log(f"train step {other} {frames} frames, B = {clips}: loss {loss.item():.6f}, "
                    f"gradient norm {norm.item():.4f}; launches {counts}")
                if not math.isfinite(loss.item()) or counts != want:
                    raise AssertionError(f"train step {other}: loss {loss.item()}, launches {counts}, "
                                         f"expected {want}")
                del model
                torch.cuda.empty_cache()
    return launches, step_ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the GPU",
              file=sys.stderr)
        return 1
    from stlt_tpu_torch.ops import _kernels

    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _kernels.build_all(verbose=True)
    log(f"build: {time.perf_counter() - t0:.1f} s")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    table = check_kernels(device)
    table.update(check_train_kernels(device))
    table.update(check_long_kernels(device))
    table.update(check_long_train_kernels(device))
    table.update(check_tail_train_kernels(device))
    table.update(check_fusion_kernels(device))
    table.update(check_fusion_train_kernels(device))
    launches = run_main_path(device)  # the predict path: eval kernels
    train_launches, _ = run_train_path(device)  # the train path: train kernels
    launches.update({name: train_launches[name] for name in TRAIN_KERNELS})
    launches.update(run_long_clip_path(device))  # long clips: the long-clip kernels
    # Long-clip training: the attention backwards and the fused train tail.
    launches.update(run_long_train_path(device)[0])
    launches.update(run_fusion_path(device))  # the fusion models: row 5 and row 8's dense mode
    # Fusion training: the dense-bias mode of the blockwise backward (rows 9, 10).
    launches.update(run_fusion_train_path(device)[0])

    idle = [name for name in REPLACES if not launches[name]]
    if idle:
        raise AssertionError(f"kernels the main paths never launched: {idle}")
    kernels = []
    for name in REPLACES:
        row = table[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"stlt_tpu_torch/csrc/{_kernels.source(name)}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
