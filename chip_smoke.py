#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``stlt_tpu_torch``) on one GPU.

    python3 chip_smoke.py

(``python3 chip_smoke.py --only run_fusion_train_path[,...]`` builds the
kernels and runs the named phase functions alone, printing no result line:
to repeat a phase on the card.)

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
   B = 32, T = 513 against ``scaled_dot_product_attention`` (rows 6 and 8
   in every mode below timed as medians of five windows, two launches
   bit-identical, and the device kernel of each case and mode read from its
   library's launch record: the wgmma body in bf16 at head dims 64 and
   128); then the
   long-clip train kernels: both forwards' dropout variants (rate 0.1 and
   0.5, the short one with its lse) and both backwards against
   ``attention_bwd_plain`` (T = 65, 257, 512 and 513, 1025; full and ragged
   lengths; dropout 0 and 0.1; dead rows, NaN and determinism checks), timed
   at B = 32, T = 257 and B = 16, T = 513 against the autograd backward of
   ``scaled_dot_product_attention`` (the backwards, rows 7 and 9-10, and
   that yardstick in every mode below as the median of five windows of five
   launches, with the windows' spread); then the fused train tail's forward and
   three backward kernels against their plain versions at 2,056 tokens (bf16
   and f32, dropout 0 and 0.1, GELU with full and ragged live tokens, ReLU
   with ragged ones, a 1e30 cotangent on dead tokens; dead outputs zero, no
   NaN, two launches bit-identical) and at 8,224 ragged tokens (two
   splits of the weight products), then checked the same way and timed at
   the 256-frame step's shapes (65,792 spatial and 8,224 temporal tokens:
   264 row blocks, 8 and 2 splits in bf16) and at the 17-frame B = 512
   spatial shape (69,632 tokens) against its plain version, the
   autograd of ``F.dropout``/``F.layer_norm``/``F.linear``/``F.gelu`` (the
   backward's once, rows 12-14 jointly; kernels and yardstick the median of
   five windows) and its bound, with the op-level A/B of the fused op
   against the layer's plain chain and a profile of rows 13 and 14's device
   kernels at 65,792 tokens; then the fusion
   models' kernels: ``fused_cross_attention`` at (T, S) = (17, 33), (33,
   17), (8, 64) and (64, 8), with and without a key-padding bias, at B = 64
   and 1024, against ``F.linear`` + ``scaled_dot_product_attention`` +
   ``F.linear``; the blockwise kernel's dense-bias mode at 513 x 513 (a
   causal+padding bias, with and without the causal flag), 513 x 33 (no
   bias) and 33 x 513 (key padding) at B = 16 and 32, out and lse, against
   ``scaled_dot_product_attention`` with the same mask; and the layer
   tail's ReLU / eps 1e-5 variant (the appearance encoder) at T = 33 (rows
   1, 2, 3, 5 and 8 dense: kernel, plain version and yardstick each the
   median of five windows of five launches; rows 1, 3 and 5 with the
   weights as the model passes them and two launches bit-identical); then
   rows 1, 3 and 5 stage by stage
   (the bf16 split of ``csrc/sublayer.cuh``: packed rows, qkv or q and kv,
   the attention output, y, each against its plain version from the
   kernel's own inputs) and row 4's bf16 backward (packed rows, the packed
   g, qkv, do in f32, attn, dqkv, dWo and dbo), one call of each main-path
   shape split by CUDA kernel with ``torch.profiler``, and the wrappers'
   host time; then
   the fusion models' train-path attention: the short kernel's dropout
   forward and its backward at the train cross-attention's (T, S) = (17,
   33) and (33, 17), B = 32, and the blockwise kernels' dense-bias mode at
   the same four cases as the forward's, B = 16 and 32, dropout 0 and 0.1:
   the forward with dropout, and the backward against
   ``attention_bwd_plain`` (two launches bit-identical), timed at B = 16
   against the autograd backward of ``scaled_dot_product_attention``; then
   every kernel again at other head dims and widths ((H, heads) = (256, 8),
   (320, 5) and (1024, 8): head dim 32, an odd width, head dim 128 at the
   widest H), bf16 and f32, with each row's tolerance, each new shape timed
   once; and the blockwise kernel's ring-offset mode at the per-rank shapes
   of a 512-frame clip at C = 2 (B = 32, 257 queries against a chunk of 257
   keys, causal, lengths 33-513) at (row0, col0) = (0, 0), (0, 257),
   (257, 0), (257, 257), once with dropout: out and lse of live rows, dead
   rows zeros with lse 0, rows with no live key in the chunk zeros with lse
   -1e30, timed against its plain version, SDPA with the same mask and its
   bound; and the blockwise backward's ring-offset mode at the same four
   offsets (B = 16, the 512-frame train batch), from the whole clip's lse
   and output, dropout 0 and 0.1: dq, dk, dv within BWD_REL, dq of dead
   rows and of rows with no live key exact zeros, outputs filled with NaN
   before the launch all written, two launches bit-identical, timed
   against its plain version, SDPA's autograd backward with the same mask
   and its bound; then the attention kernels' dropout-mask operand (rows
   6-10 in mask mode, a per-head Bernoulli(0.9) mask made on the card):
   the short kernel at B = 32, T = 257, the blockwise one in lengths and
   dense-bias mode at B = 16, T = 513 and in ring-offset mode at (257, 0),
   B = 32 (the mask the chunk's column view), bf16 and f32, forward and
   backward against their plain versions, each launch counted as its mask
   mode, a planted fault (one flipped keep bit of a live row, f32) caught,
   a ``hash_keep_mask`` mask equal to the seed mode bit for bit (bf16), and
   the bf16 launches timed against their plain versions, SDPA with the same
   mask and ``dropout_p`` and their bounds. The layer tails (rows 2 and 11)
   are checked for two bit-identical launches wherever they are timed, and
   timed against their library yardstick and bound at every shape,
   the three widths included;
3. write a synthetic Something-Else dataset, save a randomly initialised
   full-width bf16 STLT as a reference-format ``.pt`` and serve it with
   ``python -m stlt_tpu_torch.predict``'s entry point (3 batches of 64 clips,
   ragged lengths): the row count, finite scores and the launch counts are
   asserted, and one batch's logits are held against the plain path on the
   card; that batch's forward and, 16 times over, the B = 1024 forward are
   timed (kernels and plain) and the latter profiled;
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
9. serve a random full-width bf16 STLT through ``predict --context_parallel
   2 --num_processes 2`` with both ranks on this one card (two processes
   ``chip_smoke.py --ring-rank R PORT WORKDIR``; gloo, the ring's K/V staged
   through host memory, since NCCL refuses two ranks on one GPU): the
   17-frame set at B = 64 and a ragged 512-frame set at B = 32 whose clips
   (32-512 frames) span both ranks; before them ``ring_attention`` itself
   on a 514-frame input against the unsharded blockwise kernel, and once
   with a head-broadcast dropout mask against its steps on one device (two
   mask-mode launches a rank).
   Each rank's backend line and device, its rows, its launch counts per
   forward (the ring-offset mode 8 layers x 2 steps, 4 fused
   projection+attentions, 12 layer tails, nothing else) and its logits of
   the first batch against the single process's on the same weights are
   asserted, with each rank's forward time beside the single process's (two
   ranks sharing one card: no speed claim);
10. train a random full-width bf16 STLT (dropout 0.1) through ``train
   --context_parallel 2 --num_processes 2``, both ranks on this card
   (``chip_smoke.py --ring-train-rank R WORKDIR``; gloo), at 512 layout
   frames (B = 16) and 16 (B = 64), two steps and one validation batch
   each: each rank's backend line and device, finite losses equal on both
   ranks, the trained weights equal bit for bit, the checkpoint written by
   rank 0 alone, and the launch counts per rank (per step 16 ring-offset
   forwards and 16 ring-offset backwards, 4 + 4 of the train op, from 256
   frames 12 of each train-tail kernel; per validation batch 16 ring-offset
   forwards, 4 fused projection+attentions, 12 layer tails; nothing of the
   unsharded lengths mode); then ``ring_attention``'s gradients on two
   ranks (514 frames, bf16) against the unsharded blockwise backward, one
   step at dropout 0 from the same seeded weights, each rank's gradients
   summed over the ring (equal on both ranks) against the single process's
   kernel path within the one-step limits below, and each rank's step time
   and peak memory beside the single process's (no speed claim);
11. (run right after phase 4) the train CLI's levers at phase 4's full width (17 frames, B = 64, two
   epochs, dropout 0.1): ``train`` with ``--grad_accum_steps 2 --remat
   --resume_dir --save_model_path best.msgpack --save_backbone_path
   backbone.msgpack --profile_dir --profile_window 1,3`` run whole, and run
   again cut after epoch 1's step checkpoint (``stop_after_save`` makes the
   checkpoint writer raise once, after its file is on disk) and resumed by
   the same argv: the resumed run's final weights, AdamW state, learning
   rates and epoch-2 loss equal the whole run's bit for bit; each run's
   launches (per layer and step 2 x 2 of the train op's forward, its two
   microbatches each run forward and again in the backward's recompute,
   and 2 of its backward; per layer and validation batch the eval
   kernels), the resumed run only its own epoch's; the trace holds steps 1
   and 2 (its device events logged, not checked). ``best.msgpack`` and
   ``backbone.msgpack`` hold, bit for bit, the weights the CLI wrote them
   from (``saved_weights`` keeps a copy at each write), but for the keys
   without a JAX leaf; ``best.msgpack`` loads with ``strict=True`` and
   gives the logits of those weights through a ``.pt`` bit for bit;
   ``predict --checkpoint_path best.msgpack`` serves it. The category and
   frame-type tables' gradient (``models/stlt.embed``) repeats its bits at
   the batch's ids, f32 and bf16 (``check_embedding_backward``, which logs
   how often the CUDA ``nn.functional.embedding`` backward does not). One
   17-frame B = 512 step from those weights: remat against none at
   dropout 0.1 bit for bit, k = 2 against k = 1 at dropout 0 within the
   one-step limits below, kernels against plain with both levers. One
   256-frame step (B = 8, random weights): remat against none bit for bit,
   and the launches under remat (each forward of rows 3, 6 and 11 twice, each
   backward, rows 4, 7 and 12-14, once). Step times and peak memory
   (``torch.cuda.max_memory_allocated``) at 17 frames, B = 512, with no
   lever, remat, k = 2 and both, and at 256 frames, B = 32, with and without
   remat, each beside the card line;
12. the data axis (``--num_processes 2``, both ranks on this card over
   gloo): every dropout kernel at a global-row base (rows 3-4 at the
   spatial and temporal stages, 6-7, 8-10 in the lengths and dense-bias
   modes, 11-14; bf16 and f32; the launch on rows [b:] at base b against
   rows [b:] of the launch at base 0 and against its plain version at base
   b: ``check_base_kernels``, ``base_check`` lines); then ``train
   --num_processes 2`` at phase 4's width (17 frames, B = 64, two steps,
   one validation batch: each rank's backend line, equal losses and
   weights bit for bit, rank 0 alone writing, phase 4's launch counts per
   step and validation batch), one step at dropout 0.1 of STLT (B = 64) and
   CACNF (16 layout frames, B = 32) whose all-reduced loss and gradients
   are held against one process on the same rows (``DATA_HALVES_LIMITS``)
   and on the global batch (the one-step limits; the fusion step's for
   CACNF, whose R3D trunk is held to the former only: see
   ``run_data_axis_path``), ``predict --num_processes 2`` (the one
   process's clips in its order, the first batch's logits within
   LOGITS_ATOL), and the ``data_axis_times`` line (each rank's step, the
   all-reduce and the one process's step; no speed claim);
13. the grid, STLT on two rings of two ranks (``--num_processes 4
   --context_parallel 2``, all four on this card over gloo) at 512 frames:
   ``train`` (the four ranks' losses and weights bit for bit), one step at
   dropout 0 against one process, ``predict`` (each ring's ranks'
   logits bit-identical, the rings' rows against one process), the
   ``grid_times`` line;
14. the fusion models under the ring (``run_fusion_ring_path``), at
   FUSION_MODEL's full width: ``predict --context_parallel 2
   --num_processes 2`` of CACNF at 512 layout frames and of LCF and CAF at
   16 (launches per forward, the ranks' logits bit-identical and against
   one process); ``train`` of CACNF at 512 on the ring (the ranks' losses
   and weights bit for bit); whether the ranks' replicated gradients are
   bit-identical with no repair (per tensor, the convolutions timed and
   fixed); one step at dropout 0 and 0.1 against one process; the
   ``fusion_ring_times`` line (each rank's step, ring sum, broadcast and
   gather beside one process's step, peak and replicated work); and
   ``train`` and ``predict`` of CACNF on two rings of two ranks at 16
   layout frames (the four ranks' weights bit for bit, the logits against
   one process);
15. print the kernel table as one JSON line, then the result line.

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
  5e-4 in bf16. In bf16 sound kernels read at most 9.0e-5 for dx and dattn
  and 8.7e-5 for the sums; act' taken on the bf16-rounded z1 instead of the
  f32 one reads 1.0e-3 to 1.1e-3 and the input kernel's dh2 without its
  keep bits 7.0e-2, both over the limit, which the elementwise OP_TOL would
  not be. Faults in the weight GEMM read over the sums' limit in dW1 and
  dW2: each split's partial rounded to bf16 1.7e-3, the last split left out
  0.35 at 65,792 tokens (8 splits) and 1.0 at 4,112 (one split) (``python
  -m stlt_tpu_torch.utils.bwd_tolerance tail``, H100; PERF.md §6).
- the fused projection+attention (rows 1 and 3) in bf16: the same OP_TOL
  and the output within a relative Frobenius-norm error of PROJ_REL
  (1.2e-3). Sound kernels read at
  most 4.7e-4; q/k/v rounded before their bias add (a rounding point
  moved) 4.5e-3, which OP_TOL alone passes; the keep bits hashed at the
  packed row 0.45 and the dead rows computed 0.79, both over OP_TOL too
  (``python -m stlt_tpu_torch.utils.bwd_tolerance proj``, H100; PERF.md §6).
- the projection+attention backward (row 4) in bf16: dqkv within the same
  OP_TOL with dead rows exact zeros, and dqkv, dWo and dbo each within a
  relative Frobenius-norm error of PROJ_BWD_REL (1e-3); the op's five
  gradients within GRAD_REL as before. Sound kernels read at most 2.5e-4
  (dqkv; dWo 1.7e-4, dbo 1.2e-7). Planted faults: do rounded to bf16 (a
  rounding point the contract does not have) 2.6e-3 in dqkv, which OP_TOL
  alone passes; bqkv left out of the recompute 9.0e-3 (dqkv) and 4.0e-2
  (dWo), within OP_TOL too; the dWo GEMM's first row split left out 0.80
  (dWo) and 0.75 (dbo); the keep bits at the packed row 0.45; dead rows'
  dqkv left unwritten NaN (``python -m stlt_tpu_torch.utils.bwd_tolerance
  proj_bwd``, H100; PERF.md §6).
- the fused cross-attention (row 5): the same OP_TOL elementwise, and in
  bf16 the output within a relative Frobenius-norm error of CROSS_REL
  (1.2e-3). A typical cross-attention output is about as large as the
  bf16 atol, so the elementwise bound alone would pass a kernel that drops
  bo or bkv; the norm can see it. Sound kernels read at most 8.9e-4 (a
  neighbouring bf16 value of q, kv or o_h, taken where the two f32 sums
  straddle a rounding boundary, moves a near-uniform softmax's output, an
  average of values several times its size). Planted faults read: q and kv
  rounded before their bias add 5.9e-3, bkv left out 0.11, bo left out
  0.19, a head left out 0.30 (only the last over OP_TOL too) (``python -m
  stlt_tpu_torch.utils.bwd_tolerance cross``, H100; PERF.md §6).
- the long-clip attention forwards (rows 6 and 8) in every mode (bias,
  lengths, ring offsets, dense bias; dropout hashed or from a mask): out
  within the same OP_TOL (dead rows exact zeros) and lse of live rows
  within the f32 OP_TOL (dead rows 0), in bf16 the output within a
  relative Frobenius-norm error of ATTN_FWD_REL (5e-4), two launches
  bit-identical; and the device kernel each case launched, from its
  library's launch record (``check_fwd_case``, ``check_fwd_bodies``: the
  wgmma body in bf16 at head dims 64 and 128, the staged one otherwise). Sound kernels read at most 1.3e-4; planted faults in the
  wgmma body: P V with P's hi part only 2.7e-3, the causal key range one
  key short 7.2e-3, O not rescaled when a row's max grows 0.31, the keep
  bits at (s, t) 0.41 (``python -m stlt_tpu_torch.utils.bwd_tolerance
  attention dense``, H100; PERF.md §6, PR 15). The ring-offset mode's
  merge-wiped rows are exactly zeros with lse -1e30.
- ``ring_attention`` on two ranks against the unsharded blockwise kernel
  (bf16): OP_TOL elementwise and RING_REL (1e-3) in relative norm. The
  sound ring reads 5.4e-4 (each step's output is rounded to bf16 before the
  f32 merge, as in JAX's ring); with every step's col0 off by one key 0.47,
  a fault the script plants and asserts the limit catches on every run
  (H100, PERF.md §6).
- the blockwise backward's ring-offset mode (rows 9 and 10): BWD_REL and
  OP_TOL as the lengths mode (sound 1.1e-4 in bf16, H100). ``ring_attention``'s
  gradients on two ranks against the unsharded blockwise backward (bf16):
  RING_BWD_REL (5e-3) in relative norm. The sound ring reads 6.9e-4 in dq
  and 2.1e-3 in dk and dv (a chunk's dk, dv add two steps' bf16-rounded
  parts, then round again), every step's col0 off by one key 0.25 to 0.42,
  which the script plants and asserts on every run; against its steps run
  on one device the ring reads 0 (the transfers lose nothing).
- one step at dropout 0 on two ranks (gradients summed over the ring)
  against one process: the one-step limits below (read 4.5e-3 joined, at
  most 8.0e-3 a tensor, H100). CACNF's step on the ring (phase 14, the
  layout branch summed over the ring, the rest rank 0's) against one
  process: the fusion step's bf16 limits below (read 4.6e-3 and 4.9e-3
  joined at dropout 0 and 0.1, at most 2.3e-2 a tensor, in the R3D trunk;
  H100, PERF.md §6).
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
- phase 11: a step with ``--remat`` against one without, and a resumed
  run against an uninterrupted one, bit for bit (the recompute hashes the
  keep bits of the seeds drawn before it; every kernel and library call of
  the step repeats its bits); k = 2 microbatches against one at dropout 0
  within the one-step limits below (the two sum the gradients in another
  order, and every bf16 rounding of the forward sees other batch shapes).
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
  rest at most 1.1e-2 (H100; PERF.md §6). The same step in f32 holds every
  tensor: loss atol 1e-5, each gradient within 1e-4 (sound 2.1e-6) and in
  the appearance branch within 1e-3 (sound 1.0e-5 and 1.4e-4 in two runs),
  joined within 3e-4 (sound 1.3e-6 and 2.7e-5), so a kernel fault confined
  to a few tensors of any branch still shows. In f32 too the two runs' sum
  orders set a few ReLU gates of the appearance encoder differently (one
  run in five read 4.8e-3 for a layer's linear1), so the plain run takes the
  kernel run's gates where they flipped, within GATE_PIN_ABS of 0 and at
  most GATE_PIN_MAX of them (``pin_flipped_gates``); each run logs the flips
  per layer.
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
    # The ring-offset mode of _blockwise_attn_kernel (off_base, valid_cols).
    "blockwise_attention_offsets": "stlt_tpu/ops/flash.py:397",
    # The ring-offset mode of _blockwise_dq_kernel (:655) and
    # _blockwise_dkdv_kernel (:745), one launch for both.
    "blockwise_attention_bwd_offsets": "stlt_tpu/ops/flash.py:655",
}
# The CUDA kernels of a row's bf16 path, named in the kernels line.
CUDA_KERNELS = {"fused_proj_attention_train_bwd": ("proj_bwd_scan_kernel", "proj_bwd_gather_kernel",
                                                   "proj_bwd_gemm_kernel", "proj_bwd_attn_kernel",
                                                   "proj_bwd_weight_gemm_kernel", "proj_bwd_finalize_kernel"),
                **{name: ("tc::attention_fwd_kernel",) for name in (
                    "flash_attention", "blockwise_attention", "blockwise_attention_dense",
                    "blockwise_attention_offsets")}}
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
# bf16 outputs of the fused cross-attention, relative norm (f32: OP_TOL
# alone).
CROSS_REL = 1.2e-3
# bf16 outputs of the long-clip attention forwards, rows 6 and 8 in every
# mode (bias, lengths, ring offsets, dense bias; hashed or masked dropout),
# relative norm (f32: OP_TOL alone): from planted faults (python -m
# stlt_tpu_torch.utils.bwd_tolerance attention dense; PERF.md).
ATTN_FWD_REL = 5e-4
# bf16 outputs of the fused projection+attention (rows 1 and 3), relative
# norm: sound 4.7e-4, q/k/v rounded before their bias add 4.5e-3.
PROJ_REL = 1.2e-3
# dqkv, dWo and dbo of the projection+attention backward (row 4) in bf16,
# relative norm (f32: GRAD_REL on dWo and dbo): sound 2.5e-4 at most, the
# smallest planted fault (do rounded to bf16) 2.6e-3.
PROJ_BWD_REL = 1e-3
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


def make_weights(gen, device, H=H):
    """Full-width layer weights (or at width ``H``, FF = 4H), input-major,
    f32, drawn like the model's init (plus nonzero attention biases)."""
    FF = 4 * H
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


def model_layout(w):
    """``w`` with its attention weights as the attention layer hands them to
    the kernels: transposed views of f32 parameters stored [out, in]
    (``in_proj_weight.t()``, ``out_proj.weight.t()``; the cross-attention's
    ``wq`` and ``wkv`` the views of ``in_proj_weight[:H]`` and ``[H:]``), so
    that rows 1, 3 and 5 read them as on the main path: the bf16 kernels
    take that storage after one conversion to bf16, no transposing copy."""
    width = w["wo"].shape[0]
    in_proj = w["wqkv"].t().contiguous()  # [3H, H]
    return dict(w, wqkv=in_proj.t(), wo=w["wo"].t().contiguous().t(), wq=in_proj[:width].t(),
                wkv=in_proj[width:].t(), bq=w["bqkv"][:width], bkv=w["bqkv"][width:])


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


def median_ms(fn, iters: int, windows: int = 5) -> float:
    """Median over ``windows`` windows of ``cuda_ms(fn, iters)``: a window
    that a neighbour on the host or a clock change slows does not move it."""
    return median_spread_ms(fn, iters, windows)[0]


def median_spread_ms(fn, iters: int, windows: int = 5):
    """(median, [fastest, slowest]) over ``windows`` windows of
    ``cuda_ms(fn, iters)``: the median and the windows' spread beside it."""
    times = sorted(cuda_ms(fn, iters) for _ in range(windows))
    return times[windows // 2], [times[0], times[-1]]


def median_fields(row: dict, **fns) -> dict:
    """``row`` with, for each ``key=fn``, ``key`` the median over five
    windows of five launches of ``fn`` and ``key + "_spread"`` the windows'
    fastest and slowest."""
    for key, fn in fns.items():
        row[key], row[key + "_spread"] = median_spread_ms(fn, 5)
    return row


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
    """(ms, "bytes" | "operations") for fused_layer_tail on these inputs (H
    their width, FF = 4H): two GEMMs of 2*H*FF flops a live token, against x
    and attn_out of the live tokens read, out written, the weights and the
    live flags read once."""
    tokens, width = x.shape[0] * x.shape[1], x.shape[-1]
    live_tokens = int(live.sum())
    es = x.element_size()
    flops = live_tokens * 4 * width * 4 * width
    nbytes = 2 * live_tokens * width * es + tokens * width * es  # x and attn_out read, out written
    nbytes += 8 * width * width * es + 9 * width * 4 + tokens
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
    width = (w["n1s"].shape[0],)

    def run(x, a):
        u = F.layer_norm(x + a, width, c["n1s"], c["n1b"], eps)
        h = act(F.linear(u, w1, c["b1"]))
        return F.layer_norm(u + F.linear(h, w2, c["b2"]), width, c["n2s"], c["n2b"], eps)

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
             twice=False, **extra):
    """Check ``kernel()`` against ``plain()`` (one output, elementwise, and
    with ``rel_tol`` also in the relative Frobenius norm; with ``twice`` a
    second launch bit-identical) and time kernel, plain version and library
    yardstick (each the median of five windows of five launches, with the
    windows' spread); returns the row."""
    got, want = kernel(), plain()
    again = kernel() if twice else got
    torch.cuda.synchronize()
    label = f"{name} {stage} {dtype} B={clips} T={x.shape[1]}"
    err = _check_close(label, got, want, live, tol)
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: two launches differ")
    del again
    if rel_tol is not None:
        extra.update(rel_err=_rel(got, want), rel_tol=rel_tol)
        if extra["rel_err"] > rel_tol:
            raise AssertionError(f"{label}: relative norm error {extra['rel_err']:.3e} over {rel_tol}")
    bound_ms, bound_by = bound
    row = {
        "name": name, "stage": stage, "dtype": str(dtype).split(".")[1], "clips": clips,
        "rows": x.shape[0], "T": x.shape[1], **extra,
        "live_fraction": round(float(live.float().mean()), 4), "max_abs_err": err, "tol": tol,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    median_fields(row, ms=kernel, plain_ms=plain, library_ms=library)
    log("kernel_check " + json.dumps(row))
    return row


def last_fwd_launch(op: str) -> tuple:
    """(wgmma body, D, lengths mode, bias stage, drop mode) of the last
    forward launch that the library of ``op`` ("flash_attention" or
    "blockwise_attention") made: its host-side record of the device kernel
    it launched (``attention_core.cuh::last_fwd_launch``)."""
    import ctypes

    from stlt_tpu_torch.ops import _kernels

    fn = getattr(_kernels.library(op), f"stlt_{_kernels.source(op)}_last_launch")
    fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_int)], None
    out = (ctypes.c_int * 5)()
    fn(out)
    return tuple(out)


def fwd_kernel_name(rec, dtype) -> str:
    """The device kernel of a last_fwd_launch record."""
    wgmma, D, lengths, bias, drop = rec
    b = lambda x: "true" if x else "false"
    if wgmma:
        return f"tc::attention_fwd_kernel<{D}, {b(lengths)}, {b(bias)}, {drop}>"
    e = "__nv_bfloat16" if dtype == torch.bfloat16 else "float"
    return f"attention_kernel<{e}, {D}, {b(lengths)}, {drop}>"


def check_fwd_body(label, op, q) -> str:
    """That the last launch of ``op`` (a row 6 or row 8 forward of ``q``) ran
    the wgmma body in bf16 at head dims 64 and 128 and the staged one
    otherwise, at q's head dim; returns its device kernel's name."""
    rec = last_fwd_launch(op)
    D = q.shape[-1]
    if rec[0] != int(q.dtype == torch.bfloat16 and D >= 64) or rec[1] != D:
        raise AssertionError(f"{label}: the forward launched {fwd_kernel_name(rec, q.dtype)} "
                             f"(record {rec}) at {q.dtype}, D = {D}")
    return fwd_kernel_name(rec, q.dtype)


def check_fwd_case(label, op, kernel, got, want, q) -> dict:
    """A row 6 or row 8 case beyond OP_TOL: a second ``kernel()`` bit-identical
    to ``got`` (out, or (out, lse)), the body it ran (check_fwd_body) and, in
    bf16, out within ATTN_FWD_REL of ``want`` in relative norm. Returns
    {"body", and in bf16 "rel_err", "rel_tol"}."""
    again = kernel()
    torch.cuda.synchronize()
    row = {"body": check_fwd_body(label, op, q)}
    as_tuple = lambda x: x if isinstance(x, tuple) else (x,)
    if not all(torch.equal(a, b) for a, b in zip(as_tuple(got), as_tuple(again))):
        raise AssertionError(f"{label}: two launches differ")
    if q.dtype == torch.bfloat16:
        row.update(rel_err=_rel(as_tuple(got)[0], want), rel_tol=ATTN_FWD_REL)
        if row["rel_err"] > ATTN_FWD_REL:
            raise AssertionError(f"{label}: relative norm error {row['rel_err']:.3e} over ATTN_FWD_REL "
                                 f"{ATTN_FWD_REL}")
    return row


def check_fwd_bodies(device):
    """Rows 6 and 8 launch the body their mode names, at head dims 32, 64 and
    128, bf16 and f32: one launch of each mode at a small shape, each held to
    its library's record of the device kernel it launched: the wgmma body
    in bf16 at head dims 64 and 128, with a bias stage only when there is a
    bias, the staged body otherwise."""
    from stlt_tpu_torch.ops import flash

    gen = torch.Generator().manual_seed(SEED + 19)
    seen = {}
    for dtype in (torch.bfloat16, torch.float32):
        for D in (32, 64, 128):
            B, N = 2, 256 // D
            q, k, v = (torch.randn(B, 513, N, D, generator=gen).to(device, dtype) for _ in range(3))
            short = [x[:, :65] for x in (q, k, v)]
            bias = _causal_padding_bias(torch.tensor([65, 40]), 65, device)
            dense = _causal_padding_bias(torch.tensor([513, 300]), 513, device)
            lengths = torch.tensor([513, 300], device=device)
            keep = torch.rand(B, N, 513, 513, generator=gen).to(device) >= DROPOUT
            drop = dict(dropout_rate=DROPOUT, dropout_seed=7)
            mask = dict(dropout_rate=DROPOUT, dropout_mask=keep)
            short_mask = dict(dropout_rate=DROPOUT, dropout_mask=keep[:, :, :65, :65])
            # (mode, lengths mode, bias, drop mode, call)
            modes = (
                ("row 6 bias", False, True, 0, lambda: flash.fused_attention(*short, bias)),
                ("row 6 no bias", False, False, 0, lambda: flash.fused_attention(*short)),
                ("row 6 dropout, lse", False, True, 1,
                 lambda: flash.fused_attention(*short, bias, with_lse=True, **drop)),
                ("row 6 mask", False, True, 2, lambda: flash.fused_attention(*short, bias, **short_mask)),
                ("row 8 lengths", True, False, 0,
                 lambda: flash.blockwise_attention(q, k, v, kv_lengths=lengths, causal=True)),
                ("row 8 lengths dropout", True, False, 1,
                 lambda: flash.blockwise_attention(q, k, v, kv_lengths=lengths, causal=True, **drop)),
                ("row 8 lengths mask", True, False, 2,
                 lambda: flash.blockwise_attention(q, k, v, kv_lengths=lengths, causal=True, **mask)),
                ("row 8 offsets", True, False, 0,
                 lambda: flash.blockwise_attention(*short, kv_lengths=lengths, causal=True, offsets=(65, 0))),
                ("row 8 dense", False, True, 0, lambda: flash.blockwise_attention(q, k, v, bias=dense)),
                ("row 8 dense causal flag", False, True, 0,
                 lambda: flash.blockwise_attention(q, k, v, bias=dense, causal=True)),
                ("row 8 dense no bias", False, False, 0,
                 lambda: flash.blockwise_attention(q, k[:, :33], v[:, :33])),
                ("row 8 dense dropout", False, True, 1,
                 lambda: flash.blockwise_attention(q, k, v, bias=dense, **drop)),
                ("row 8 dense mask", False, True, 2, lambda: flash.blockwise_attention(q, k, v, bias=dense, **mask)),
            )
            for mode, lengths_mode, has_bias, drop_mode, fn in modes:
                fn()
                op = "flash_attention" if mode.startswith("row 6") else "blockwise_attention"
                rec = last_fwd_launch(op)
                wgmma = dtype == torch.bfloat16 and D >= 64
                want = (int(wgmma), D, int(lengths_mode), int(has_bias and not lengths_mode), drop_mode)
                label = f"{mode} {str(dtype).split('.')[1]} D={D}"
                if rec != want:
                    raise AssertionError(f"{label}: launched {fwd_kernel_name(rec, dtype)} (record {rec}), "
                                         f"expected {fwd_kernel_name(want, dtype)}")
                seen[label] = fwd_kernel_name(rec, dtype)
    torch.cuda.synchronize()
    log("fwd_bodies " + json.dumps(seen))


def check_kernels(device):
    """Compare and time both eval kernels; returns the rows of the kernel
    table, keyed by kernel name, measured at the main-path batch in bf16 on
    the spatial stage (the larger one), with every other measurement
    printed."""
    from stlt_tpu_torch.ops import fused_encoder as fe

    gen = torch.Generator().manual_seed(SEED)
    w = make_weights(gen, device)
    wm = model_layout(w)
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
            proj_args = (x, wm["wqkv"], w["bqkv"], wm["wo"], w["bo"], bias)
            proj_kw = dict(num_heads=HEADS, compute_dtype=dtype, rows_live=live_kw.get("rows_live"))
            row = _measure(
                "fused_proj_attention", stage, dtype, clips, x,
                lambda: fe.fused_proj_attention(*proj_args, **proj_kw),
                lambda: fe.fused_proj_attention_plain(*proj_args, **proj_kw),
                lambda: lib_p(x, bias.to(dtype)), proj_bound(x, bias, proj_live, dtype),
                proj_live, tol, rel_tol=PROJ_REL if dtype == torch.bfloat16 else None, twice=True,
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
                lambda: lib_t(x, a), tail_bound(x, tail_live, dtype), tail_live, tol, twice=True,
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
    in bf16 the backward reads the model's weight layout and its dqkv, dWo
    and dbo are held to PROJ_BWD_REL too. Time both kernels at B = 64 and,
    in bf16, 512 (the backward, its library call and the wrapper's GEMMs as
    medians of five windows, with the backward's host time). Returns the
    kernel-table rows (spatial, bf16, B = 64, dropout 0.1)."""
    from stlt_tpu_torch.ops import fused_encoder as fe

    gen = torch.Generator().manual_seed(SEED + 1)
    w = make_weights(gen, device)
    wm = model_layout(w)
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
            fwd = (x, wm["wqkv"], w["bqkv"], wm["wo"], w["bo"], bias, seed)
            # bf16 reads the weights in the model's storage, as on the main path.
            wb = wm if dtype == torch.bfloat16 else w
            bwd = (x, wb["wqkv"], w["bqkv"], wb["wo"], bias, g, seed)
            lib_f, lib_b = library_train(w, dtype, rate)
            label = f"{stage} {dtype} B={clips} T={x.shape[1]} rate={rate}"

            row_f = _measure(
                "fused_proj_attention_train", stage, dtype, clips, x,
                lambda: fe.fused_proj_attention_train(*fwd, **kw),
                lambda: fe.fused_proj_attention_train_plain(*fwd, **kw),
                lambda: lib_f(x, bias.to(dtype)), proj_bound(x, bias, proj_live, dtype),
                proj_live, tol, rel_tol=PROJ_REL if dtype == torch.bfloat16 else None, twice=True,
                rate=rate,
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
            if dtype == torch.bfloat16:
                rel["dqkv"] = _rel(got[0], want[0])
                if max(rel.values()) > PROJ_BWD_REL:
                    raise AssertionError(f"backward {label}: dqkv, dWo or dbo over PROJ_BWD_REL "
                                         f"{PROJ_BWD_REL}: {rel}")
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
            kernel = lambda: fe._launch_proj_bwd(*bwd, **kw)  # noqa: E731
            wq_cd = wb["wqkv"].to(dtype)  # as the op's backward converts it, once
            row_b = {
                "name": "fused_proj_attention_train_bwd", "stage": stage,
                "dtype": str(dtype).split(".")[1], "clips": clips, "rows": x.shape[0],
                "T": x.shape[1], "rate": rate, "max_abs_err": err, "rel_err": rel,
                "plain_ms": cuda_ms(lambda: fe.fused_proj_attention_train_bwd_plain(*bwd, **kw), iters),
                "host_ms": _host_ms(kernel, iters), "enqueue_ms": _enqueue_ms(kernel),
            }
            median_fields(row_b, ms=kernel, library_ms=lambda: lib_b(y_lib, lib_x, g),
                          wrapper_gemms_ms=lambda: fe.proj_input_grads(x, wq_cd, got[0], dtype))
            row_b["kernel_and_gemms_over_library"] = (row_b["ms"] + row_b["wrapper_gemms_ms"]) / row_b["library_ms"]
            row_b["bound_ms"], row_b["bound_by"] = train_bwd_bound(x, bias, proj_live, dtype)
            log("kernel_check " + json.dumps(row_b))
            if stage == "spatial" and clips == BATCH and dtype == torch.bfloat16 and rate == DROPOUT:
                table["fused_proj_attention_train"] = row_f
                table["fused_proj_attention_train_bwd"] = row_b
            del x, g, bias, got, want, again, leaves, y, y_lib, lib_x, kernel, wq_cd
            torch.cuda.empty_cache()
    return table


# --- phase 2, rows 1, 3 and 5 stage by stage: the bf16 split of sublayer.cuh --

# Rows 1/3 and row 5's CUDA kernels by stage (csrc/sublayer.cuh): the scan and
# gather packing the live rows, the projection and out GEMMs, the short
# attention.
SUBLAYER_GROUPS = (
    ("pack: scan, gather", ("proj_live_rows", "proj_gather")),
    ("GEMMs", ("proj_gemm", "cross_gemm")),
    ("attention", ("proj_attn_kernel", "cross_short_attn")),
)


def _stage_check(label, got, want, live=None):
    """One stage's output against its plain version from the kernel's own
    inputs (OP_TOL in bf16, dead rows exact zeros); returns (max abs, rel)."""
    live = torch.ones(got.shape, dtype=torch.bool, device=got.device) if live is None else live
    return _check_close(label, got, want, live, OP_TOL[got.dtype]), _rel(got, want)


def _enqueue_ms(fn, iters: int = 20) -> float:
    """Mean host time for ``fn()`` to return, the device idle before each
    call: what the wrapper's host path costs a call."""
    fn()
    total = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total * 1e3 / iters


def check_sublayer_stages(device):
    """Rows 1, 3 and 5 stage by stage, so that a fault can be localised: one
    bf16 launch of the train forward (spatial, B = 64, ragged rows_live,
    dropout 0.1) and of the cross-attention (17 <- 33, B = 64, key padding)
    into a scratch of the caller's, then each stage's output held against its
    plain version (``ops/fused_encoder.py``) from the kernel's own inputs:
    the packed rows and count exactly, qkv (gather + QKV GEMM), the
    attention output o (keep bits at the original rows), y (out GEMM,
    scattered, dead rows exact zeros); q, kv, o and y of row 5; row 4's
    backward (``check_proj_bwd_stages``). Then the device time of one call
    split by CUDA kernel (torch.profiler: ``sublayer_profile``, row 4's
    ``proj_bwd_profile``) and the wrappers' host time at the main-path
    shapes (``sublayer_host``, ``proj_bwd_host``)."""
    from stlt_tpu_torch.ops import fused_encoder as fe
    from stlt_tpu_torch.ops import masks

    gen = torch.Generator().manual_seed(SEED + 13)
    w = make_weights(gen, device)
    wm = model_layout(w)
    bf = torch.bfloat16
    seed = 0x5EED5EED
    x, _, bias, live_kw, proj_live, _ = make_stage("spatial", BATCH, bf, gen, device)
    rows_live = live_kw["rows_live"]
    B, T, _ = x.shape
    kw = dict(num_heads=HEADS, compute_dtype=bf, rows_live=rows_live)
    scratch = fe.proj_scratch(B, T, H, x)
    y = fe._launch_proj("fused_proj_attention_train", x, wm["wqkv"], w["bqkv"], wm["wo"], w["bo"], bias,
                        seed=seed, dropout_rate=DROPOUT, scratch=scratch, **kw)
    torch.cuda.synchronize()
    qkv, o, rows, count = fe.proj_scratch_views(scratch, B, T, H)
    want_rows, live_rows = fe.live_rows_plain(rows_live, B, device)
    if count.item() != live_rows or not torch.equal(rows, want_rows):
        raise AssertionError(f"rows 1/3 pack: count {count.item()} against {live_rows}, or the rows differ")
    n, live = live_rows * T, rows[:live_rows].long()
    stages = {"rows": {"count": live_rows, "rows": B}}
    want_qkv = fe.projection_plain(x[live].reshape(n, H), wm["wqkv"].t(), w["bqkv"], bf).to(bf)
    stages["qkv"] = _stage_check("rows 1/3 gather + QKV GEMM", qkv[:n], want_qkv)
    q, k, v = qkv[:n].view(live_rows, T, 3 * H).split(H, dim=-1)
    want_o = fe.short_attention_plain(q, k, v, fe._bias3(bias, B, T, device), live, num_heads=HEADS,
                                      seed=seed, dropout_rate=DROPOUT)
    stages["o"] = _stage_check("rows 1/3 attention", o[:n], want_o.reshape(n, H))
    want_y = torch.zeros_like(y)
    want_y[live] = fe.projection_plain(o[:n], wm["wo"].t(), w["bo"], bf).to(bf).view(live_rows, T, H)
    stages["y"] = _stage_check("rows 1/3 out GEMM", y, want_y, proj_live[..., None].expand(y.shape))
    log("stage_check " + json.dumps({"name": "fused_proj_attention_train", "shape": f"spatial B={BATCH}",
                                     "rate": DROPOUT, "stages": stages}))
    del x, y, scratch, qkv, o, want_qkv, want_o, want_y
    check_proj_bwd_stages(gen, w, wm, device)

    T, S = 17, 33
    x = torch.randn((BATCH, T, H), generator=gen).to(device, bf)
    ctx = torch.randn((BATCH, S, H), generator=gen).to(device, bf)
    lengths = torch.randint(1, S + 1, (BATCH,), generator=gen)
    cbias = masks.key_padding_bias(torch.arange(S)[None, :] >= lengths[:, None]).to(device)
    scratch = fe.cross_scratch(BATCH, T, S, H, x)
    y = fe._launch_cross(x, ctx, wm["wq"], wm["bq"], wm["wkv"], wm["bkv"], wm["wo"], w["bo"], cbias,
                         num_heads=HEADS, compute_dtype=bf, scratch=scratch)
    torch.cuda.synchronize()
    q, kv, o = fe.cross_scratch_views(scratch, BATCH, T, S, H)
    stages = {
        "q": _stage_check("row 5 q GEMM", q, fe.projection_plain(x.reshape(-1, H), wm["wq"].t(), wm["bq"], bf).to(bf)),
        "kv": _stage_check("row 5 kv GEMM", kv,
                           fe.projection_plain(ctx.reshape(-1, H), wm["wkv"].t(), wm["bkv"], bf).to(bf)),
    }
    kv3 = kv.view(BATCH, S, 2 * H)
    want_o = fe.short_attention_plain(q.view(BATCH, T, H), kv3[..., :H], kv3[..., H:],
                                      fe._bias3(cbias, BATCH, T, device, S), None, num_heads=HEADS)
    stages["o"] = _stage_check("row 5 attention", o, want_o.reshape(-1, H))
    stages["y"] = _stage_check("row 5 out GEMM", y,
                               fe.projection_plain(o, wm["wo"].t(), w["bo"], bf).to(bf).view(y.shape))
    log("stage_check " + json.dumps({"name": "fused_cross_attention", "shape": f"{T} <- {S} B={BATCH}",
                                     "stages": stages}))
    del x, ctx, y, scratch, q, kv, o, want_o

    # One call of each main-path shape, by CUDA kernel; the wrappers' host time
    # (row 4's backward with the wrapper's three GEMMs, as the op runs it).
    for stage, clips in (("spatial", BATCH), ("spatial", TRAIN_BATCH), ("temporal", BATCH),
                         ("temporal", TRAIN_BATCH)):
        x, _, bias, live_kw, _, _ = make_stage(stage, clips, bf, gen, device)
        g = torch.randn(x.shape, generator=gen).to(device, bf)
        wq_cd = wm["wqkv"].to(bf)
        bwd = (x, wq_cd, w["bqkv"], wm["wo"], bias, g, seed)
        bkw = dict(num_heads=HEADS, compute_dtype=bf, rows_live=live_kw.get("rows_live"), dropout_rate=DROPOUT)
        run = lambda: fe.proj_input_grads(x, wq_cd, fe._launch_proj_bwd(*bwd, **bkw)[0], bf)  # noqa: E731
        label = f"row 4 {stage} B={clips} T={x.shape[1]}"
        _device_profile("proj_bwd", run, PROJ_BWD_GROUPS, name=label)
        kernel = lambda: fe._launch_proj_bwd(*bwd, **bkw)  # noqa: E731
        # The attention backward's bytes' time: qkv (bf16) and do (f32) read
        # and attn (bf16) written at the live tokens, dqkv (bf16) at all.
        live_rows = live_kw.get("rows_live")
        live_tok = x.shape[0] * x.shape[1] if live_rows is None else int(live_rows.sum()) * x.shape[1]
        attn_bytes = (live_tok * 12 + x.shape[0] * x.shape[1] * 6) * H
        log("proj_bwd_host " + json.dumps({"name": label, "host_ms": _host_ms(kernel, 20),
                                           "enqueue_ms": _enqueue_ms(kernel), "live_tokens": live_tok,
                                           "attn_bwd_bytes_ms": attn_bytes / HBM_BYTES_PER_S * 1e3}))
        del x, g, bias, live_kw, bwd, run, kernel
    torch.cuda.empty_cache()
    # One call of each main-path shape, by CUDA kernel; the wrappers' host time.
    for stage, clips, frames, op in (("spatial", BATCH, NUM_FRAMES, "eval"),
                                     ("spatial", THROUGHPUT_BATCH, NUM_FRAMES, "eval"),
                                     ("temporal", BATCH, NUM_FRAMES, "eval"),
                                     ("temporal", BATCH, LONG_FRAMES, "eval"),
                                     ("spatial", BATCH, NUM_FRAMES, "train"),
                                     ("spatial", TRAIN_BATCH, NUM_FRAMES, "train")):
        x, _, bias, live_kw, _, _ = make_stage(stage, clips, bf, gen, device, frames)
        args = (x, wm["wqkv"], w["bqkv"], wm["wo"], w["bo"], bias)
        pkw = dict(num_heads=HEADS, compute_dtype=bf, rows_live=live_kw.get("rows_live"))
        if op == "train":
            run = lambda: fe.fused_proj_attention_train(*args, seed, dropout_rate=DROPOUT, **pkw)
        else:
            run = lambda: fe.fused_proj_attention(*args, **pkw)
        label = f"rows 1/3 {op} {stage} B={clips} T={x.shape[1]}"
        _device_profile("sublayer", run, SUBLAYER_GROUPS, name=label)
        log("sublayer_host " + json.dumps({"name": label, "host_ms": _host_ms(run, 20),
                                           "enqueue_ms": _enqueue_ms(run)}))
        del x, bias, live_kw
    for clips in (BATCH, THROUGHPUT_BATCH):
        x = torch.randn((clips, 17, H), generator=gen).to(device, bf)
        ctx = torch.randn((clips, 33, H), generator=gen).to(device, bf)
        run = lambda: fe.fused_cross_attention(x, ctx, wm["wq"], wm["bq"], wm["wkv"], wm["bkv"], wm["wo"],
                                               w["bo"], None, num_heads=HEADS, compute_dtype=bf)
        label = f"row 5 17 <- 33 B={clips}"
        _device_profile("sublayer", run, SUBLAYER_GROUPS, name=label)
        log("sublayer_host " + json.dumps({"name": label, "host_ms": _host_ms(run, 20),
                                           "enqueue_ms": _enqueue_ms(run)}))
        del x, ctx
    torch.cuda.empty_cache()


# do = g Wo^T of row 4's bf16 backward, relative norm: f32 sums of the same
# bf16 products in another order (the contract keeps do in f32).
DO_REL = 1e-5


def check_proj_bwd_stages(gen, w, wm, device):
    """Row 4 stage by stage: one bf16 backward launch (spatial, B = 64,
    ragged rows_live, dropout 0.1, the model's weight layout) into a scratch
    of ours, then each stage held against its plain version from the
    kernel's own inputs: the packed rows and count exactly; the gathered g
    exactly, the rows up to the next 64-row step zeros; qkv (gather + GEMM)
    within OP_TOL; do (f32) within DO_REL; attn and dqkv (the attention
    backward, keep bits at the original rows, from the kernel's qkv and do)
    within OP_TOL, dead rows exact zeros, dqkv within PROJ_BWD_REL; dWo and
    dbo (from the kernel's attn and g) within PROJ_BWD_REL, each exactly its
    split partials summed in order."""
    from stlt_tpu_torch.ops import fused_encoder as fe

    bf, seed = torch.bfloat16, 0x5EED5EED
    x, _, bias, live_kw, proj_live, _ = make_stage("spatial", BATCH, bf, gen, device)
    rows_live = live_kw["rows_live"]
    B, T, _ = x.shape
    g = torch.randn(x.shape, generator=gen).to(device, bf)
    g[~rows_live] = 0
    scratch = fe.proj_bwd_scratch(B, T, H, x)
    dqkv, dwo, dbo = fe._launch_proj_bwd(x, wm["wqkv"], w["bqkv"], wm["wo"], bias, g, seed, num_heads=HEADS,
                                         dropout_rate=DROPOUT, compute_dtype=bf, rows_live=rows_live,
                                         scratch=scratch)
    torch.cuda.synchronize()
    v = fe.proj_bwd_scratch_views(scratch, B, T, H)
    want_rows, live_rows = fe.live_rows_plain(rows_live, B, device)
    if v["count"].item() != live_rows or not torch.equal(v["rows"], want_rows):
        raise AssertionError(f"row 4 pack: count {v['count'].item()} against {live_rows}, or the rows differ")
    n, live = live_rows * T, want_rows[:live_rows].long()
    pad = slice(n, min(-(-n // 64) * 64, B * T))
    gp = g[live].reshape(n, H)
    if not torch.equal(v["g"][:n], gp) or v["g"][pad].any() or v["attn"][pad].any():
        raise AssertionError("row 4 gather: the packed g differs, or its pad rows are not zeros")
    stages = {"rows": {"count": live_rows, "rows": B}}
    want_qkv = fe.projection_plain(x[live].reshape(n, H), wm["wqkv"].t(), w["bqkv"], bf).to(bf)
    stages["qkv"] = _stage_check("row 4 gather + qkv GEMM", v["qkv"][:n], want_qkv)
    want_do = gp.float() @ wm["wo"].to(bf).float().t()
    stages["do"] = {"max_abs": (v["do"][:n] - want_do).abs().max().item(), "rel": _rel(v["do"][:n], want_do)}
    if stages["do"]["rel"] > DO_REL:
        raise AssertionError(f"row 4 do GEMM: relative norm {stages['do']['rel']:.3e} over {DO_REL}")
    q, k, vv = v["qkv"][:n].view(live_rows, T, 3 * H).split(H, dim=-1)
    dqkv_p, want_attn = fe.short_attention_bwd_plain(
        q, k, vv, v["do"][:n].view(live_rows, T, H), fe._bias3(bias, B, T, device), live, num_heads=HEADS,
        seed=seed, dropout_rate=DROPOUT)
    stages["attn"] = _stage_check("row 4 attention backward: attn", v["attn"][:n], want_attn.reshape(n, H))
    want_dqkv = torch.zeros_like(dqkv)
    want_dqkv[live] = dqkv_p.to(bf)
    stages["dqkv"] = _stage_check("row 4 attention backward: dqkv", dqkv, want_dqkv,
                                  proj_live[..., None].expand(dqkv.shape))
    sum_w, sum_b = torch.zeros_like(dwo), torch.zeros_like(dbo)
    for k in range(v["partial"].shape[0]):
        sum_w += v["partial"][k]
        sum_b += v["partial_b"][k]
    if not (torch.equal(dwo, sum_w) and torch.equal(dbo, sum_b)):
        raise AssertionError("row 4 ordered sums: dWo or dbo is not its split partials summed in order")
    attn_p = v["attn"][:n].float()
    stages["dwo"] = {"rel": _rel(dwo, attn_p.t() @ gp.float())}
    stages["dbo"] = {"rel": _rel(dbo, gp.float().sum(dim=0))}
    rel = {name: stages[name][1] if name == "dqkv" else stages[name]["rel"] for name in ("dqkv", "dwo", "dbo")}
    if max(rel.values()) > PROJ_BWD_REL:
        raise AssertionError(f"row 4 stages: relative norm errors {rel} over PROJ_BWD_REL {PROJ_BWD_REL}")
    log("stage_check " + json.dumps({"name": "fused_proj_attention_train_bwd", "shape": f"spatial B={BATCH}",
                                     "rate": DROPOUT, "stages": stages}))
    del x, g, scratch, v, dqkv, dwo, dbo, want_qkv, want_do, dqkv_p, want_attn, want_dqkv
    torch.cuda.empty_cache()


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
            kernel = lambda: flash.fused_attention(q, k, v, bias)
            got, want = kernel(), flash.fused_attention_plain(q, k, v, bias)
            torch.cuda.synchronize()
            label = f"flash_attention {dtype} T={T}"
            err = _check_close(label, got, want, torch.ones_like(got, dtype=torch.bool), tol)
            rel = check_fwd_case(label, "flash_attention", kernel, got, want, q)
            log(f"kernel_check flash_attention {dtype} B={CHECK_CLIPS} T={T} lengths "
                f"{lengths.tolist()}: max_abs_err {err:.3e}, {rel}, two launches bit-identical")
        for T in (513, 1025):
            q, k, v = make_heads(CHECK_CLIPS, T, dtype, gen, device)
            lengths = ragged_lengths(CHECK_CLIPS, T, gen).to(device)
            kernel = lambda: flash.blockwise_attention(q, k, v, kv_lengths=lengths, causal=True)
            out, lse = kernel()
            want, want_lse = flash.blockwise_attention_plain(q, k, v, kv_lengths=lengths, causal=True)
            torch.cuda.synchronize()
            live = torch.arange(T, device=device)[None, :] < lengths[:, None]  # [B, T]
            label = f"blockwise_attention {dtype} T={T}"
            err = _check_close(label, out, want, live[:, :, None, None].expand(out.shape), tol)
            lse_err = _check_close(f"blockwise_attention lse {dtype} T={T}", lse, want_lse,
                                   live[:, None, :].expand(lse.shape), OP_TOL[torch.float32])
            rel = check_fwd_case(label, "blockwise_attention", kernel, (out, lse), want, q)
            log(f"kernel_check blockwise_attention {dtype} B={CHECK_CLIPS} T={T} lengths "
                f"{lengths.tolist()}: max_abs_err out {err:.3e}, lse {lse_err:.3e}, {rel}, dead rows "
                f"zeros with lse 0, two launches bit-identical")
            del q, k, v, out, lse, want, want_lse

        # Timing at the main path's shapes (every clip full length).
        q, k, v = make_heads(BATCH, 257, dtype, gen, device)
        full = torch.full((BATCH,), 257)
        bias = _causal_padding_bias(full, 257, device)
        flash.fused_attention(q, k, v, bias)
        body = check_fwd_body(f"flash_attention {dtype} B={BATCH}", "flash_attention", q)
        row = _measure(
            "flash_attention", "temporal", dtype, BATCH, q,
            lambda: flash.fused_attention(q, k, v, bias),
            lambda: flash.fused_attention_plain(q, k, v, bias),
            library_attention(q, k, v, bias.to(dtype)), flash_bound(q, bias, dtype),
            torch.ones((BATCH, 257, HEADS, H // HEADS), dtype=torch.bool, device=device), tol,
            rel_tol=ATTN_FWD_REL if dtype == torch.bfloat16 else None, twice=True, body=body,
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
            flash.blockwise_attention(q, k, v, kv_lengths=lengths, causal=True)
            body = check_fwd_body(f"blockwise_attention {dtype} B={clips} {name}", "blockwise_attention", q)
            row = _measure(
                "blockwise_attention", "temporal", dtype, clips, q,
                lambda: flash.blockwise_attention(q, k, v, kv_lengths=lengths, causal=True)[0],
                lambda: flash.blockwise_attention_plain(q, k, v, kv_lengths=lengths, causal=True)[0],
                library_attention(q, k, v, allowed), blockwise_bound(q, lengths, True, dtype),
                live[:, :, None, None].expand(q.shape), tol,
                rel_tol=ATTN_FWD_REL if dtype == torch.bfloat16 else None, twice=True, lengths=name,
                body=body,
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
                    kernel = lambda: flash.fused_attention(q, k, v, bias, with_lse=True, **kw)
                    want, want_lse = flash.fused_attention_plain(q, k, v, bias, with_lse=True, **kw)
                    live = torch.ones((CHECK_CLIPS, T), dtype=torch.bool, device=device)
                else:
                    kernel = lambda: flash.blockwise_attention(q, k, v, kv_lengths=lengths, causal=True, **kw)
                    want, want_lse = flash.blockwise_attention_plain(q, k, v, kv_lengths=lengths,
                                                                     causal=True, **kw)
                    live = torch.arange(T, device=device)[None, :] < lengths[:, None]
                out, lse = kernel()
                torch.cuda.synchronize()
                name = "flash_attention" if T < 513 else "blockwise_attention"
                label = f"{name} dropout {rate} {dtype} T={T}"
                err = _check_close(label, out, want, live[:, :, None, None].expand(out.shape), fwd_tol)
                lse_err = _check_close(f"{name} lse dropout {rate} {dtype} T={T}", lse, want_lse,
                                       live[:, None, :].expand(lse.shape), OP_TOL[torch.float32])
                rel = check_fwd_case(label, name, kernel, (out, lse), want, q)
                log(f"kernel_check {name} dropout {rate} {dtype} B={CHECK_CLIPS} T={T}: "
                    f"max_abs_err out {err:.3e} (atol {fwd_tol['atol']}), lse {lse_err:.3e}, {rel}, "
                    f"two launches bit-identical")
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
                "tol": tol, "rel_tol": BWD_REL[dtype], "plain_ms": cuda_ms(plain, 3),
                "bound_ms": bound[0], "bound_by": bound[1],
                "forward_dropout_plain_ms": cuda_ms(fwd_plain, 3),
                "forward_dropout_bound_ms": fwd_bound[0], "forward_dropout_bound_by": fwd_bound[1],
            }
            median_fields(row, ms=run, library_ms=library, forward_dropout_ms=fwd,
                          forward_dropout_library_ms=library_attention(q, k, v, mask, DROPOUT))
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


def tail_train_bounds(tokens, live_tokens, dtype, H=H):
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
    FF = 4 * H
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
    width = (n1s.shape[0],)

    def forward(x, a):
        u = F.layer_norm(x + F.dropout(a, rate), width, n1s, n1b, EPS)
        h = F.dropout(F.gelu(F.linear(u, w1, b1), approximate=approximate), rate)
        return F.layer_norm(u + F.dropout(F.linear(h, w2, b2), rate), width, n2s, n2b, EPS)

    def backward(y, x, a, g):
        return torch.autograd.grad(y, [x, a, *leaves], g, retain_graph=True)

    return forward, backward


def library_tail_row(w, dtype, rate):
    """Row 12's own yardstick: the autograd backward of ``F.layer_norm(u +
    F.dropout(h + b2))`` (LN2 and the out-dropout, torch's own dropout
    bits) to u, h, n2s, n2b and b2, the work of the row kernel from
    PyTorch's library calls (a yardstick only)."""
    leaves = [w[k].to(dtype).detach().clone().requires_grad_() for k in ("n2s", "n2b", "b2")]
    n2s, n2b, b2 = leaves
    width = (n2s.shape[0],)

    def forward(u, h):
        return F.layer_norm(u + F.dropout(h + b2, rate), width, n2s, n2b, EPS)

    def backward(y, u, h, g):
        return torch.autograd.grad(y, [u, h, *leaves], g, retain_graph=True)

    return forward, backward


def _tail_inputs(tokens, dtype, gen, device, ragged, H=H):
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
    tokens, width = x.shape
    mask = (torch.ones(tokens, dtype=torch.bool, device=x.device) if live is None
            else live)[:, None].expand(tokens, width)
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
    with GELU and dropout 0.1 (the weight products in two splits). Then, in bf16 with dropout 0.1 and every token live, at
    each of TAIL_SHAPES: the same check (264 row blocks, up to 8 splits),
    each kernel timed (the median of five windows) against its plain
    version, the library yardstick (likewise; row 12's its own, LN2 and the
    out-dropout's autograd backward, ``library_tail_row``, beside the whole
    backward's autograd for rows 12-14 jointly) and its bound, and the op-level A/B, the fused op's
    forward and backward against the layer's plain chain; at the 256-frame
    spatial shape a profile of rows 13 and 14's device kernels
    (TAIL_BWD_GROUPS). Returns the kernel-table rows (the 256-frame spatial
    shape)."""
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
    row_f, row_b = library_tail_row(w, dtype, DROPOUT)
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
        ul, hl = x.detach().requires_grad_(), a.detach().requires_grad_()
        y_row = row_f(ul, hl)
        runs = {
            "fused_layer_tail_train": (lambda: ftt._launch_tail_train(x, a, weights, cfg),
                                       lambda: ftt.fused_layer_tail_train_plain(x, a, weights, cfg),
                                       lambda: lib_f(x, a)),
            "fused_tail_train_bwd_row": (lambda: ftt._launch_bwd_row(r2, g, weights[6], cfg),
                                         lambda: ftt.tail_train_bwd_row_plain(r2, g, weights[6], cfg),
                                         lambda: row_b(y_row, ul, hl, g)),
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
            ms, spread = median_spread_ms(kernel, 5)
            row = {
                "name": name, "shape": shape, "tokens": tokens, "dtype": "bfloat16", "rate": DROPOUT,
                "max_abs_err": errs[name], "ms": ms, "ms_spread": spread, "plain_ms": cuda_ms(plain, 2),
                # Row 12's yardstick is its own (LN2 and the out-dropout's
                # autograd backward); rows 13 and 14 have none of their own.
                "library_ms": None if library is None else median_ms(library, 5),
                "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            }
            if name == "fused_tail_train_bwd_row":  # the whole backward's autograd: rows 12-14 jointly
                row["library_rows_12_14_ms"] = median_ms(lambda: lib_b(y_lib, xl, al, g), 5)
            log("kernel_check " + json.dumps(row))
            if shape == TAIL_SHAPES[0][0]:
                table[name] = row
        if shape == TAIL_SHAPES[0][0]:
            _device_profile("tail_bwd", lambda: ftt._launch_bwd_weight(
                ftt._launch_bwd_input(x, a, dr2, weights, cfg)[4]), TAIL_BWD_GROUPS,
                shape=shape, tokens=tokens, rows="13 + 14")
        del y_lib, y_row
        # The op-level A/B: the fused op (four kernels) against the layer's
        # plain chain, forward and backward, on the same inputs and seed.
        x3, a3, g3 = xl[None], al[None], g[None]
        fused = lambda: layer._fused_train_tail(x3, a3, seed, None, None).backward(g3)
        chain = lambda: layer._train_tail(x3, a3, seed).backward(g3)
        ab = {"shape": shape, "tokens": tokens, "fused_ms": cuda_ms(fused, 5),
              "chain_ms": cuda_ms(chain, 5)}
        ab["chain_over_fused"] = ab["chain_ms"] / ab["fused_ms"]
        log("tail_ab " + json.dumps(ab))
        del x, a, g, r2, dr2, scratch, xl, al, ul, hl, runs, x3, a3, g3
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
    wm = model_layout(w)
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
                    args = (x, ctx, wm["wq"], w["bq"], wm["wkv"], w["bkv"], wm["wo"], w["bo"], bias)
                    kw = dict(num_heads=HEADS, compute_dtype=dtype)
                    row = _measure(
                        "fused_cross_attention", "padded" if padded else "unpadded", dtype, clips, x,
                        lambda: fe.fused_cross_attention(*args, **kw),
                        lambda: fe.fused_cross_attention_plain(*args, **kw),
                        lambda: lib(x, ctx, bias), cross_bound(x, ctx, bias, dtype),
                        torch.ones(x.shape, dtype=torch.bool, device=device), tol,
                        rel_tol=CROSS_REL if dtype == torch.bfloat16 else None, twice=True,
                        S=S,
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
                body = check_fwd_body(f"blockwise_attention_dense {dtype} B={clips} {T}x{S}",
                                      "blockwise_attention", q)
                row = _measure(
                    "blockwise_attention_dense", f"{T}x{S} {kind}{' causal' if causal else ''}",
                    dtype, clips, q,
                    lambda: flash.blockwise_attention(q, k, v, **kw)[0],
                    lambda: flash.blockwise_attention_plain(q, k, v, **kw)[0],
                    library, dense_bound(q, k, bias, dtype),
                    torch.ones(q.shape, dtype=torch.bool, device=device), tol,
                    rel_tol=ATTN_FWD_REL if dtype == torch.bfloat16 else None, twice=True, S=S,
                    lse_max_abs_err=lse_err, body=body,
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
                 torch.ones(x.shape, dtype=torch.bool, device=device), tol, twice=True)
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
                "tol": OP_TOL[dtype], "rel_tol": rel_tol, "plain_ms": cuda_ms(plain, 3),
                "bound_ms": bound[0], "bound_by": bound[1],
            }
            median_fields(row, ms=run, library_ms=library_attention_bwd(q, k, v, mask, dout, DROPOUT))
            log("kernel_check " + json.dumps(row))
            if (dtype, T, S, kind, causal) == (torch.bfloat16, 513, 513, "causal_padding", False):
                table["blockwise_attention_bwd_dense"] = row
            del q, k, v, dout, out, lse, dsum, got, want, bias, mask
            torch.cuda.empty_cache()
    return table


# --- phase 3: the main path through the prediction entry point ----------------


# --- phase 2, widths: every kernel at other head dims and widths ------------

# (H, heads) of the width checks: head dim 32 (H = 256, 8 heads), an odd
# width (H = 320, 5 heads of 64) and head dim 128 at the widest H (H = 1024,
# 8 heads). The long-clip attention kernels take the same heads.
WIDTH_CASES = ((256, 8), (320, 5), (1024, 8))


def _width_row(name, label, dtype, kernel, plain, err, rel=None, library=None, bound=None):
    """Time one new shape once (CUDA events, 3 launches after warmup) and
    print its row; the layer tails' rows also with their library yardstick
    and bound."""
    row = {"name": name, "shape": label, "dtype": str(dtype).split(".")[1], "max_abs_err": err,
           "rel_err": rel, "ms": cuda_ms(kernel, 3), "plain_ms": cuda_ms(plain, 3)}
    if library is not None:
        row["library_ms"] = cuda_ms(library, 3)
        row["bound_ms"], row["bound_by"] = bound
    log("width_check " + json.dumps(row))
    return row


def _check_pairs(label, pairs, tol, rel_tol=None):
    """Each (name, got, want, live) within ``tol`` elementwise (dead entries
    exact zeros) and, with ``rel_tol``, in relative norm; returns (largest
    elementwise error, the relative norm errors)."""
    errs, rel = [], {}
    for name, got, want, live in pairs:
        live = torch.ones_like(got, dtype=torch.bool) if live is None else live
        errs.append(_check_close(f"{label} {name}", got, want, live, tol))
        rel[name] = _rel(got, want)
    if rel_tol is not None and max(rel.values()) > rel_tol:
        raise AssertionError(f"{label}: relative norm errors {rel} over {rel_tol}")
    return max(errs), rel


def check_width_kernels(device):
    """Every kernel against its plain version at WIDTH_CASES, bf16 and f32,
    with the tolerances its row has at the main path's width: rows 1-4 (the
    eval and train projection kernels at T = 8, 17 and 33), row 2 and rows
    11-14 (the layer tail, the fused train tail at 2,056 ragged tokens with
    dropout 0.1), row 5 (17 queries against 33 keys), rows 6-7 (T = 257,
    dropout 0.1), rows 8-10 in the lengths mode (T = 513, causal, ragged,
    dropout 0.1) and the dense-bias mode (513 x 513 causal+padding bias).
    Each new shape is timed once against its plain version."""
    from stlt_tpu_torch.ops import flash
    from stlt_tpu_torch.ops import fused_encoder as fe
    from stlt_tpu_torch.ops import fused_tail_train as ftt
    from stlt_tpu_torch.ops import masks

    gen = torch.Generator().manual_seed(SEED + 9)
    seed = 0x5EED5EED
    rows = []
    for width, heads in WIDTH_CASES:
        D = width // heads
        w = make_weights(gen, device, width)
        w.update(wq=w["wqkv"][:, :width], bq=w["bqkv"][:width], wkv=w["wqkv"][:, width:],
                 bkv=w["bqkv"][width:])
        for dtype in (torch.bfloat16, torch.float32):
            tol = OP_TOL[dtype]
            tag = f"H={width} N={heads} D={D} {dtype}"
            # Rows 1, 3, 4: the spatial (T = 8), temporal (T = 17) and 32-frame (T = 33) stages.
            for T, clips in ((8, 16 * NUM_FRAMES), (NUM_FRAMES, 64), (LONG_FRAMES, 32)):
                x = torch.randn((clips, T, width), generator=gen).to(device, dtype)
                lengths = torch.randint(1, T + 1, (clips,), generator=gen)
                bias = _causal_padding_bias(lengths, T, device)
                live = torch.rand(clips, generator=gen) < 0.8
                rows_live = live.to(device)
                kw = dict(num_heads=heads, compute_dtype=dtype, rows_live=rows_live)
                mask = rows_live[:, None, None].expand(x.shape)
                args = (x, w["wqkv"], w["bqkv"], w["wo"], w["bo"], bias)
                kernel = lambda: fe.fused_proj_attention(*args, **kw)
                plain = lambda: fe.fused_proj_attention_plain(*args, **kw)
                err, _ = _check_pairs(f"fused_proj_attention {tag} T={T}",
                                      [("out", kernel(), plain(), mask)], tol)
                rows.append(_width_row("fused_proj_attention", f"{tag} T={T} rows={clips}", dtype,
                                       kernel, plain, err))
                tkw = dict(kw, dropout_rate=DROPOUT)
                fwd = (x, w["wqkv"], w["bqkv"], w["wo"], w["bo"], bias, seed)
                kernel = lambda: fe.fused_proj_attention_train(*fwd, **tkw)
                plain = lambda: fe.fused_proj_attention_train_plain(*fwd, **tkw)
                err, _ = _check_pairs(f"fused_proj_attention_train {tag} T={T}",
                                      [("out", kernel(), plain(), mask)], tol)
                rows.append(_width_row("fused_proj_attention_train", f"{tag} T={T} rows={clips}",
                                       dtype, kernel, plain, err))
                g = torch.randn(x.shape, generator=gen).to(device, dtype)
                g[~rows_live] = 0
                bwd = (x, w["wqkv"], w["bqkv"], w["wo"], bias, g, seed)
                kernel = lambda: fe._launch_proj_bwd(*bwd, **tkw)
                plain = lambda: fe.fused_proj_attention_train_bwd_plain(*bwd, **tkw)
                got, want = kernel(), plain()
                err, _ = _check_pairs(f"fused_proj_attention_train_bwd {tag} T={T}",
                                      [("dqkv", got[0], want[0], mask.repeat(1, 1, 3))], tol)
                rel = {"dwo": _rel(got[1], want[1]), "dbo": _rel(got[2], want[2])}
                if dtype == torch.bfloat16:
                    rel["dqkv"] = _rel(got[0], want[0])
                limit = PROJ_BWD_REL if dtype == torch.bfloat16 else GRAD_REL[dtype]
                if not max(rel.values()) <= limit:
                    raise AssertionError(f"fused_proj_attention_train_bwd {tag} T={T}: {rel} over {limit}")
                rows.append(_width_row("fused_proj_attention_train_bwd", f"{tag} T={T} rows={clips}",
                                       dtype, kernel, plain, err, rel))
                del x, g, got, want
            # Row 2: the eval tail over the spatial stage's tokens, ragged.
            x = torch.randn((16 * NUM_FRAMES, NUM_BOXES, width), generator=gen).to(device, dtype)
            a = (0.5 * torch.randn(x.shape, generator=gen)).to(device, dtype)
            tokens_live = (torch.rand(x.shape[:2], generator=gen) < 0.7).to(device)
            targs = (x, a, w["n1s"], w["n1b"], w["w1"], w["b1"], w["w2"], w["b2"], w["n2s"], w["n2b"])
            tkw = dict(eps=EPS, compute_dtype=dtype, activation="gelu",
                       gelu_approximate=dtype == torch.bfloat16, tokens_live=tokens_live)
            kernel = lambda: fe.fused_layer_tail(*targs, **tkw)
            plain = lambda: fe.fused_layer_tail_plain(*targs, **tkw)
            got = kernel()
            err, _ = _check_pairs(f"fused_layer_tail {tag}",
                                  [("out", got, plain(), tokens_live[..., None].expand(x.shape))],
                                  tol)
            if not torch.equal(got, kernel()):
                raise AssertionError(f"fused_layer_tail {tag}: two launches differ")
            rows.append(_width_row("fused_layer_tail", f"{tag} tokens={x.shape[0] * NUM_BOXES}",
                                   dtype, kernel, plain, err,
                                   library=lambda: library_tail(w, dtype)(x, a),
                                   bound=tail_bound(x, tokens_live, dtype)))
            # Rows 11-14: the fused train tail (its own rows' limits).
            xt, at, gt, lt = _tail_inputs(8 * 257, dtype, gen, device, True, width)
            cfg = ftt.TailConfig(EPS, "gelu", dtype == torch.bfloat16, DROPOUT, seed)
            errs = _check_tail_case(f"{tag} tokens={8 * 257} gelu rate={DROPOUT} ragged", xt, at, gt,
                                    lt, _tail_weights(w), cfg, dtype)
            lib_f = library_tail_train(w, dtype, DROPOUT)[0]
            rows.append(_width_row(
                "fused_layer_tail_train", f"{tag} tokens={8 * 257}", dtype,
                lambda: ftt._launch_tail_train(xt, at, _tail_weights(w), cfg, lt),
                lambda: ftt.fused_layer_tail_train_plain(xt, at, _tail_weights(w), cfg, lt),
                errs["fused_layer_tail_train"], library=lambda: lib_f(xt, at),
                bound=tail_train_bounds(8 * 257, int(lt.sum()), dtype, width)["fused_layer_tail_train"]))
            r2 = ftt._launch_tail_train(xt, at, _tail_weights(w), cfg, lt)[1]
            rows.append(_width_row(
                "fused_tail_train (rows 11-14, forward + backward)", f"{tag} tokens={8 * 257}", dtype,
                lambda: (ftt._launch_tail_train(xt, at, _tail_weights(w), cfg, lt),
                         ftt._launch_tail_train_bwd(xt, at, r2, gt, _tail_weights(w), cfg, lt)),
                lambda: (ftt.fused_layer_tail_train_plain(xt, at, _tail_weights(w), cfg, lt),
                         ftt.fused_layer_tail_train_bwd_plain(xt, at, r2, gt, _tail_weights(w), cfg, lt)),
                max(errs.values())))
            del x, a, xt, at, gt, lt, r2
            # Row 5: 17 queries against 33 keys, key padding.
            x = torch.randn((32, 17, width), generator=gen).to(device, dtype)
            ctx = torch.randn((32, 33, width), generator=gen).to(device, dtype)
            pad = torch.arange(33)[None, :] >= torch.randint(1, 34, (32,), generator=gen)[:, None]
            cbias = masks.key_padding_bias(pad).to(device)
            cargs = (x, ctx, w["wq"], w["bq"], w["wkv"], w["bkv"], w["wo"], w["bo"], cbias)
            ckw = dict(num_heads=heads, compute_dtype=dtype)
            kernel = lambda: fe.fused_cross_attention(*cargs, **ckw)
            plain = lambda: fe.fused_cross_attention_plain(*cargs, **ckw)
            err, rel = _check_pairs(f"fused_cross_attention {tag}", [("out", kernel(), plain(), None)],
                                    tol, CROSS_REL if dtype == torch.bfloat16 else None)
            rows.append(_width_row("fused_cross_attention", f"{tag} T=17 S=33 B=32", dtype, kernel,
                                   plain, err, rel))
            del x, ctx
            # Rows 6-7: the short kernel and its backward, T = 257, dropout 0.1.
            B, T = 8, 257
            qkv = torch.randn((B, T, 3, heads, D), generator=gen).to(device, dtype)
            q, k, v = qkv.unbind(2)
            lengths = ragged_lengths(B, T, gen)
            bias = _causal_padding_bias(lengths, T, device)
            drop = dict(dropout_rate=DROPOUT, dropout_seed=seed)
            kernel = lambda: flash.fused_attention(q, k, v, bias, with_lse=True, **drop)
            plain = lambda: flash.fused_attention_plain(q, k, v, bias, with_lse=True, **drop)
            (out, lse), (want, want_lse) = kernel(), plain()
            err, rel = _check_pairs(f"flash_attention {tag}", [("out", out, want, None),
                                                               ("lse", lse, want_lse, None)], tol,
                                    None if dtype == torch.float32 else ATTN_FWD_REL)
            check_fwd_case(f"flash_attention {tag}", "flash_attention", kernel, (out, lse), want, q)
            rows.append(_width_row("flash_attention", f"{tag} B={B} T={T} rate={DROPOUT}", dtype,
                                   kernel, plain, err, rel))
            dout = torch.randn(q.shape, generator=gen).to(device, dtype)
            dsum = flash._dsum(dout, want, None)
            bargs = (q, k, v, dout, want_lse, dsum)
            kernel = lambda: flash.fused_attention_bwd(*bargs, bias, **drop)
            plain = lambda: flash.attention_bwd_plain(*bargs, bias=bias, **drop)
            err, rel = _check_grads(f"flash_attention_bwd {tag}", kernel(), plain(), None, dtype)
            rows.append(_width_row("flash_attention_bwd", f"{tag} B={B} T={T} rate={DROPOUT}", dtype,
                                   kernel, plain, err, rel))
            # Rows 8-10, lengths mode: T = 513, causal, ragged, dropout 0.1.
            B, T = 4, 513
            qkv = torch.randn((B, T, 3, heads, D), generator=gen).to(device, dtype)
            q, k, v = qkv.unbind(2)
            lengths = ragged_lengths(B, T, gen)
            lkw = dict(kv_lengths=lengths.to(device), causal=True, **drop)
            kernel = lambda: flash.blockwise_attention(q, k, v, **lkw)
            plain = lambda: flash.blockwise_attention_plain(q, k, v, **lkw)
            (out, lse), (want, want_lse) = kernel(), plain()
            live = (torch.arange(T)[None, :] < lengths[:, None]).to(device)
            err, rel = _check_pairs(f"blockwise_attention {tag}", [
                ("out", out, want, live[:, :, None, None].expand(out.shape)),
                ("lse", lse, want_lse, live[:, None, :].expand(lse.shape))], tol,
                None if dtype == torch.float32 else ATTN_FWD_REL)
            check_fwd_case(f"blockwise_attention {tag}", "blockwise_attention", kernel, (out, lse), want, q)
            rows.append(_width_row("blockwise_attention", f"{tag} B={B} T={T} causal ragged "
                                   f"rate={DROPOUT}", dtype, kernel, plain, err, rel))
            dout = torch.randn(q.shape, generator=gen).to(device, dtype)
            dsum = flash._dsum(dout, want, lengths.to(device))
            bargs = (q, k, v, dout, want_lse, dsum)
            kernel = lambda: flash.blockwise_attention_bwd(*bargs, **lkw)
            plain = lambda: flash.attention_bwd_plain(*bargs, **lkw)
            err, rel = _check_grads(f"blockwise_attention_bwd {tag}", kernel(), plain(), ~live, dtype)
            rows.append(_width_row("blockwise_attention_bwd", f"{tag} B={B} T={T} causal ragged "
                                   f"rate={DROPOUT}", dtype, kernel, plain, err, rel))
            # Rows 8-10, dense-bias mode: 513 x 513, causal+padding bias, no flag.
            dbias = _causal_padding_bias(lengths, T, device)
            kernel = lambda: flash.blockwise_attention(q, k, v, bias=dbias)
            plain = lambda: flash.blockwise_attention_plain(q, k, v, bias=dbias)
            (out, lse), (want, want_lse) = kernel(), plain()
            err, rel = _check_pairs(f"blockwise_attention_dense {tag}", [
                ("out", out, want, None), ("lse", lse, want_lse, None)], tol,
                None if dtype == torch.float32 else ATTN_FWD_REL)
            check_fwd_case(f"blockwise_attention_dense {tag}", "blockwise_attention", kernel, (out, lse),
                           want, q)
            rows.append(_width_row("blockwise_attention_dense", f"{tag} B={B} {T}x{T}", dtype,
                                   kernel, plain, err, rel))
            dsum = flash._dsum(dout, want, None)
            bargs = (q, k, v, dout, want_lse, dsum)
            kernel = lambda: flash.blockwise_attention_bwd(*bargs, bias=dbias)
            plain = lambda: flash.attention_bwd_plain(*bargs, bias=dbias)
            err, rel = _check_grads(f"blockwise_attention_bwd_dense {tag}", kernel(), plain(), None,
                                    dtype, None if dtype == torch.float32 else DENSE_BWD_REL)
            rows.append(_width_row("blockwise_attention_bwd_dense", f"{tag} B={B} {T}x{T}", dtype,
                                   kernel, plain, err, rel))
            del q, k, v, qkv, out, lse, want, want_lse, dout, dsum, bargs
            torch.cuda.empty_cache()
    log(f"widths: {len(rows)} checks passed at (H, heads) in {WIDTH_CASES}, bf16 and f32")
    return rows


# --- phase 2, ring offsets: the blockwise forward's ring-offset mode ---------

# The per-rank shapes of a 512-frame clip at C = 2 (513 frames padded to
# 514): 257 local queries against a held chunk of 257 keys, 12 heads of 64.
RING_CLIPS, RING_T = 32, 257
RING_OFFSETS = ((0, 0), (0, RING_T), (RING_T, 0), (RING_T, RING_T))


def offsets_bound(q, lengths, causal, offsets, dtype):
    """(ms, "bytes" | "operations") for one ring step of the blockwise
    kernel, counted at global indices as blockwise_bound counts the lengths
    mode (_offsets_counts): the flops of the (query, key) pairs these
    offsets leave live; q read for the live query rows, k and v for the
    keys that some live query of the clip attends; out and lse written for
    every row, the lengths read once."""
    B, T, N, D = q.shape
    pairs, q_rows, kv_rows = _offsets_counts(T, lengths, causal, offsets)
    es = q.element_size()
    nbytes = (q_rows + 2 * kv_rows) * N * D * es + B * T * N * D * es + B * N * T * 4 + B * 4
    return _bound(4 * D * N * pairs, nbytes, dtype)


def _offsets_counts(T, lengths, causal, offsets):
    """(live (query, key) pairs, live query rows, keys some live query of the
    clip attends) of a ring step over T local queries and keys, at global
    indices (global key col0 + s < length, col0 + s <= row0 + t when causal,
    query row0 + t < length)."""
    row0, col0 = offsets
    rows = torch.arange(T)[None, :, None] + row0
    cols = torch.arange(T)[None, None, :] + col0
    L = lengths.cpu()[:, None, None]
    live = (cols < L) & (rows < L) & ((cols <= rows) if causal else True)
    return float(live.sum()), float((rows < L).sum()), float(live.any(dim=1).sum())


def check_offsets_kernel(device):
    """The blockwise forward's ring-offset mode against its plain version
    (``blockwise_attention_plain`` with the same offsets), bf16 and f32, at
    RING_OFFSETS with causal ragged lengths 33-513, out and lse on live rows
    within OP_TOL (ATTN_FWD_REL in relative norm in bf16), dead
    rows exact zeros with lse 0, the rows with no live key in the chunk
    (merge-wiped) zeros with lse -1e30, and once with a dropout seed. Timed
    against its plain version, ``scaled_dot_product_attention`` with the same
    mask, and its bound. Returns the kernel-table row (bf16, (257, 0): rank
    1's rows against chunk 0, every key a candidate)."""
    from stlt_tpu_torch.ops import flash

    gen = torch.Generator().manual_seed(SEED + 10)
    table = {}
    for dtype in (torch.bfloat16, torch.float32):
        tol = OP_TOL[dtype]
        q, k, v = make_heads(RING_CLIPS, RING_T, dtype, gen, device)
        lengths = torch.randint(33, 2 * RING_T, (RING_CLIPS,), generator=gen)
        lengths[0], lengths[1] = 33, 2 * RING_T - 1
        for offsets in RING_OFFSETS:
            for seed in (None, 0x5EED5EED):
                if seed is not None and offsets != (RING_T, 0):
                    continue
                kw = dict(kv_lengths=lengths.to(device), causal=True, offsets=offsets,
                          dropout_seed=seed, dropout_rate=DROPOUT if seed is not None else 0.0)
                kernel = lambda: flash.blockwise_attention(q, k, v, **kw)
                plain = lambda: flash.blockwise_attention_plain(q, k, v, **kw)
                (out, lse), (want, want_lse) = kernel(), plain()
                torch.cuda.synchronize()
                label = f"blockwise_attention offsets={offsets} {dtype} rate={kw['dropout_rate']}"
                row0, col0 = offsets
                t = torch.arange(RING_T)[None, :] + row0
                live = (t < lengths[:, None]).to(device)  # [B, T]
                none = ((col0 >= lengths[:, None]) | (col0 > t)).to(device) & live
                err, rel = _check_pairs(label, [
                    ("out", out, want, live[:, :, None, None].expand(out.shape)),
                    ("lse", lse, want_lse, live[:, None, :].expand(lse.shape))], tol,
                    ATTN_FWD_REL if dtype == torch.bfloat16 else None)
                body = check_fwd_case(label, "blockwise_attention", kernel, (out, lse), want, q)["body"]
                wiped = lse.transpose(1, 2)[none]
                if none.any() and not (bool((wiped == flash._NEG_INF).all()) and
                                       out[none].abs().max().item() == 0.0):
                    raise AssertionError(f"{label}: merge-wiped rows are not zeros with lse -1e30")
                mask = flash._offsets_bias(lengths.to(device), RING_T, RING_T, True, offsets).to(dtype)
                row = {"name": "blockwise_attention_offsets", "offsets": list(offsets),
                       "dtype": str(dtype).split(".")[1], "clips": RING_CLIPS, "T": RING_T,
                       "rate": kw["dropout_rate"], "max_abs_err": err, "rel_err": rel,
                       "live_rows": int(live.sum()), "wiped_rows": int(none.sum()), "body": body,
                       "plain_ms": cuda_ms(plain, 3)}
                median_fields(row, ms=kernel, library_ms=library_attention(q, k, v, mask))
                row["bound_ms"], row["bound_by"] = offsets_bound(q, lengths, True, offsets, dtype)
                log("kernel_check " + json.dumps(row))
                if dtype == torch.bfloat16 and offsets == (RING_T, 0) and seed is None:
                    table["blockwise_attention_offsets"] = row
        del q, k, v
        torch.cuda.empty_cache()
    return table



# --- phase 2, the dropout-mask operand: rows 6-10 in mask mode ---------------

# (route, clips, T) of the mask-mode checks, at the main paths' train shapes:
# the short kernel at B = 32, T = 257 (the 256-frame train batch); the
# blockwise kernel in lengths mode and in dense-bias mode (causal+padding,
# flag off) at B = 16, T = 513 (the 512-frame train batch); its ring-offset
# mode at (257, 0), B = 32 (rank 1's rows against chunk 0 of a 514-frame
# clip, lengths 33-513), whose mask is the chunk's column view of the rank's
# [B, N, 257, 514] rows.
MASK_CASES = (("flash", LONG_TRAIN[256][0], 257), ("lengths", LONG_TRAIN[512][0], 513),
              ("dense", LONG_TRAIN[512][0], 513), ("offsets", RING_CLIPS, RING_T))
MASK_SEED = 0xC0FFEE


def mask_bounds(q, allowed, mask, extra_bytes, dtype):
    """(forward, backward) bounds of a mask-mode launch: 4*D (forward) or
    10*D (backward) flops per (query, key, head) pair that the bias or the
    lengths let through (``allowed``, [B, 1, T, S]); q, k, v (and dO) read
    once, out and lse (dq, dk, dv) written once, lse and dsum read by the
    backward, plus the bias or lengths (``extra_bytes``) and the uint8 mask
    (as passed) read once."""
    B, T, N, D = q.shape
    S = allowed.shape[-1]
    pairs = float(allowed.expand(B, 1, T, S).sum()) * N
    es, rows, keys = q.element_size(), B * T * N * D, B * S * N * D
    extra = extra_bytes + mask.numel()
    fwd = _bound(4 * D * pairs, (2 * rows + 2 * keys) * es + B * N * T * 4 + extra, dtype)
    bwd = _bound(10 * D * pairs, (3 * rows + 4 * keys) * es + 2 * B * N * T * 4 + extra, dtype)
    return fwd, bwd


def _mask_case(route, clips, T, dtype, gen, cuda_gen, device):
    """q, k, v, the wrappers' keyword arguments with a Bernoulli(0.9) keep
    mask (per head, made on the card), the forward and backward wrappers and
    plain forward, the [B, T] live rows, ``allowed`` and the extra bytes for
    the bound, and the first clip with a live row 0."""
    from stlt_tpu_torch.ops import flash

    q, k, v = make_heads(clips, T, dtype, gen, device)
    shape = (clips, HEADS, T, T)
    live = torch.ones((clips, T), dtype=torch.bool, device=device)
    first = 0
    if route == "flash":
        bias = _causal_padding_bias(torch.full((clips,), T), T, device)
        kw = dict(bias=bias)
        allowed, extra = bias == 0, bias.numel() * 4
        fwd, bwd, plain = flash.fused_attention, flash.fused_attention_bwd, flash.fused_attention_plain
    elif route == "offsets":
        lengths = torch.randint(33, 2 * T, (clips,), generator=gen)
        lengths[0], lengths[1] = 33, 2 * T - 1
        lengths = lengths.to(device)
        kw = dict(kv_lengths=lengths, causal=True, offsets=(T, 0))
        allowed = flash._offsets_bias(lengths, T, T, True, (T, 0)) == 0
        extra = clips * 4
        live = torch.arange(T, device=device)[None, :] + T < lengths[:, None]
        first = 1
        shape = (clips, HEADS, T, 2 * T)
        fwd, bwd, plain = (flash.blockwise_attention, flash.blockwise_attention_bwd,
                           flash.blockwise_attention_plain)
    else:
        fwd, bwd, plain = (flash.blockwise_attention, flash.blockwise_attention_bwd,
                           flash.blockwise_attention_plain)
        if route == "lengths":
            lengths = torch.full((clips,), T, device=device)
            kw = dict(kv_lengths=lengths, causal=True)
            allowed, extra = flash._lengths_dense_bias(lengths, T, T, True) == 0, clips * 4
        else:
            bias = _causal_padding_bias(torch.randint(33, T + 1, (clips,), generator=gen), T, device)
            kw = dict(bias=bias)
            allowed, extra = bias == 0, bias.numel() * 4
    keep = torch.rand(shape, generator=cuda_gen, device=device) >= DROPOUT
    kw.update(dropout_mask=keep[..., :T], dropout_rate=DROPOUT)
    return q, k, v, kw, fwd, bwd, plain, live, allowed, extra, first


def _mask_forward(fn, q, k, v, kw):
    """(out, lse) of a forward wrapper or plain version: the short ones take
    the bias positionally and give lse on request."""
    from stlt_tpu_torch.ops import flash

    if fn in (flash.fused_attention, flash.fused_attention_plain):
        rest = {n: x for n, x in kw.items() if n != "bias"}
        return fn(q, k, v, kw["bias"], with_lse=True, **rest)
    return fn(q, k, v, **kw)


def check_mask_kernels(device):
    """Rows 6-10 with the dropout-mask operand, at MASK_CASES, bf16 and f32:
    the forward (out and lse of live rows; f32 within FWD_DROP_TOL, which
    needs equal keep bits) and the backward (dq, dk, dv within BWD_REL, the
    dense mode's bf16 within DENSE_BWD_REL) against their plain versions,
    and each launch counted as its mask mode; in f32 a planted fault, one
    flipped keep bit at (t, s) = (0, 0) of a live row, must move the output
    past FWD_DROP_TOL; in bf16 a mask equal to ``hash_keep_mask(seed, ...)``
    must give the seed mode's out, lse, dq, dk and dv bit for bit. The bf16
    forward and backward timed against their plain versions,
    ``scaled_dot_product_attention`` with the same mask and ``dropout_p``
    (forward and autograd backward) and their bounds. Returns the bf16 rows."""
    from stlt_tpu_torch.ops import flash
    from stlt_tpu_torch.ops.dropout import hash_keep_mask

    gen = torch.Generator().manual_seed(SEED + 17)
    cuda_gen = torch.Generator(device=device).manual_seed(SEED + 17)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for route, clips, T in MASK_CASES:
            q, k, v, kw, fwd, bwd, plain, live, allowed, extra, first = _mask_case(
                route, clips, T, dtype, gen, cuda_gen, device)
            name = "flash_attention" if fwd is flash.fused_attention else "blockwise_attention"
            label = f"{name} mask mode {route} {dtype} B={clips} T={T}"
            flash.reset_launches()
            out, lse = _mask_forward(fwd, q, k, v, kw)
            want, want_lse = _mask_forward(plain, q, k, v, kw)
            dout = torch.randn(out.shape, generator=gen).to(device, dtype)
            dsum = flash._dsum(dout, want, kw.get("kv_lengths"), kw.get("offsets", (0, 0))[0])
            got = bwd(q, k, v, dout, want_lse, dsum, **kw)
            wanted = flash.attention_bwd_plain(q, k, v, dout, want_lse, dsum, **kw)
            torch.cuda.synchronize()
            counts = {n: c for n, c in flash.LAUNCHES.items() if c}
            if counts != {name + "_mask": 1, name + "_bwd_mask": 1}:
                raise AssertionError(f"{label}: launches {counts}")
            fwd_tol = FWD_DROP_TOL if dtype == torch.float32 else OP_TOL[dtype]
            err, _ = _check_pairs(label, [
                ("out", out, want, live[:, :, None, None].expand(out.shape)),
                ("lse", lse, want_lse, live[:, None, :].expand(lse.shape))], fwd_tol)
            fwd_kernel = lambda: _mask_forward(fwd, q, k, v, kw)
            fwd_rel = check_fwd_case(label, name, fwd_kernel, (out, lse), want, q)
            rel_tol = DENSE_BWD_REL if route == "dense" and dtype == torch.bfloat16 else None
            bwd_err, rel = _check_grads(f"{label} backward", got, wanted, None, dtype, rel_tol)
            note = ""
            if dtype == torch.float32:
                flipped = kw["dropout_mask"].clone()
                flipped[first, 0, 0, 0] = ~flipped[first, 0, 0, 0]
                fault = _mask_forward(fwd, q, k, v, {**kw, "dropout_mask": flipped})[0]
                moved = (fault - want).abs() > fwd_tol["atol"] + fwd_tol["rtol"] * want.abs()
                if not bool(moved.any()):
                    raise AssertionError(f"{label}: one flipped keep bit stays within FWD_DROP_TOL")
                note = f", one flipped keep bit moves {int(moved.sum())} outputs past FWD_DROP_TOL"
            else:
                seeded = {n: x for n, x in kw.items() if n != "dropout_mask"}
                seeded["dropout_seed"] = MASK_SEED
                hashed = {**kw, "dropout_mask": hash_keep_mask(MASK_SEED, clips, HEADS, T, T, DROPOUT,
                                                               device)}
                a, b = _mask_forward(fwd, q, k, v, seeded), _mask_forward(fwd, q, k, v, hashed)
                ga = bwd(q, k, v, dout, want_lse, dsum, **seeded)
                gb = bwd(q, k, v, dout, want_lse, dsum, **hashed)
                if not all(torch.equal(x, y) for x, y in zip((*a, *ga), (*b, *gb))):
                    raise AssertionError(f"{label}: the hash_keep_mask mask differs from the seed mode")
                note = ", the hash_keep_mask mask equal to the seed mode bit for bit"
                del a, b, ga, gb, hashed
            log(f"kernel_check {label}: max_abs_err out/lse {err:.3e}, backward {bwd_err:.3e}, "
                f"forward {fwd_rel}, two launches bit-identical, "
                f"relative norm errors {json.dumps(rel)}{note}")
            if dtype == torch.bfloat16:
                fwd_bound, bwd_bound = mask_bounds(q, allowed, kw["dropout_mask"], extra, dtype)
                lib_fwd = library_attention(q, k, v, allowed, DROPOUT)
                lib_bwd = library_attention_bwd(q, k, v, allowed, dout, DROPOUT)
                for n, kernel, plain_fn, library, bound, e in (
                        (name + "_mask", lambda: _mask_forward(fwd, q, k, v, kw),
                         lambda: _mask_forward(plain, q, k, v, kw), lib_fwd, fwd_bound, err),
                        (name + "_bwd_mask", lambda: bwd(q, k, v, dout, want_lse, dsum, **kw),
                         lambda: flash.attention_bwd_plain(q, k, v, dout, want_lse, dsum, **kw),
                         lib_bwd, bwd_bound, bwd_err)):
                    row = {"name": n, "route": route, "dtype": "bfloat16", "clips": clips, "T": T,
                           "rate": DROPOUT, "max_abs_err": e, "plain_ms": cuda_ms(plain_fn, 3),
                           "bound_ms": bound[0], "bound_by": bound[1]}
                    median_fields(row, ms=kernel, library_ms=library)
                    log("kernel_check " + json.dumps(row))
                    rows.append(row)
                del lib_fwd, lib_bwd
            del q, k, v, kw, out, lse, want, want_lse, dout, dsum, got, wanted, allowed
            torch.cuda.empty_cache()
    return rows

# --- phase 2, ring offsets: the blockwise backward's ring-offset mode --------

RING_BWD_CLIPS = 16  # the 512-frame train batch (LONG_TRAIN[512])


def offsets_bwd_bound(q, lengths, causal, offsets, dtype):
    """(ms, "bytes" | "operations") for one step of the ring's backward,
    counted at global indices as attention_bwd_bound counts the lengths mode:
    10*D flops per live (query, key, head) pair; q and dO read for the live
    query rows, k and v for the keys some live query of the clip attends,
    lse and dsum read and dq, dk, dv written for every row, the lengths read
    once."""
    B, T, N, D = q.shape
    pairs, q_rows, kv_rows = _offsets_counts(T, lengths, causal, offsets)
    es = q.element_size()
    nbytes = (2 * q_rows + 2 * kv_rows) * N * D * es + 3 * B * T * N * D * es + 2 * B * N * T * 4 + B * 4
    return _bound(10 * D * N * pairs, nbytes, dtype)


class nan_filled_outputs:
    """Within the block every new floating tensor from ``torch.empty`` is
    filled with NaN, so an output a kernel leaves unwritten shows."""

    def __enter__(self):
        self.empty = torch.empty

        def empty(*args, **kwargs):
            x = self.empty(*args, **kwargs)
            return x.fill_(float("nan")) if x.is_floating_point() else x

        torch.empty = empty
        return self

    def __exit__(self, *exc):
        torch.empty = self.empty
        return False


def check_offsets_bwd_kernel(device):
    """The blockwise backward's ring-offset mode against its plain version
    (``attention_bwd_plain`` with the same offsets), bf16 and f32, dropout 0
    and 0.1, at RING_OFFSETS on a 514-slot clip's per-rank shapes at C = 2
    (B = 16, 257 queries against a chunk of 257 keys, causal, lengths
    33-513), from the whole clip's lse and output as a ring step takes
    them, with a cotangent of 1e30 on dead rows: dq, dk and dv within
    BWD_REL in relative norm and OP_TOL elementwise, dq of dead rows and of
    rows with no live key in the chunk exact zeros, outputs filled with NaN
    before the launch all written, two launches bit-identical. Timed (bf16)
    against its plain version, the autograd backward of
    ``scaled_dot_product_attention`` with the same mask and its bound.
    Returns the kernel-table row (bf16, dropout 0.1, (257, 0): rank 1's rows
    against chunk 0, every key a candidate)."""
    from stlt_tpu_torch.ops import flash

    gen = torch.Generator().manual_seed(SEED + 14)
    table = {}
    for dtype in (torch.bfloat16, torch.float32):
        q_all, k_all, v_all = make_heads(RING_BWD_CLIPS, 2 * RING_T, dtype, gen, device)
        lengths = torch.randint(33, 2 * RING_T, (RING_BWD_CLIPS,), generator=gen)
        lengths[0], lengths[1] = 33, 2 * RING_T - 1
        lengths = lengths.to(device)
        out_all, lse_all = flash.blockwise_attention(q_all, k_all, v_all, kv_lengths=lengths, causal=True)
        dout_all = torch.randn((RING_BWD_CLIPS, 2 * RING_T, HEADS, H // HEADS), generator=gen).to(device, dtype)
        for offsets in RING_OFFSETS:
            row0, col0 = offsets
            rows, cols = slice(row0, row0 + RING_T), slice(col0, col0 + RING_T)
            q, k, v = q_all[:, rows], k_all[:, cols], v_all[:, cols]
            out, lse = out_all[:, rows], lse_all[:, :, rows].contiguous()
            t = torch.arange(RING_T, device=device)[None, :] + row0
            live = t < lengths[:, None]
            no_key = live & ((col0 >= lengths[:, None]) | (col0 > t))
            dout = dout_all[:, rows].clone()
            dout[~live] = 1e30  # the backward must not read it
            dsum = flash._dsum(dout, out, lengths, row0)
            for rate in (0.0, DROPOUT):
                kw = dict(kv_lengths=lengths, causal=True, offsets=offsets, dropout_rate=rate,
                          dropout_seed=0x5EED5EED if rate else None)
                run = lambda: flash.blockwise_attention_bwd(q, k, v, dout, lse, dsum, **kw)
                plain = lambda: flash.attention_bwd_plain(q, k, v, dout, lse, dsum, **kw)
                with nan_filled_outputs():
                    got = run()
                again, want = run(), plain()
                torch.cuda.synchronize()
                label = f"blockwise_attention_bwd offsets={offsets} {dtype} B={RING_BWD_CLIPS} rate={rate}"
                err, rel = _check_grads(label, got, want, ~live | no_key, dtype)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"{label}: two launches differ")
                row = {"name": "blockwise_attention_bwd_offsets", "offsets": list(offsets),
                       "dtype": str(dtype).split(".")[1], "clips": RING_BWD_CLIPS, "T": RING_T,
                       "rate": rate, "max_abs_err": err, "rel_err": rel, "rel_tol": BWD_REL[dtype],
                       "live_rows": int(live.sum()), "no_key_rows": int(no_key.sum())}
                if dtype == torch.bfloat16:
                    mask = flash._offsets_bias(lengths, RING_T, RING_T, True, offsets) == 0
                    library = library_attention_bwd(q, k, v, mask, dout.masked_fill(~live[:, :, None, None], 0),
                                                    rate)
                    row["plain_ms"] = cuda_ms(plain, 3)
                    median_fields(row, ms=run, library_ms=library)
                    row["bound_ms"], row["bound_by"] = offsets_bwd_bound(q, lengths, True, offsets, dtype)
                    del library, mask
                log("kernel_check " + json.dumps(row) + "; NaN-filled outputs all written, dq of dead "
                    "and no-key rows zero, two launches bit-identical")
                if dtype == torch.bfloat16 and offsets == (RING_T, 0) and rate == DROPOUT:
                    table["blockwise_attention_bwd_offsets"] = row
                del got, again, want
        del q_all, k_all, v_all, out_all, lse_all, dout_all
        torch.cuda.empty_cache()
    return table


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
        # The throughput batch (bench_stlt_eval's B = 1024): the batch above
        # 16 times over, its forward timed and profiled, kernels and plain.
        big = {k: torch.cat([v] * (THROUGHPUT_BATCH // BATCH)) for k, v in batch.items()}
        with torch.inference_mode():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            model(big)
            torch.cuda.synchronize()
            log(f"peak memory of the {THROUGHPUT_BATCH}-clip forward (the model and batch "
                f"included): {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
            big_ms = cuda_ms(lambda: model(big), 5)
            _device_profile("forward", lambda: model(big), FORWARD_GROUPS,
                            name=f"forward 17 frames, B = {THROUGHPUT_BATCH}")
            with plain_eval_path():
                big_plain_ms = cuda_ms(lambda: model(big), 2)
        log(f"forward of {THROUGHPUT_BATCH} clips (that batch {THROUGHPUT_BATCH // BATCH} times): "
            f"kernels {big_ms:.3f} ms ({THROUGHPUT_BATCH / big_ms * 1e3:.0f} clips/s), plain "
            f"{big_plain_ms:.3f} ms")
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


def _one_step(model, batch, criterion, grad_accum: int = 1):
    """Loss and gradients of one train step from the model's weights
    (``training/loop.loss_and_grads``: ``grad_accum`` microbatches)."""
    from stlt_tpu_torch.training.loop import loss_and_grads, step_generator

    loss = loss_and_grads(model, criterion, batch, step_generator(SEED, 0), grad_accum)
    return loss, {n: p.grad.detach().clone() for n, p in model.named_parameters()
                  if p.grad is not None}


# Phase 8's f32 step, kernels against plain: the appearance encoder's FFN
# takes ReLU(z) of its pre-activations z, and the two runs' z differ by the
# attention kernels' sum order upstream, by at most 3.7e-6 to 5.5e-6 a layer
# in f32 (H100, 1.6M elements a layer; PERF.md §6), so an element of z that
# close to 0 can take the other gate in each run (one or two a step in the
# runs measured), which moves a whole element of dh1 and dW1 by far more
# than FUSION_STEP_F32 allows. The check holds the plain run to the kernel run's gates where they
# flipped (pin_flipped_gates) and fails if a flipped element lies farther
# than GATE_PIN_ABS (about four times the largest difference measured) from
# 0 in either run, or if more than GATE_PIN_MAX flip in one step: what a
# kernel fault would look like.
GATE_PIN_ABS = 2e-5
GATE_PIN_MAX = 16


def pin_flipped_gates(z, z_ref):
    """(z with each ReLU gate that differs from ``z_ref``'s set as
    ``z_ref``'s, the number of such flips, the largest |z| or |z_ref| among
    them). A flipped element takes ``z_ref``'s value; the gradient flows to
    ``z`` through every element as before."""
    flip = (z > 0) != (z_ref > 0)
    count = int(flip.sum())
    largest = float(torch.maximum(z.detach().abs(), z_ref.abs())[flip].max()) if count else 0.0
    return torch.where(flip, z_ref + (z - z.detach()), z), count, largest


def check_gate_flips(label: str, flips: dict) -> None:
    """Raise if a flipped gate of ``flips`` ({layer: (count, largest |z|,
    ...)}) lies farther than GATE_PIN_ABS from 0, or if more than
    GATE_PIN_MAX flipped in all."""
    total = sum(f[0] for f in flips.values())
    largest = max((f[1] for f in flips.values()), default=0.0)
    if total > GATE_PIN_MAX or largest > GATE_PIN_ABS:
        raise AssertionError(f"{label}: {total} ReLU gates flipped (at most {GATE_PIN_MAX}), the largest "
                             f"|z| among them {largest:.3e} (at most {GATE_PIN_ABS})")


class appearance_gates:
    """Within the block, each appearance encoder layer's ReLU (the plain
    train-tail chain, ``layers.activation_fn``) records its pre-activation
    z into ``self.z`` {layer: z}; given ``reference`` (another run's
    ``z``), it first pins the flipped gates to the reference's
    (``pin_flipped_gates``) and records {layer: (flips, the largest |z|
    among them, max |z - z_ref|, elements)} into ``self.flips``."""

    def __init__(self, model, reference=None):
        self.layers = next(m for n, m in model.named_modules()
                           if n.endswith("appearance_branch.transformer")).layers
        self.reference = reference
        self.z, self.flips = {}, {}

    def __enter__(self):
        from stlt_tpu_torch.models import layers

        self.module, self.saved = layers, layers.activation_fn
        current = []  # the layer whose forward runs

        def enter(i):
            return lambda module, args: current.append(i)  # (None: the arguments stay)

        def leave(module, args, out):
            current.pop()  # (returns None: the output stays)

        self.hooks = [h for i, layer in enumerate(self.layers) for h in (
            layer.register_forward_pre_hook(enter(i)), layer.register_forward_hook(leave))]

        def activation_fn(name, dtype):
            fn = self.saved(name, dtype)
            if not current or name != "relu":
                return fn
            i = current[-1]

            def gate(z):
                if self.reference is not None:
                    ref = self.reference[i]
                    diff = float((z.detach() - ref).abs().max())
                    z, count, largest = pin_flipped_gates(z, ref)
                    self.flips[i] = (count, largest, diff, z.numel())
                self.z[i] = z.detach().clone()
                return fn(z)

            return gate

        layers.activation_fn = activation_fn
        return self

    def __exit__(self, *exc):
        self.module.activation_fn = self.saved
        for hook in self.hooks:
            hook.remove()
        return False


def _step_kernels_vs_plain(label, model, batch, criterion, limits=None, pin_gates=False,
                           grad_accum: int = 1) -> None:
    """One step from the same weights, batch and seeds through the kernels
    and through the plain path on the card: loss within STEP_LOSS_ATOL, each
    gradient within STEP_TENSOR_REL and all of them joined within
    STEP_GRAD_REL in relative norm. ``limits`` (loss atol, joined, each, each
    in the appearance branch) replaces them (phase 8). ``pin_gates`` (phase
    8 in f32): the plain run takes the kernel run's appearance-encoder ReLU
    gates where they flipped (``appearance_gates``; the flips are logged per
    layer and checked by ``check_gate_flips``), and a plain run without the
    pins is compared too, logged and not checked. ``grad_accum``:
    microbatches of each step (phase 11)."""
    # The same cuDNN algorithms in both passes (the R3D convolutions), so the
    # two differ by the kernels alone.
    saved = torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = False, True
    try:
        if not pin_gates:
            loss_k, grads_k = _one_step(model, batch, criterion, grad_accum)
            with plain_kernels():
                loss_p, grads_p = _one_step(model, batch, criterion, grad_accum)
        else:
            with appearance_gates(model) as kernel_gates:
                loss_k, grads_k = _one_step(model, batch, criterion)
            with plain_kernels():
                unpinned = _one_step(model, batch, criterion)
                with appearance_gates(model, kernel_gates.z) as plain_gates:
                    loss_p, grads_p = _one_step(model, batch, criterion)
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = saved
    if pin_gates:
        for i, (count, largest, diff, numel) in sorted(plain_gates.flips.items()):
            log(f"{label}: appearance encoder layer {i}: {count} of {numel} ReLU gates flipped, largest "
                f"|z| among them {largest:.3e} (pinned within {GATE_PIN_ABS}); max |z kernels - z plain| "
                f"{diff:.3e}")
        try:
            _compare_steps(label, "kernels vs plain, gates not pinned (not checked)", (loss_k, grads_k),
                           unpinned, limits)
        except AssertionError as e:
            log(f"{label}: without the pins the check would fail: {e}")
        check_gate_flips(label, plain_gates.flips)
    _compare_steps(label, "kernels vs plain" + (", flipped gates pinned" if pin_gates else ""),
                   (loss_k, grads_k), (loss_p, grads_p), limits)


def _compare_steps(label, what, got, want, limits=None) -> None:
    """One step's (loss, gradients) against another's: the loss within
    STEP_LOSS_ATOL, each gradient within STEP_TENSOR_REL and all of them
    joined within STEP_GRAD_REL in relative norm; ``limits`` (loss atol,
    joined, each, each in the appearance branch) replaces them."""
    loss_atol, joined, each, each_appearance = limits or (
        STEP_LOSS_ATOL, STEP_GRAD_REL, STEP_TENSOR_REL, STEP_TENSOR_REL)
    (loss_k, grads_k), (loss_p, grads_p) = got, want
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
            log(f"{label}, {what}, {group}: worst tensors "
                + ", ".join(f"{n} {per_tensor[n]:.3e}" for n in worst)
                + f" (tolerance {limit[worst[0]]} each)")
    log(f"{label}, {what}: loss {float(loss_k):.6f} vs {float(loss_p):.6f} "
        f"(atol {loss_atol}); gradient relative norm error {rel:.3e} "
        f"(tolerance {joined}) over {len(grads_p)} tensors")
    if set(grads_k) != set(grads_p) or abs(float(loss_k) - float(loss_p)) > loss_atol:
        raise AssertionError(f"{label}: {what} disagree (loss)")
    if not torch.isfinite(flat_k).all() or rel > joined or over:
        raise AssertionError(f"{label}: {what} disagree "
                             f"(grads; joined {rel:.3e}, tensors over their limit: {over})")


def _train_step(model, criterion, grad_accum: int = 1):
    from stlt_tpu_torch.training.loop import make_train_step
    from stlt_tpu_torch.training.optimizer import make_optimizer

    optimizer, scheduler = make_optimizer(model, learning_rate=1e-5, weight_decay=1e-3,
                                          num_warmup_steps=1, num_training_steps=100)
    return make_train_step(model, optimizer, scheduler, criterion, 5.0, grad_accum=grad_accum)


def _step_ms(model, batch, criterion, steps: int = 5, grad_accum: int = 1) -> float:
    """Mean wall time of a whole train step (forward, backward, clip, AdamW;
    ``grad_accum`` microbatches), synchronised, after two warmup steps."""
    from stlt_tpu_torch.training.loop import step_generator

    step = _train_step(model, criterion, grad_accum)
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
# The bf16 layer tail's kernels (csrc/fused_layer_tail.cu); in a train step
# they are the train tail's forward, in a forward the eval tail.
TAIL_FORWARD_KERNELS = ("tail_live_rows_kernel", "tail_ln1_kernel", "tail_gemm_kernel", "tail_ln2_kernel")
TRAIN_TAIL_GROUP = ("train tail kernels", ("fused_tail_train", "tail_bwd_", "reduce_parts_kernel",
                                           *TAIL_FORWARD_KERNELS))
# Rows 1 and 3 (csrc/fused_proj_attention.cu: the f32 kernel, the bf16
# split's scan, gather, GEMMs and attention) and row 5
# (csrc/fused_cross_attention.cu).
PROJ_KERNELS = ("fused_proj_attn", "proj_live_rows", "proj_gather", "proj_gemm", "proj_attn_kernel")
CROSS_KERNELS = ("cross_attn", "kv_proj", "cross_gemm", "cross_short_attn")
# Row 4 (csrc/fused_proj_attention_bwd.cu): the f32 kernels and the bf16
# split's scan, gather, GEMMs, attention backward, dWo GEMM and ordered sums,
# every name from "proj_bwd_" on (by name in CUDA_KERNELS).
PROJ_BWD_KERNELS = ("fused_proj_bwd", "proj_bwd_")
PROJ_BWD_GROUPS = (
    ("pack: scan, gather", ("proj_bwd_scan", "proj_bwd_gather")),
    ("GEMMs: qkv, do", ("proj_bwd_gemm",)),
    ("attention backward", ("proj_bwd_attn",)),
    ("GEMM: dWo, dbo", ("proj_bwd_weight_gemm",)),
    ("ordered sums", ("proj_bwd_finalize",)),
    ("wrapper GEMMs: dx, dWqkv, dbqkv", ("gemm", "nvjet", "cutlass", "xmma")),
)
# Rows 6 and 8's forward by mode, from the device kernel's template
# arguments (lengths mode: kLengths true); the bias modes are row 6 below
# 513 tokens and row 8's dense-bias mode from 513 on.
ATTN_FWD_GROUPS = (
    ("attention forward, lengths and ring modes (row 8)",
     tuple(f"attention_fwd_kernel<{d}, true" for d in (64, 128))
     + tuple(f"attention_kernel<{e}, {d}, true" for e, d in (
         ("float", 32), ("float", 64), ("float", 128), ("__nv_bfloat16", 32)))),
    ("attention forward, bias modes (row 6; row 8 dense)", ("attention_fwd_kernel<", "attention_kernel<")),
)
KERNEL_GROUPS = (
    TRAIN_TAIL_GROUP,
    ("attention forward kernels (row 3)", PROJ_KERNELS),
    ("attention backward kernels", PROJ_BWD_KERNELS),
    *ATTN_FWD_GROUPS,
    ("long-clip attention backward kernels", ("attention_dq_kernel", "attention_dkdv_kernel")),
    ("cuBLAS GEMMs", ("gemm", "nvjet", "cutlass", "xmma")),
)
FORWARD_GROUPS = (
    ("layer tail kernel", ("fused_tail", *TAIL_FORWARD_KERNELS)),
    TRAIN_TAIL_GROUP,
    ("fused projection+attention kernels (rows 1/3)", PROJ_KERNELS),
    ("fused cross-attention kernels (row 5)", CROSS_KERNELS),
    *ATTN_FWD_GROUPS,
    ("cuDNN convolutions", ("fprop", "cudnn", "convolve", "implicit_gemm", "conv2d", "conv3d")),
    ("cuBLAS GEMMs", ("gemm", "nvjet", "cutlass", "xmma")),
)
# Rows 13 and 14's device kernels in bf16 (csrc/fused_tail_train_bwd.cu).
TAIL_BWD_GROUPS = (
    ("scan", ("tail_live_rows_kernel",)), ("prologue", ("tail_bwd_prologue",)),
    ("GEMM A: z1, dh1d", ("tail_bwd_hidden",)), ("GEMM B: du", ("tail_bwd_du",)),
    ("LN1 backward", ("tail_bwd_ln1",)), ("GEMM C: dW1, dW2", ("tail_bwd_weight_gemm",)),
    ("ordered sums", ("reduce_parts",)),
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


def tail_gate_ab(label, model, batch, criterion, ms: float, steps: int = 5) -> dict:
    """B1's step-level A/B (ROADMAP.md): the step ``ms`` took with the fused
    train tail's gate at ``ftt.TAIL_TRAIN_MIN_FRAMES`` (256), timed again
    with the gate at 0 for this timing only, so that every train tail of the
    model runs the fused op. The train-tail kernels' launches in the gated-
    off run (warmup included) show that they ran; logged as one JSON line
    and returned."""
    from stlt_tpu_torch.ops import fused_tail_train as ftt

    gate = ftt.TAIL_TRAIN_MIN_FRAMES
    ftt.reset_launches()
    ftt.TAIL_TRAIN_MIN_FRAMES = 0
    try:
        gate0_ms = _step_ms(model, batch, criterion, steps)
    finally:
        ftt.TAIL_TRAIN_MIN_FRAMES = gate
    counts = dict(ftt.LAUNCHES)
    ftt.reset_launches()
    ab = {"label": label, "gate_frames": gate, "gate_ms": ms, "gate_0_ms": gate0_ms,
          "gate_0_over_gate": gate0_ms / ms, "gate_0_launches": counts}
    log("tail_gate_ab " + json.dumps(ab))
    runs = 2 + steps  # _step_ms's warmup and timed steps
    if len(set(counts.values())) != 1 or counts[TAIL_KERNELS[0]] == 0 or counts[TAIL_KERNELS[0]] % runs:
        raise AssertionError(f"{label}: with the gate at 0 the train-tail kernels launched {counts}, "
                             f"not the same positive multiple of {runs} steps each")
    return ab


def train_argv(split, paths, save_model_path):
    """Phase 4's ``train`` argv: a full-width bf16 STLT (dropout 0.1,
    learning rate 1e-3), batch 64, TRAIN_EPOCHS epochs."""
    return [
        "--dataset_name", "something", "--dataset_type", "layout", "--model_name", "stlt",
        "--train_dataset_path", split["train"], "--val_dataset_path", split["val"],
        "--labels_path", paths["labels"], "--videoid2size_path", paths["videoid2size"],
        "--hidden_size", str(H), "--num_attention_heads", str(HEADS),
        "--num_spatial_layers", str(SPATIAL_LAYERS),
        "--num_temporal_layers", str(TEMPORAL_LAYERS), "--hidden_dropout_prob", str(DROPOUT),
        "--batch_size", str(BATCH), "--epochs", str(TRAIN_EPOCHS), "--warmup_epochs", "1",
        "--learning_rate", "1e-3",
        "--compute_dtype", "bfloat16", "--use_pallas", "--seed", str(SEED),
        "--save_model_path", save_model_path,
    ]


def train_model_kw(split, paths, frames: int = 16):
    """(the train data config, the model config's keywords) of ``train_argv``'s
    model at ``frames`` layout frames."""
    from stlt_tpu_torch.configs import DataConfig, position_table_rows

    data_cfg = DataConfig(dataset_name="something", dataset_path=split["train"],
                          labels_path=paths["labels"], videoid2size_path=paths["videoid2size"],
                          layout_num_frames=frames, train=True)
    model_kw = dict(
        num_classes=NUM_CLASSES, unique_categories=4, hidden_size=H,
        num_attention_heads=HEADS, num_spatial_layers=SPATIAL_LAYERS,
        num_temporal_layers=TEMPORAL_LAYERS, compute_dtype="bfloat16",
        hidden_dropout_prob=DROPOUT, layout_num_frames=position_table_rows(data_cfg),
    )
    return data_cfg, model_kw


def _train_batch(data_cfg, clips, device):
    """The first train batch of ``clips`` clips of ``data_cfg``'s set, on the card."""
    from stlt_tpu_torch.data import collaters_factory, datasets_factory
    from stlt_tpu_torch.data.loader import Loader, to_device

    loader = Loader(datasets_factory["layout"](data_cfg), clips,
                    collaters_factory["layout"](data_cfg), prefetch=0)
    return next(iter(to_device(loader, device)))


def run_train_path(device):
    from stlt_tpu_torch import train as port_train
    from stlt_tpu_torch.configs import make_model_config
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
        argv = train_argv(split, paths, best)
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

        data_cfg, model_kw = train_model_kw(split, paths)
        model = models_factory["stlt"](make_model_config("stlt", **model_kw))
        model.load_state_dict(read_state_dict(best), strict=True)
        model = model.to(device).train()
        log(f"train: best checkpoint {os.path.getsize(best)} bytes loads with strict=True")

        # One step from the same weights, batch and seeds: kernels against plain.
        batch = _train_batch(data_cfg, BATCH, device)
        criterion = make_criterion("something")
        _step_kernels_vs_plain("train step", model, batch, criterion)

        step_ms = {}
        for clips in (BATCH, TRAIN_BATCH):
            big = {k: v.repeat(clips // BATCH, *([1] * (v.dim() - 1))) for k, v in batch.items()}
            torch.cuda.reset_peak_memory_stats()
            ms = _step_ms(model, big, criterion)
            peak = torch.cuda.max_memory_allocated()
            with plain_kernels():
                plain_ms = _step_ms(model, big, criterion)
            step_ms[clips] = {"ms": ms, "plain_ms": plain_ms, "peak_bytes": peak}
            log(f"train step of {clips} clips (full width, bf16, dropout {DROPOUT}): kernels "
                f"{ms:.3f} ms, plain {plain_ms:.3f} ms; peak memory kernels {peak / 2**30:.3f} GiB "
                f"(the model, its optimizer state and the batch included)")
            if clips == TRAIN_BATCH:
                step_ms[clips]["tail_gate_ab"] = tail_gate_ab(
                    f"train step of {clips} clips, 17 frames", model, big, criterion, ms)
            _profile_step(model, big, criterion, clips)
            del big
            torch.cuda.empty_cache()
        return launches, step_ms


# --- phase 11: the train CLI's levers ------------------------------------------

# --grad_accum_steps, --remat, --resume_dir and --profile_dir on phase 4's
# run (17 frames, B = 64, two epochs of four steps); (d) and (e) at 256
# frames on LONG_TRAIN[256]'s clips.
LEVER_ACCUM = 2
LEVER_ARGV = ["--grad_accum_steps", str(LEVER_ACCUM), "--remat"]
LEVER_PROFILE_WINDOW = (1, 3)
LEVER_LONG_FRAMES = 256
LEVER_LONG_CLIPS, LEVER_LONG_STEP_CLIPS = LONG_TRAIN[256][0], 8  # (e)'s batch, (d)'s


class Interrupted(Exception):
    """The planned stop of phase 11's interrupted run."""


class stop_after_save:
    """Within the block (with ``stop``), the step-checkpoint writer
    (``training/checkpoint.save_train_state``) raises Interrupted once,
    after its first checkpoint is on disk: a run cut after epoch 1's
    validation. The block swallows that one exception."""

    def __init__(self, stop: bool):
        self.stop = stop

    def __enter__(self):
        from stlt_tpu_torch.training import checkpoint as ckpt

        self.module, self.save = ckpt, ckpt.save_train_state
        if self.stop:
            def save_then_stop(*args, **kw):
                ckpt.save_train_state = self.save
                raise Interrupted(self.save(*args, **kw))

            ckpt.save_train_state = save_then_stop
        return self

    def __exit__(self, kind, value, tb):
        self.module.save_train_state = self.save
        return kind is Interrupted


class saved_weights:
    """Within the block, each file the train CLI writes through
    ``save_checkpoint`` (the best model, its backbone) also leaves a CPU
    copy of the weights it was given in ``self.states[path]``: what the
    file must hold."""

    def __enter__(self):
        from stlt_tpu_torch import train as port_train

        self.module, self.save, self.states = port_train, port_train.save_checkpoint, {}

        def save_and_keep(path, module, **kw):
            self.states[path] = {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}
            return self.save(path, module, **kw)

        port_train.save_checkpoint = save_and_keep
        return self

    def __exit__(self, *exc):
        self.module.save_checkpoint = self.save
        return False


def _holds_the_weights(label, loaded, want) -> None:
    """``loaded`` (a module read from a written file) holds ``want`` (the
    weights the file was written from) bit for bit, but for the keys
    without a JAX leaf (``jax_free_keys``: the file has none)."""
    from stlt_tpu_torch.utils.convert import jax_free_keys

    state, free = loaded.state_dict(), jax_free_keys(loaded)
    keys = sorted(set(want) - free)
    differ = [k for k in keys if not torch.equal(state[k].cpu(), want[k])]
    log(f"{label}: {len(keys)} tensors against the weights it was written from "
        f"({len(free)} without a JAX leaf left out); differ: {differ[:6]}")
    if differ or set(state) != set(want):
        raise AssertionError(f"{label}: not the weights it was written from: {differ[:6]} differ, "
                             f"keys {sorted(set(state) ^ set(want))[:6]} on one side only")


def set_remat(model, on: bool) -> None:
    """Turn ``--remat`` on or off in every encoder of ``model``."""
    from stlt_tpu_torch.models.layers import TransformerEncoder

    for module in model.modules():
        if isinstance(module, TransformerEncoder):
            module.remat = on


def lever_launches(counts: dict, steps: int, val_batches: int, layers: int,
                   train: dict, val: dict) -> dict:
    """``counts``' keys with the launches expected of ``steps`` train steps
    (``train``: launches a layer and step) and ``val_batches`` validation
    batches (``val``: a layer and batch), the rest 0."""
    want = dict.fromkeys(counts, 0)
    for name, per in train.items():
        want[name] = want.get(name, 0) + per * layers * steps
    for name, per in val.items():
        want[name] = want.get(name, 0) + per * layers * val_batches
    return want


def _hold_to_bits(label, pairs) -> None:
    """``pairs`` {name: (got, want)} equal bit for bit; raise naming the
    worst of those that differ otherwise."""
    differ = {n: _rel(a, b) if a.device == b.device else math.inf for n, (a, b) in pairs.items()
              if a.device != b.device or not torch.equal(a, b)}
    log(f"{label}: {len(pairs)} tensors bit for bit: {not differ}")
    if differ:
        worst = sorted(differ.items(), key=lambda kv: -kv[1])[:6]
        raise AssertionError(f"{label}: not bit for bit: {len(differ)} tensors differ, the worst "
                             f"(relative norm) {worst}")


def check_embedding_backward(label, ids, rows: int, repeats: int = 8) -> None:
    """The gradient of a ``rows``-row table at ``ids`` (a train batch's
    categories or frame types) under a seeded gradient, in f32 and in bf16,
    ``repeats`` times through ``models/stlt.embed`` (the model's one-hot
    product) and through the CUDA ``embedding_dense_backward`` that
    ``nn.functional.embedding`` takes: embed's calls must repeat the first's
    bits (raises otherwise); how many of the library's do not, and in how
    many entries at most, is logged, with each path's largest error against
    an f64 sum relative to the sum's largest entry."""
    from stlt_tpu_torch.models.stlt import embed

    gen = torch.Generator(device=ids.device).manual_seed(SEED)
    g64 = torch.randn((*ids.shape, H), generator=gen, device=ids.device, dtype=torch.float64)
    for dtype in (torch.float32, torch.bfloat16):
        g = g64.to(dtype)
        table = torch.zeros(rows, H, dtype=dtype, device=ids.device, requires_grad=True)
        truth = torch.zeros(rows, H, dtype=torch.float64, device=ids.device).index_add_(
            0, ids.reshape(-1), g.reshape(-1, H).double())
        paths = {"embed": lambda: torch.autograd.grad(embed(ids, table), table, g)[0],
                 "embedding_dense_backward": lambda: torch.ops.aten.embedding_dense_backward(
                     g, ids, rows, -1, False)}
        other = {}
        for name, fn in paths.items():
            outs = [fn() for _ in range(repeats)]
            other[name] = sum(not torch.equal(o, outs[0]) for o in outs[1:])
            entries = max(int((o != outs[0]).sum()) for o in outs)
            err = float((outs[0].double() - truth).abs().max() / truth.abs().max())
            log(f"{label} ({ids.numel()} ids, {rows} rows, {str(dtype)[6:]}): {name}: "
                f"{other[name]} of {repeats - 1} repeats differ from the first, in up to "
                f"{entries} of {rows * H} entries; error against f64 {err:.3e} of the largest sum")
        if other["embed"]:
            raise AssertionError(f"{label}: models/stlt.embed's {dtype} table gradient did not "
                                 f"repeat its bits")


def _bit_for_bit(label, got, want) -> None:
    """Two steps' (loss, gradients) bit for bit."""
    (loss_a, grads_a), (loss_b, grads_b) = got, want
    log(f"{label}: loss {float(loss_a):.6f} vs {float(loss_b):.6f}")
    if not torch.equal(loss_a, loss_b) or set(grads_a) != set(grads_b):
        raise AssertionError(f"{label}: loss {float(loss_a)!r} vs {float(loss_b)!r}, or other "
                             f"gradients, not bit for bit")
    _hold_to_bits(label, {n: (grads_a[n], grads_b[n]) for n in grads_b})


def _states_bit_for_bit(label, got, want) -> None:
    """Two runs' final weights, AdamW states (``TrainResult``) and learning
    rates bit for bit."""
    model_a, model_b = got.model.state_dict(), want.model.state_dict()
    opt_a, opt_b = got.optimizer.state_dict(), want.optimizer.state_dict()
    names = {id(p): n for n, p in want.model.named_parameters()}
    order = [names[id(p)] for group in want.optimizer.param_groups for p in group["params"]]
    lrs = ([g["lr"] for g in opt_a["param_groups"]], [g["lr"] for g in opt_b["param_groups"]])
    log(f"{label}: learning rates {lrs[0]} vs {lrs[1]}")
    if lrs[0] != lrs[1] or set(opt_a["state"]) != set(opt_b["state"]):
        raise AssertionError(f"{label}: learning rates {lrs} or AdamW's states differ")
    pairs = {k: (model_a[k], model_b[k]) for k in model_b}
    pairs.update({f"adamw {order[i]} {slot}": (opt_a["state"][i][slot], value)
                  for i, state in opt_b["state"].items() for slot, value in state.items()})
    _hold_to_bits(label, pairs)


def _trace_summary(directory: str) -> dict:
    """The one Chrome trace under ``directory``: its train_step ranges (CPU
    annotations) and its count of device events."""
    files = os.listdir(directory)
    if len(files) != 1:
        raise AssertionError(f"--profile_dir {directory} holds {files}, not one trace")
    with open(os.path.join(directory, files[0])) as f:
        events = json.load(f)["traceEvents"]
    steps = [e for e in events if e.get("name") == "train_step" and e.get("cat") == "user_annotation"]
    device = sum(e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") for e in events)
    return {"file": files[0], "events": len(events), "train_steps": len(steps),
            "device_events": device}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def _lever_timings(model, batch, criterion, shape: str, ways, card: str) -> list:
    """For each (name, remat, k) of ``ways``: the mean train step ms
    (``_step_ms``, three steps after two of warmup) and the peak memory
    (``torch.cuda.max_memory_allocated``: the model, its AdamW state and the
    batch included), each logged beside the card's name and power limit."""
    rows = []
    for way, remat, k in ways:
        set_remat(model, remat)
        model.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms = _step_ms(model, batch, criterion, steps=3, grad_accum=k)
        peak = torch.cuda.max_memory_allocated()
        rows.append({"shape": shape, "levers": way, "ms": ms, "peak_bytes": peak})
        log(f"lever_step {json.dumps(rows[-1])} ({card}; peak {peak / 2 ** 30:.3f} GiB)")
    set_remat(model, False)
    model.zero_grad(set_to_none=True)
    return rows


def run_train_levers_path(device):
    """Phase 11: the train CLI's levers at full width (see the module
    docstring). Returns the train kernels' launches of the uninterrupted
    CLI run and the step times and peak memory of (e)."""
    from stlt_tpu_torch import predict as port_predict
    from stlt_tpu_torch import train as port_train
    from stlt_tpu_torch.configs import make_model_config
    from stlt_tpu_torch.models import models_factory, stlt
    from stlt_tpu_torch.training import checkpoint as ckpt
    from stlt_tpu_torch.training.criterion import make_criterion
    from stlt_tpu_torch.utils.convert import read_state_dict, save_checkpoint

    layers = SPATIAL_LAYERS + TEMPORAL_LAYERS
    steps_per_epoch = TRAIN_CLIPS // BATCH
    val_batches = -(-VAL_CLIPS // BATCH)
    # Per layer and step: each microbatch's forward and its recompute; one
    # backward a microbatch. Per layer and validation batch: the eval kernels.
    train_per = {"fused_proj_attention_train": 2 * LEVER_ACCUM,
                 "fused_proj_attention_train_bwd": LEVER_ACCUM}
    val_per = dict.fromkeys(EVAL_KERNELS, 1)
    criterion = make_criterion("something")
    card = card_line()
    out = {}
    with tempfile.TemporaryDirectory(prefix="stlt_chip_smoke_levers_") as root:
        paths = write_something_dataset(root, TRAIN_CLIPS + VAL_CLIPS, SEED + 2, num_used=TRAIN_LABELS)
        split = _split_dataset(paths, root)

        def argv(tag):
            return train_argv(split, paths, os.path.join(root, f"{tag}_best.msgpack")) + LEVER_ARGV + [
                "--resume_dir", os.path.join(root, f"{tag}_steps"),
                "--save_backbone_path", os.path.join(root, f"{tag}_backbone.msgpack"),
                "--profile_dir", os.path.join(root, f"{tag}_trace"),
                "--profile_window", ",".join(map(str, LEVER_PROFILE_WINDOW)),
            ]

        # (a) uninterrupted; cut after epoch 1's step checkpoint; resumed.
        runs = {}
        for label, tag, stop, steps, epochs in (
                ("uninterrupted", "whole", False, 2 * steps_per_epoch, [1, 2]),
                ("interrupted", "cut", True, steps_per_epoch, [1]),
                ("resumed", "cut", False, steps_per_epoch, [2])):
            reset_all_launches()
            t0 = time.perf_counter()
            result = None
            with stop_after_save(stop), saved_weights() as written:
                result = port_train.main(argv(tag))
            torch.cuda.synchronize()
            counts = all_launches()
            log(f"train levers, {label}: {time.perf_counter() - t0:.3f} s; launches {counts}")
            want = lever_launches(counts, steps, len(epochs) * val_batches, layers, train_per, val_per)
            if counts != want:
                raise AssertionError(f"train levers, {label}: launches {counts}, expected {want} "
                                     f"({2 * LEVER_ACCUM} forwards of the train op a layer and step: "
                                     f"{LEVER_ACCUM} microbatches, each forward and recompute)")
            if stop:
                if result is not None or ckpt.steps(os.path.join(root, "cut_steps")) != [steps]:
                    raise AssertionError(f"train levers: the interrupted run was not cut after its "
                                         f"epoch 1 checkpoint ({ckpt.steps(os.path.join(root, 'cut_steps'))})")
                continue
            for record in result.epochs:
                log("train_epoch " + json.dumps(record))
            if ([r["epoch"] for r in result.epochs] != epochs or result.step != 2 * steps_per_epoch
                    or not all(math.isfinite(r["train_loss"]) for r in result.epochs)):
                raise AssertionError(f"train levers, {label}: bad epoch records {result.epochs}")
            runs[label] = result
            if label == "uninterrupted":
                out["launches"] = {name: counts[name] for name in TRAIN_KERNELS}
                trained = written.states  # what whole_best.msgpack and its backbone must hold
        whole, resumed = runs["uninterrupted"], runs["resumed"]
        if resumed.epochs[0]["train_loss"] != whole.epochs[1]["train_loss"]:
            raise AssertionError(f"train levers: epoch 2's loss resumed {resumed.epochs[0]['train_loss']!r}, "
                                 f"uninterrupted {whole.epochs[1]['train_loss']!r}")
        _states_bit_for_bit("train levers, resumed vs uninterrupted", resumed, whole)
        trace = _trace_summary(os.path.join(root, "whole_trace"))
        log(f"train levers: profiler trace {json.dumps(trace)} (device events logged, not checked)")
        if trace["train_steps"] != LEVER_PROFILE_WINDOW[1] - LEVER_PROFILE_WINDOW[0]:
            raise AssertionError(f"train levers: the trace holds {trace['train_steps']} train_step "
                                 f"ranges, not steps {LEVER_PROFILE_WINDOW[0]}..{LEVER_PROFILE_WINDOW[1] - 1}")
        del runs, whole, resumed, result  # their models and AdamW states

        # (b) the .msgpack checkpoints: strict, the trained weights bit for bit, the
        # logits those of the same weights through a .pt, served.
        data_cfg, model_kw = train_model_kw(split, paths)
        best = os.path.join(root, "whole_best.msgpack")
        backbone_file = os.path.join(root, "whole_backbone.msgpack")
        if sorted(trained) != sorted([best, backbone_file]):
            raise AssertionError(f"train levers: the uninterrupted run wrote {sorted(trained)}")
        model = models_factory["stlt"](make_model_config("stlt", **model_kw))
        model.load_state_dict(read_state_dict(best, model), strict=True)
        _holds_the_weights("train levers: best.msgpack", model, trained[best])
        backbone = models_factory["stlt"](make_model_config("stlt", **model_kw)).backbone
        backbone.load_state_dict(read_state_dict(backbone_file, backbone), strict=True)
        _holds_the_weights("train levers: backbone.msgpack", backbone, trained[backbone_file])
        del backbone
        twin = models_factory["stlt"](make_model_config("stlt", **model_kw))
        twin.load_state_dict(trained[best], strict=True)
        pt = os.path.join(root, "whole_best.pt")
        save_checkpoint(pt, twin)
        twin.load_state_dict(read_state_dict(pt), strict=True)
        del trained
        model, twin = model.to(device).eval(), twin.to(device).eval()
        batch = _train_batch(data_cfg, BATCH, device)
        inputs = {k: v for k, v in batch.items() if k not in ("labels", "valid")}
        with torch.inference_mode():
            logits, logits_pt = model(inputs)["stlt"], twin(inputs)["stlt"]
        log(f"train levers: best.msgpack ({os.path.getsize(best)} bytes) loads with strict=True; "
            f"its logits equal those of the trained weights through a .pt bit for bit: "
            f"{torch.equal(logits, logits_pt)}")
        if not torch.equal(logits, logits_pt) or not torch.isfinite(logits).all():
            raise AssertionError("train levers: the .msgpack model's logits differ from the .pt's")
        del twin
        predictions = os.path.join(root, "predictions.jsonl")
        rows = port_predict.main([
            "--dataset_name", "something", "--dataset_type", "layout", "--model_name", "stlt",
            "--test_dataset_path", split["val"], "--labels_path", paths["labels"],
            "--videoid2size_path", paths["videoid2size"], "--checkpoint_path", best,
            "--hidden_size", str(H), "--num_attention_heads", str(HEADS),
            "--num_spatial_layers", str(SPATIAL_LAYERS), "--num_temporal_layers", str(TEMPORAL_LAYERS),
            "--batch_size", str(BATCH), "--compute_dtype", "bfloat16", "--use_pallas",
            "--output", predictions,
        ])
        if len(rows) != VAL_CLIPS:
            raise AssertionError(f"train levers: predict served {len(rows)} of {VAL_CLIPS} clips "
                                 f"from best.msgpack")
        log(f"train levers: predict --checkpoint_path best.msgpack served {len(rows)} clips")

        # (c) one 17-frame B = 512 step from the same weights, batch and generator.
        model.train()
        big = {k: v.repeat(TRAIN_BATCH // BATCH, *([1] * (v.dim() - 1))) for k, v in batch.items()}
        check_embedding_backward("category table", batch["categories"], model_kw["unique_categories"])
        check_embedding_backward("category table", big["categories"], model_kw["unique_categories"])
        check_embedding_backward("frame-type table", big["frame_types"], stlt.NUM_FRAME_TYPES)
        label = f"train step of {TRAIN_BATCH} clips, 17 frames"
        set_remat(model, True)
        remat = _one_step(model, big, criterion)
        set_remat(model, False)
        _bit_for_bit(f"{label}, remat vs none (dropout {DROPOUT})", remat, _one_step(model, big, criterion))
        del remat
        still = models_factory["stlt"](make_model_config("stlt", **dict(model_kw, hidden_dropout_prob=0.0)))
        still.load_state_dict(model.state_dict(), strict=True)
        still = still.to(device)
        _compare_steps(label, f"k = {LEVER_ACCUM} vs k = 1 (dropout 0)",
                       _one_step(still, big, criterion, LEVER_ACCUM), _one_step(still, big, criterion))
        del still
        set_remat(model, True)
        _step_kernels_vs_plain(f"{label}, remat and k = {LEVER_ACCUM}", model, big, criterion,
                               grad_accum=LEVER_ACCUM)
        # (e) at 17 frames, B = 512: each lever on and off.
        out["steps"] = _lever_timings(model, big, criterion, f"17 frames, B = {TRAIN_BATCH}", (
            ("no lever", False, 1), ("remat", True, 1), (f"k = {LEVER_ACCUM}", False, LEVER_ACCUM),
            (f"remat and k = {LEVER_ACCUM}", True, LEVER_ACCUM)), card)
        del model, big, batch, inputs, logits, logits_pt
        torch.cuda.empty_cache()

        # (d) one 256-frame step: remat against none, and the launches under remat.
        long_root = os.path.join(root, "long")
        os.makedirs(long_root)
        long_paths = write_something_dataset(long_root, LEVER_LONG_CLIPS, SEED + 11,
                                             num_used=TRAIN_LABELS, frames_range=LONG_TRAIN[256][1])
        long_split = {"train": long_paths["dataset"], "val": long_paths["dataset"]}
        long_cfg, long_kw = train_model_kw(long_split, long_paths, LEVER_LONG_FRAMES)
        long_model = models_factory["stlt"](make_model_config("stlt", **long_kw),
                                            torch.Generator().manual_seed(SEED + 11)).to(device)
        long_batch = _train_batch(long_cfg, LEVER_LONG_CLIPS, device)
        small = {k: v[:LEVER_LONG_STEP_CLIPS] for k, v in long_batch.items()}
        label = f"train step of {LEVER_LONG_STEP_CLIPS} clips, {LEVER_LONG_FRAMES} frames"
        set_remat(long_model, True)
        reset_all_launches()
        remat = _one_step(long_model, small, criterion)
        torch.cuda.synchronize()
        counts = all_launches()
        set_remat(long_model, False)
        _bit_for_bit(f"{label}, remat vs none (dropout {DROPOUT})", remat,
                     _one_step(long_model, small, criterion))
        del remat
        want = dict.fromkeys(counts, 0)
        want.update({"fused_proj_attention_train": 2 * SPATIAL_LAYERS,
                     "fused_proj_attention_train_bwd": SPATIAL_LAYERS,
                     "flash_attention": 2 * TEMPORAL_LAYERS, "flash_attention_bwd": TEMPORAL_LAYERS,
                     "fused_layer_tail_train": 2 * layers})
        want.update({name: layers for name in TAIL_KERNELS[1:]})
        log(f"{label} under remat: launches {counts}")
        if counts != want:
            raise AssertionError(f"{label} under remat: launches {counts}, expected {want} (each "
                                 f"forward twice, each backward once)")

        # (e) at 256 frames (B = 32), with and without remat.
        out["steps"] += _lever_timings(long_model, long_batch, criterion,
                                       f"{LEVER_LONG_FRAMES} frames, B = {LEVER_LONG_CLIPS}",
                                       (("no lever", False, 1), ("remat", True, 1)), card)
        del long_model, long_batch, small
        torch.cuda.empty_cache()
    return out


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
                common = _fusion_predict_argv(name, test_sets[num_batches], paths, videos, ckpts[name],
                                              frames, batch_size)
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
    ("attention forward kernels (row 3)", PROJ_KERNELS),
    ("attention backward kernels", PROJ_BWD_KERNELS),
    *ATTN_FWD_GROUPS,
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
                # f32 variant, the appearance encoder's flipped ReLU gates
                # pinned (GATE_PIN_ABS).
                f32_model = models_factory["cacnf"](
                    dataclasses.replace(model.config, compute_dtype="float32"))
                f32_model.load_state_dict(model.state_dict())
                for p32, p in zip(f32_model.parameters(), model.parameters()):
                    p32.requires_grad_(p.requires_grad)  # the frozen BN parameters
                _step_kernels_vs_plain(f"{name}, f32", f32_model.to(device).train(), batch, criterion,
                                       FUSION_STEP_F32, pin_gates=True)
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
            if frames < _BLOCKWISE_FRAMES:
                step_ms[frames]["tail_gate_ab"] = tail_gate_ab(name, model, batch, criterion, ms, steps=3)
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


# --- phase 9: serving under --context_parallel 2, two ranks on one card -------

RING_C = 2
# --layout_num_frames -> (batch, the clips' frame counts): the 17-frame set
# (B = 64) and a ragged 512-frame set (B = 32) of clips of 32-512 frames,
# so that about half of them span both ranks (phase 5's clips, at most 256
# frames, would leave rank 1 with dead frames only).
RING_RUNS = {16: (BATCH, (3, 25)), 512: (LONG_CLIPS[512][0], (32, 513))}
RING_FORWARDS = 3  # timed forwards of each rank and of the single process
# The op check: ring_attention at C = 2 on a 512-frame clip's heads (514
# frames, 12 heads of 64, bf16, causal, lengths 33-514) against the single
# device's blockwise_attention, within OP_TOL elementwise and RING_REL in
# relative norm. RING_REL is set from two readings on the card (PERF.md §6):
# the sound ring (each step's output rounded to bf16 before the f32
# merge, as in JAX's ring, so a row whose keys span both chunks is rounded
# twice) and the planted fault of ring_steps_on_one_device(col_shift=1).
RING_OP = (32, 2 * RING_T, HEADS, H // HEADS)
RING_REL = 1e-3


def ring_steps_on_one_device(q, k, v, lengths, col_shift: int = 0, with_lse: bool = False,
                             mask=None):
    """ring_attention's steps for every rank of a ring of RING_C, run on one
    device: the same blockwise calls with offsets and the same f32
    ``logaddexp`` merge, the chunks taken in place of the transfers.
    ``col_shift`` plants a fault: every step's col0 off by that many keys.
    With ``with_lse`` also each rank's merged lse. ``mask`` [B, 1|N, T, T]:
    each step drops with the rank's rows and the held chunk's columns of it
    (rate DROPOUT)."""
    from stlt_tpu_torch.ops import flash

    B, T, N, D = q.shape
    t = T // RING_C
    outs, lses = [], []
    for idx in range(RING_C):
        rows = slice(idx * t, (idx + 1) * t)
        o = torch.zeros((B, N, t, D), dtype=torch.float32, device=q.device)
        lse = torch.full((B, N, t), flash._NEG_INF, dtype=torch.float32, device=q.device)
        for j in range(RING_C):
            chunk = (idx - j) % RING_C
            cols = slice(chunk * t, (chunk + 1) * t)
            drop = {} if mask is None else dict(dropout_mask=mask[:, :, rows, cols], dropout_rate=DROPOUT)
            o_j, lse_j = flash.blockwise_attention(q[:, rows], k[:, cols], v[:, cols], kv_lengths=lengths,
                                                   causal=True,
                                                   offsets=(idx * t, chunk * t + col_shift), **drop)
            lse_new = torch.logaddexp(lse, lse_j)
            o = o * torch.exp(lse - lse_new)[..., None] + \
                o_j.transpose(1, 2).float() * torch.exp(lse_j - lse_new)[..., None]
            lse = lse_new
        outs.append(o.transpose(1, 2).to(v.dtype))
        lses.append(lse)
    return (torch.cat(outs, dim=1), lses) if with_lse else torch.cat(outs, dim=1)


def ring_op_inputs(device):
    """q, k, v [B, 514, 12, 64] bf16 and lengths [B] of the op check, the
    same on every rank (drawn from one seed on the host)."""
    B, T, N, D = RING_OP
    gen = torch.Generator().manual_seed(SEED + 13)
    q, k, v = (torch.randn((B, T, N, D), generator=gen).to(device, torch.bfloat16) for _ in range(3))
    lengths = torch.randint(33, T + 1, (B,), generator=gen)
    lengths[0], lengths[1] = 33, T
    return q, k, v, lengths.to(device)


def ring_op_mask(device):
    """The masked op check's head-broadcast keep mask [B, 1, 514, 514]
    (Bernoulli(1 - DROPOUT)), the same on every rank (drawn from one seed on
    the host)."""
    B, T = RING_OP[:2]
    gen = torch.Generator().manual_seed(SEED + 14)
    return (torch.rand((B, 1, T, T), generator=gen) >= DROPOUT).to(device)


def _ring_argv(paths, ckpt, frames, batch_size, out):
    return [
        "--dataset_name", "something", "--dataset_type", "layout", "--model_name", "stlt",
        "--test_dataset_path", paths["dataset"], "--labels_path", paths["labels"],
        "--videoid2size_path", paths["videoid2size"], "--checkpoint_path", ckpt,
        "--hidden_size", str(H), "--num_attention_heads", str(HEADS),
        "--num_spatial_layers", str(SPATIAL_LAYERS), "--num_temporal_layers", str(TEMPORAL_LAYERS),
        "--layout_num_frames", str(frames), "--batch_size", str(batch_size),
        "--compute_dtype", "bfloat16", "--use_pallas", "--output", out, "--top_k", "5",
        "--context_parallel", str(RING_C),
    ]


def _host_ms(fn, iters: int) -> float:
    """Mean host-clock time of ``fn`` (ending in a synchronize) after one
    warmup: the ring's forward waits on host-staged transfers."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def ring_rank(rank: int, port: int, workdir: str) -> int:
    """One rank of phase 9 (``chip_smoke.py --ring-rank R PORT WORKDIR``):
    ``predict`` over each RING_RUNS set as rank R of a context ring of
    RING_C processes on this card, with the launch counts of each run; then
    the first batch's logits and the forward's time under the ring. Writes
    ``rank_R.json`` and ``rank_R_FRAMES.npy`` (the logits) to WORKDIR."""
    from stlt_tpu_torch import predict
    from stlt_tpu_torch.configs import DataConfig, position_table_rows
    from stlt_tpu_torch.parser import build_parser

    with open(os.path.join(workdir, "runs.json")) as f:
        runs = json.load(f)
    report = {"rank": rank, "runs": {}}
    parser = build_parser("chip_smoke ring rank")
    parser.add_argument("--top_k", type=int, default=5)
    parser.add_argument("--output", type=str)
    first = parser.parse_args(runs[0]["argv"] + ["--num_processes", str(RING_C), "--process_id",
                                                 str(rank), "--coordinator_address",
                                                 f"localhost:{port}"])
    predict.check_flags(first)
    device = predict.start_processes(first)
    report["device"] = str(device)
    try:
        from stlt_tpu_torch.ops import flash
        from stlt_tpu_torch.ops.ring import ring_attention
        from stlt_tpu_torch.parallel.mesh import active_context_mesh

        q, k, v, lengths = ring_op_inputs(device)
        t = RING_OP[1] // RING_C
        rows = slice(rank * t, (rank + 1) * t)
        with torch.inference_mode():
            out = ring_attention(q[:, rows], k[:, rows], v[:, rows], None, active_context_mesh(),
                                 kv_lengths=lengths, causal=True)
        torch.cuda.synchronize()
        np.save(os.path.join(workdir, f"rank_{rank}_op.npy"), out.float().cpu().numpy())
        # The same op with a dropout mask: each step reads the held chunk's
        # columns of this rank's rows of the mask.
        keep = ring_op_mask(device)
        flash.reset_launches()
        with torch.inference_mode():
            out = ring_attention(q[:, rows], k[:, rows], v[:, rows], None, active_context_mesh(),
                                 kv_lengths=lengths, causal=True, dropout_mask=keep[:, :, rows],
                                 dropout_rate=DROPOUT)
        torch.cuda.synchronize()
        report["mask_launches"] = {name: count for name, count in flash.LAUNCHES.items() if count}
        np.save(os.path.join(workdir, f"rank_{rank}_op_mask.npy"), out.float().cpu().numpy())
        del keep
        for run in runs:
            args = parser.parse_args(run["argv"] + ["--num_processes", str(RING_C)])
            predict.check_flags(args)
            reset_all_launches()
            t0 = time.perf_counter()
            rows = predict.serve(args, device)
            torch.cuda.synchronize()
            entry = {"rows": len(rows), "seconds": time.perf_counter() - t0,
                     "launches": all_launches()}
            data_cfg = DataConfig(dataset_name="something", dataset_path=args.test_dataset_path,
                                  labels_path=args.labels_path,
                                  videoid2size_path=args.videoid2size_path,
                                  layout_num_frames=args.layout_num_frames, frames_multiple=RING_C)
            model_kw = dict(num_classes=NUM_CLASSES, unique_categories=4, hidden_size=H,
                            num_attention_heads=HEADS, num_spatial_layers=SPATIAL_LAYERS,
                            num_temporal_layers=TEMPORAL_LAYERS, compute_dtype="bfloat16")
            model = _served_model(args.checkpoint_path, model_kw, position_table_rows(data_cfg), device)
            _, batch = _first_batch(data_cfg, args.batch_size, device)
            with torch.inference_mode():
                logits = model(batch)["stlt"]
                entry["forward_ms"] = _host_ms(lambda: model(batch), RING_FORWARDS)
            np.save(os.path.join(workdir, f"rank_{rank}_{args.layout_num_frames}.npy"),
                    logits.float().cpu().numpy())
            report["runs"][str(args.layout_num_frames)] = entry
            del model, batch
            torch.cuda.empty_cache()
    finally:
        predict.stop_processes()
    with open(os.path.join(workdir, f"rank_{rank}.json"), "w") as f:
        json.dump(report, f)
    return 0


def run_ring_path(device):
    """Serve a random full-width bf16 STLT through ``predict --context_parallel
    2 --num_processes 2``: two rank processes on this one card (gloo, the ring's
    K/V staged through host memory; NCCL refuses two ranks on one GPU), over
    the 17-frame set (B = 64) and the ragged 512-frame set (B = 32). Asserts
    each rank's backend line and device, the rows each run writes, the launch
    counts per rank per forward (the blockwise kernel's ring-offset mode 8
    layers x 2 steps, the fused projection+attention 4, the layer tail 12,
    nothing else), and both ranks' logits of the first batch against the
    single process's on the same weights and batch (LOGITS_ATOL); prints
    each rank's forward time beside the single process's. Two ranks that
    share one card, with host-staged rotation, is no speed claim. Returns
    the ring-offset mode's launches of rank 0 (both runs)."""
    import socket

    from stlt_tpu_torch.configs import DataConfig, make_model_config, position_table_rows
    from stlt_tpu_torch.models import models_factory
    from stlt_tpu_torch.ops import flash

    layers = SPATIAL_LAYERS + TEMPORAL_LAYERS
    model_kw = dict(num_classes=NUM_CLASSES, unique_categories=4, hidden_size=H,
                    num_attention_heads=HEADS, num_spatial_layers=SPATIAL_LAYERS,
                    num_temporal_layers=TEMPORAL_LAYERS, compute_dtype="bfloat16")
    with tempfile.TemporaryDirectory(prefix="stlt_chip_smoke_ring_") as root:
        runs, cfgs = [], {}
        for frames, (batch_size, frames_range) in RING_RUNS.items():
            sub = os.path.join(root, str(frames))
            os.makedirs(sub)
            paths = write_something_dataset(sub, batch_size * LONG_NUM_BATCHES, SEED + 11 + frames,
                                            frames_range=frames_range)
            data_cfg = DataConfig(dataset_name="something", dataset_path=paths["dataset"],
                                  labels_path=paths["labels"], videoid2size_path=paths["videoid2size"],
                                  layout_num_frames=frames, frames_multiple=RING_C)
            rows = position_table_rows(data_cfg)
            model = models_factory["stlt"](make_model_config("stlt", **model_kw, layout_num_frames=rows),
                                           torch.Generator().manual_seed(SEED + 12))
            ckpt = os.path.join(sub, "stlt_random.pt")
            torch.save(model.state_dict(), ckpt)
            del model
            runs.append({"argv": _ring_argv(paths, ckpt, frames, batch_size,
                                            os.path.join(sub, "predictions.jsonl"))})
            cfgs[frames] = (data_cfg, ckpt, batch_size, rows)
        with open(os.path.join(root, "runs.json"), "w") as f:
            json.dump(runs, f)
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--ring-rank", str(r),
                                   str(port), root], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for r in range(RING_C)]
        outs = []
        try:
            for proc in procs:
                outs.append(proc.communicate(timeout=900)[0])
        finally:
            for proc in procs:
                proc.kill()
        for r, (proc, out) in enumerate(zip(procs, outs)):
            tail = "\n".join(out.splitlines()[-40:])
            if proc.returncode != 0:
                raise AssertionError(f"ring rank {r} exited {proc.returncode}:\n{tail}")
            want_line = f"distributed: rank {r} of {RING_C} on cuda:0, backend gloo"
            if want_line not in out:
                raise AssertionError(f"ring rank {r}: no line '{want_line}' in its log:\n{tail}")
            log(f"ring rank {r}: " + next(line for line in out.splitlines() if want_line in line))
        reports = []
        for r in range(RING_C):
            with open(os.path.join(root, f"rank_{r}.json")) as f:
                reports.append(json.load(f))
            if reports[-1]["device"] != "cuda:0":
                raise AssertionError(f"ring rank {r} ran on {reports[-1]['device']}")
        # The op: the ranks' ring_attention against one device running the
        # same steps (the same kernel calls and f32 merge, no transfers: the
        # transfers lose nothing), and against the unsharded blockwise kernel
        # (RING_REL), whose limit must also catch the planted fault. Both
        # against the f32 plain version of the whole sequence, to show what
        # the second rounding of the ring costs.
        q, k, v, lengths = ring_op_inputs(device)
        keep = ring_op_mask(device)
        with torch.inference_mode():
            single, _ = flash.blockwise_attention(q, k, v, kv_lengths=lengths, causal=True)
            steps = ring_steps_on_one_device(q, k, v, lengths)
            fault = ring_steps_on_one_device(q, k, v, lengths, col_shift=1)
            masked_steps = ring_steps_on_one_device(q, k, v, lengths, mask=keep)
            exact, _ = flash.blockwise_attention_plain(q.float(), k.float(), v.float(),
                                                       kv_lengths=lengths, causal=True)
        got = torch.from_numpy(np.concatenate(
            [np.load(os.path.join(root, f"rank_{r}_op.npy")) for r in range(RING_C)], axis=1)).to(
                device, torch.bfloat16)
        live = (torch.arange(RING_OP[1], device=device)[None, :] < lengths[:, None])
        live = live[:, :, None, None].expand(got.shape)
        label = f"ring_attention at C = {RING_C} (two ranks, B = {RING_OP[0]}, {RING_OP[1]} frames)"
        err, rel = _check_pairs(f"{label} against its steps on one device",
                                [("out", got, steps, live)], OP_TOL[torch.bfloat16], ATTN_FWD_REL)
        err1, rel1 = _check_pairs(f"{label} against the unsharded blockwise kernel",
                                  [("out", got, single, live)], OP_TOL[torch.bfloat16], RING_REL)
        fault_rel = _rel(fault, single)
        if fault_rel <= RING_REL:
            raise AssertionError(f"{label}: the planted fault (col0 off by one) reads {fault_rel:.3e}, "
                                 f"within RING_REL {RING_REL}: the limit catches nothing")
        got_mask = torch.from_numpy(np.concatenate(
            [np.load(os.path.join(root, f"rank_{r}_op_mask.npy")) for r in range(RING_C)], axis=1)).to(
                device, torch.bfloat16)
        err2, rel2 = _check_pairs(f"{label} with a dropout mask against its steps on one device",
                                  [("out", got_mask, masked_steps, live)], OP_TOL[torch.bfloat16],
                                  ATTN_FWD_REL)
        for r, report in enumerate(reports):
            if report["mask_launches"] != {"blockwise_attention_mask": RING_C}:
                raise AssertionError(f"ring rank {r}: the masked op launched {report['mask_launches']}, "
                                     f"expected {RING_C} of blockwise_attention_mask")
        log(f"{label} with a head-broadcast dropout mask (rate {DROPOUT}): against its steps on one "
            f"device max_abs_err {err2:.3e}, relative norm {rel2['out']:.3e}; {RING_C} mask-mode "
            f"launches a rank; against the unmasked ring {_rel(got_mask, got):.3e}")
        del keep, masked_steps, got_mask
        log(f"{label}, causal, lengths 33-{RING_OP[1]}: against its steps on one device max_abs_err "
            f"{err:.3e}, relative norm {rel['out']:.3e} (OP_TOL, ATTN_FWD_REL {ATTN_FWD_REL}); against the "
            f"unsharded blockwise kernel max_abs_err {err1:.3e}, relative norm {rel1['out']:.3e} "
            f"(OP_TOL, RING_REL {RING_REL}; with col0 off by one {fault_rel:.3e}); against the f32 "
            f"plain version the ring {_rel(got, exact):.3e}, the unsharded kernel "
            f"{_rel(single, exact):.3e}")
        offsets_launches = 0
        for frames, (data_cfg, ckpt, batch_size, rows) in cfgs.items():
            model = _served_model(ckpt, model_kw, rows, device)
            _, batch = _first_batch(data_cfg, batch_size, device)
            with torch.inference_mode():
                single = model(batch)["stlt"].float()
                single_ms = _host_ms(lambda: model(batch), RING_FORWARDS)
            per_forward = dict.fromkeys(reports[0]["runs"][str(frames)]["launches"], 0)
            per_forward.update({"blockwise_attention_offsets": TEMPORAL_LAYERS * RING_C,
                                "fused_proj_attention": SPATIAL_LAYERS, "fused_layer_tail": layers})
            for r, report in enumerate(reports):
                run = report["runs"][str(frames)]
                want = {k: v * LONG_NUM_BATCHES for k, v in per_forward.items()}
                if run["launches"] != want:
                    raise AssertionError(f"ring rank {r}, {frames} frames: launches {run['launches']}, "
                                         f"expected {want} ({LONG_NUM_BATCHES} forwards)")
                if run["rows"] != batch_size * LONG_NUM_BATCHES:
                    raise AssertionError(f"ring rank {r}, {frames} frames: {run['rows']} rows")
                got = torch.from_numpy(np.load(os.path.join(root, f"rank_{r}_{frames}.npy"))).to(device)
                _check_logits(f"ring rank {r}, {frames} frames", got, single,
                              "the single process on the same weights and batch")
                log(f"ring rank {r}, {frames} frames (B = {batch_size}, {data_cfg.num_total_frames} "
                    f"frame slots): predict {run['rows']} clips in {run['seconds']:.3f} s; launches per "
                    f"forward {json.dumps({k: v // LONG_NUM_BATCHES for k, v in run['launches'].items() if v})}; "
                    f"forward {run['forward_ms']:.3f} ms against {single_ms:.3f} ms in one process "
                    f"(two ranks share this one card, the ring staged through host memory: no "
                    f"speed claim)")
            with open(os.path.join(os.path.dirname(ckpt), "predictions.jsonl")) as f:
                written = [json.loads(line) for line in f]
            if len(written) != batch_size * LONG_NUM_BATCHES:
                raise AssertionError(f"the coordinator wrote {len(written)} rows at {frames} frames")
            offsets_launches += reports[0]["runs"][str(frames)]["launches"]["blockwise_attention_offsets"]
            del model, batch
            torch.cuda.empty_cache()
    return {"blockwise_attention_offsets": offsets_launches}


# --- phase 10: training under --context_parallel 2, two ranks on one card ---

# --layout_num_frames -> (batch, the clips' frame counts): the 512-frame
# train batch of phase 6 (B = 16; the train sampler fills every one of the
# 514 slots but the padding one) with clips of 32-512 frames, so that the
# validation batch and the one-step comparison's batch span both ranks; the
# 16-frame batch of phase 4 (B = 64, 18 slots).
RING_TRAIN = {512: (LONG_TRAIN[512][0], (32, 513)), 16: (BATCH, (3, 25))}
RING_TRAIN_STEPS = 2  # one epoch of two AdamW steps and one validation batch
# ring_attention's gradients on two ranks against the unsharded blockwise
# backward (bf16, relative norm), set from two readings on the card as
# RING_REL was: the sound ring reads 6.9e-4 (dq) and 2.1e-3 (dk, dv: each
# chunk's sum adds two steps' bf16-rounded parts), the planted fault of
# ring_bwd_steps_on_one_device(col_shift=1) 0.25 to 0.42 (H100; PERF.md
# §6).
RING_BWD_REL = 5e-3


def ring_op_cotangent(device, lengths):
    """The op check's cotangent [B, 514, 12, 64] bf16, zero on dead rows, the
    same on every rank."""
    gen = torch.Generator().manual_seed(SEED + 16)
    g = torch.randn(RING_OP, generator=gen).to(device, torch.bfloat16)
    dead = torch.arange(RING_OP[1], device=device)[None, :] >= lengths[:, None]
    return g.masked_fill(dead[:, :, None, None], 0)


def ring_bwd_steps_on_one_device(q, k, v, lengths, g, col_shift: int = 0):
    """The ring's backward for every rank of a ring of RING_C, run on one
    device: each rank's merged output and lse from ring_steps_on_one_device,
    then per step one blockwise backward call with offsets, dq summed per
    rank and dk, dv per chunk in f32. ``col_shift`` plants a fault: every
    backward step's col0 off by that many keys."""
    from stlt_tpu_torch.ops import flash

    B, T, N, D = q.shape
    t = T // RING_C
    out, lses = ring_steps_on_one_device(q, k, v, lengths, with_lse=True)
    grads = [torch.zeros(x.shape, dtype=torch.float32, device=q.device) for x in (q, k, v)]
    for idx in range(RING_C):
        rows = slice(idx * t, (idx + 1) * t)
        dsum = flash._dsum(g[:, rows], out[:, rows], lengths, idx * t)
        for j in range(RING_C):
            chunk = (idx - j) % RING_C
            cols = slice(chunk * t, (chunk + 1) * t)
            dq, dk, dv = flash.blockwise_attention_bwd(
                q[:, rows], k[:, cols], v[:, cols], g[:, rows], lses[idx], dsum, kv_lengths=lengths,
                causal=True, offsets=(idx * t, chunk * t + col_shift))
            grads[0][:, rows] += dq
            grads[1][:, cols] += dk
            grads[2][:, cols] += dv
    return [x.to(q.dtype) for x in grads]


def _ring_train_argv(split, paths, frames, batch_size):
    return [
        "--dataset_name", "something", "--dataset_type", "layout", "--model_name", "stlt",
        "--train_dataset_path", split["train"], "--val_dataset_path", split["val"],
        "--labels_path", paths["labels"], "--videoid2size_path", paths["videoid2size"],
        "--hidden_size", str(H), "--num_attention_heads", str(HEADS),
        "--num_spatial_layers", str(SPATIAL_LAYERS), "--num_temporal_layers", str(TEMPORAL_LAYERS),
        "--hidden_dropout_prob", str(DROPOUT), "--layout_num_frames", str(frames),
        "--batch_size", str(batch_size), "--epochs", "1", "--learning_rate", "1e-4",
        "--compute_dtype", "bfloat16", "--use_pallas", "--seed", str(SEED),
        "--context_parallel", str(RING_C),
    ]


def _ring_train_model(frames, dropout, device):
    """The seeded random full-width bf16 STLT of the one-step comparison and
    the step times, the same in every process, in train mode."""
    from stlt_tpu_torch.configs import make_model_config
    from stlt_tpu_torch.models import models_factory

    cfg = make_model_config("stlt", num_classes=NUM_CLASSES, unique_categories=4, hidden_size=H,
                            num_attention_heads=HEADS, num_spatial_layers=SPATIAL_LAYERS,
                            num_temporal_layers=TEMPORAL_LAYERS, compute_dtype="bfloat16",
                            hidden_dropout_prob=dropout, layout_num_frames=max(256, frames + RING_C))
    return models_factory["stlt"](cfg, torch.Generator().manual_seed(SEED + 15)).to(device).train()


def _ring_train_batch(paths, frames, batch_size, device, train: bool):
    """The first batch (labels and valid included) of the train file (the
    train sampler: every slot live) or of the validation file (ragged
    clips), the frame axis padded to a multiple of RING_C."""
    from stlt_tpu_torch.configs import DataConfig
    from stlt_tpu_torch.data import collaters_factory, datasets_factory
    from stlt_tpu_torch.data.loader import Loader, to_device

    data_cfg = DataConfig(dataset_name="something", dataset_path=paths["train" if train else "val"],
                          labels_path=paths["labels"], videoid2size_path=paths["videoid2size"],
                          layout_num_frames=frames, train=train, frames_multiple=RING_C)
    loader = Loader(datasets_factory["layout"](data_cfg), batch_size,
                    collaters_factory["layout"](data_cfg), prefetch=0, shuffle=train, seed=SEED)
    return next(iter(to_device(loader, device)))


def _digest(tensors) -> str:
    """A sha256 of the tensors' f32 bytes, in order: equal digests, equal bits."""
    import hashlib

    digest = hashlib.sha256()
    for x in tensors:
        digest.update(x.detach().float().cpu().numpy().tobytes())
    return digest.hexdigest()


def ring_train_rank(rank: int, workdir: str) -> int:
    """One rank of phase 10 (``chip_smoke.py --ring-train-rank R WORKDIR``):
    ``train --context_parallel 2`` over each RING_TRAIN set as rank R (its
    own process group each, at the ports of ``runs.json``), with its launch
    counts, epoch records and a digest of its trained weights; then, under
    one more process group, ring_attention's gradients on the op check's
    input, one step at dropout 0 from the seeded weights with the backbone's
    gradients summed over the ring, and the step time and peak memory at
    dropout 0.1. Writes ``train_rank_R.json``, ``train_rank_R_op.pt`` and
    (rank 0) ``train_rank_0_FRAMES.pt`` (the step's loss and gradients)."""
    from stlt_tpu_torch import predict
    from stlt_tpu_torch import train as port_train
    from stlt_tpu_torch.ops.ring import ring_attention
    from stlt_tpu_torch.parallel.mesh import active_context_mesh
    from stlt_tpu_torch.parser import build_parser
    from stlt_tpu_torch.training.criterion import make_criterion
    from stlt_tpu_torch.training.loop import step_generator, sum_grads_over_ring_

    with open(os.path.join(workdir, "runs.json")) as f:
        spec = json.load(f)
    report = {"rank": rank, "runs": {}}
    process = ["--num_processes", str(RING_C), "--process_id", str(rank)]
    for run in spec["runs"]:
        reset_all_launches()
        t0 = time.perf_counter()
        result = port_train.main(run["argv"] + process + [
            "--coordinator_address", f"localhost:{run['port']}",
            "--save_model_path", os.path.join(run["root"], f"best_{rank}.pt")])
        torch.cuda.synchronize()
        report["runs"][str(run["frames"])] = {
            "seconds": time.perf_counter() - t0, "launches": all_launches(), "steps": result.step,
            "epochs": result.epochs, "digest": _digest(result.model.parameters()),
            "device": str(next(result.model.parameters()).device)}
        del result
        torch.cuda.empty_cache()

    args = build_parser("chip_smoke ring train rank").parse_args(
        spec["runs"][0]["argv"] + process + ["--coordinator_address", f"localhost:{spec['port']}"])
    device = predict.start_processes(args)
    report["device"] = str(device)
    criterion = make_criterion("something")
    try:
        mesh = active_context_mesh()
        q, k, v, lengths = ring_op_inputs(device)
        g = ring_op_cotangent(device, lengths)
        t = RING_OP[1] // RING_C
        rows = slice(rank * t, (rank + 1) * t)
        leaves = [x[:, rows].detach().clone().requires_grad_() for x in (q, k, v)]
        ring_attention(*leaves, None, mesh, kv_lengths=lengths, causal=True).backward(g[:, rows])
        torch.save([x.grad.cpu() for x in leaves], os.path.join(workdir, f"train_rank_{rank}_op.pt"))
        del q, k, v, g, leaves
        for run in spec["runs"]:
            frames, batch_size, paths = run["frames"], run["batch_size"], run["paths"]
            entry = report["runs"][str(frames)]
            model = _ring_train_model(frames, 0.0, device)
            batch = _ring_train_batch(paths, frames, batch_size, device, train=False)
            model.zero_grad(set_to_none=True)
            inputs = {key: x for key, x in batch.items() if key not in ("labels", "valid")}
            loss = criterion(model(inputs, step_generator(SEED, 0)), batch["labels"], batch["valid"])
            loss.backward()
            sum_grads_over_ring_(model.backbone.parameters(), mesh)
            grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.grad is not None}
            entry["step_loss"] = loss.item()
            entry["grad_digest"] = _digest(grads.values())
            if rank == 0:
                torch.save({"loss": loss.item(), "grads": grads},
                           os.path.join(workdir, f"train_rank_0_{frames}.pt"))
            del model, grads, batch, inputs, loss
            model = _ring_train_model(frames, DROPOUT, device)
            batch = _ring_train_batch(paths, frames, batch_size, device, train=True)
            torch.cuda.reset_peak_memory_stats()
            entry["step_ms"] = _step_ms(model, batch, criterion, steps=3)
            entry["peak_bytes"] = torch.cuda.max_memory_allocated()
            del model, batch
            torch.cuda.empty_cache()
    finally:
        predict.stop_processes()
    with open(os.path.join(workdir, f"train_rank_{rank}.json"), "w") as f:
        json.dump(report, f)
    return 0


def ring_train_launches(frames: int, steps: int) -> dict:
    """The launch counts of one ``train --context_parallel 2`` run on each
    rank: per step the train op's 4 + 4 (spatial), the ring-offset forward
    and backward 8 layers x 2 ring steps, and from 256 frames 12 of each
    train-tail kernel; per validation batch 4 fused projection+attentions,
    12 eval tails and the ring-offset forward 16. Nothing else."""
    want = {"fused_proj_attention_train": SPATIAL_LAYERS * steps,
            "fused_proj_attention_train_bwd": SPATIAL_LAYERS * steps,
            "blockwise_attention_offsets": TEMPORAL_LAYERS * RING_C * (steps + 1),
            "blockwise_attention_bwd_offsets": TEMPORAL_LAYERS * RING_C * steps,
            "fused_proj_attention": SPATIAL_LAYERS,
            "fused_layer_tail": SPATIAL_LAYERS + TEMPORAL_LAYERS}
    if frames >= 256:
        want.update(dict.fromkeys(TAIL_KERNELS, (SPATIAL_LAYERS + TEMPORAL_LAYERS) * steps))
    return want


def run_ring_train_path(device):
    """Train a random full-width bf16 STLT (dropout 0.1) through ``train
    --context_parallel 2 --num_processes 2``: two rank processes on this one
    card (gloo, as phase 9), at 512 layout frames (B = 16) and 16 (B = 64),
    one epoch of two steps and one validation batch each. Asserts each
    rank's backend line and device, finite losses equal on both ranks, both
    ranks' trained weights equal bit for bit, the checkpoint written by the
    coordinator alone, and the launch counts per rank (ring_train_launches).
    Then: ring_attention's gradients on two ranks against the unsharded
    blockwise backward (RING_BWD_REL, which the planted fault of
    ring_bwd_steps_on_one_device must exceed) and against its steps on one
    device; one step at dropout 0 from the same seeded weights, each rank's
    gradients (summed over the ring, equal on both ranks) against the single
    process's kernel path within the one-step bf16 limits; the step time and
    peak memory of a rank beside the single process's (two ranks share one
    card: no speed claim). Returns the ring-offset backward's launches of
    rank 0 (both runs)."""
    import socket

    from stlt_tpu_torch.ops import flash
    from stlt_tpu_torch.training.criterion import make_criterion

    def free_port():
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            return sock.getsockname()[1]

    with tempfile.TemporaryDirectory(prefix="stlt_chip_smoke_ring_train_") as root:
        runs = []
        for frames, (batch_size, frames_range) in RING_TRAIN.items():
            sub = os.path.join(root, str(frames))
            os.makedirs(sub)
            train_clips = batch_size * RING_TRAIN_STEPS
            paths = write_something_dataset(sub, train_clips + batch_size, SEED + 17 + frames,
                                            num_used=TRAIN_LABELS, frames_range=frames_range)
            split = _split_dataset(paths, sub, train_clips)
            runs.append({"frames": frames, "batch_size": batch_size, "root": sub, "port": free_port(),
                         "paths": {**split, "labels": paths["labels"],
                                   "videoid2size": paths["videoid2size"]},
                         "argv": _ring_train_argv(split, paths, frames, batch_size)})
        with open(os.path.join(root, "runs.json"), "w") as f:
            json.dump({"runs": runs, "port": free_port()}, f)
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--ring-train-rank",
                                   str(r), root], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for r in range(RING_C)]
        outs = []
        try:
            for proc in procs:
                outs.append(proc.communicate(timeout=900)[0])
        finally:
            for proc in procs:
                proc.kill()
        for r, (proc, out) in enumerate(zip(procs, outs)):
            tail = "\n".join(out.splitlines()[-40:])
            if proc.returncode != 0:
                raise AssertionError(f"ring train rank {r} exited {proc.returncode}:\n{tail}")
            want_line = f"distributed: rank {r} of {RING_C} on cuda:0, backend gloo"
            if out.count(want_line) != len(runs) + 1:
                raise AssertionError(f"ring train rank {r}: not {len(runs) + 1} lines '{want_line}' "
                                     f"in its log:\n{tail}")
        reports = []
        for r in range(RING_C):
            with open(os.path.join(root, f"train_rank_{r}.json")) as f:
                reports.append(json.load(f))
            if reports[-1]["device"] != "cuda:0":
                raise AssertionError(f"ring train rank {r} ran on {reports[-1]['device']}")

        # The op: the two ranks' gradients against their steps on one device
        # and against the unsharded blockwise backward, whose limit must catch
        # the planted fault.
        q, k, v, lengths = ring_op_inputs(device)
        g = ring_op_cotangent(device, lengths)
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        flash.flash_attention(*leaves, kv_lengths=lengths, causal=True).backward(g)
        single = [x.grad for x in leaves]
        with torch.no_grad():
            steps = ring_bwd_steps_on_one_device(q, k, v, lengths, g)
            fault = ring_bwd_steps_on_one_device(q, k, v, lengths, g, col_shift=1)
        parts = [torch.load(os.path.join(root, f"train_rank_{r}_op.pt")) for r in range(RING_C)]
        got = [torch.cat([p[i] for p in parts], dim=1).to(device) for i in range(3)]
        label = f"ring_attention gradients at C = {RING_C} (two ranks, B = {RING_OP[0]}, {RING_OP[1]} frames)"
        dead = torch.arange(RING_OP[1], device=device)[None, :] >= lengths[:, None]
        err, rel = _check_grads(f"{label} against its steps on one device", got, steps, dead,
                                torch.bfloat16)
        err1, rel1 = _check_grads(f"{label} against the unsharded blockwise backward", got, single,
                                  dead, torch.bfloat16, RING_BWD_REL)
        fault_rel = {n: _rel(a, b) for n, a, b in zip(("dq", "dk", "dv"), fault, single)}
        if max(fault_rel.values()) <= RING_BWD_REL:
            raise AssertionError(f"{label}: the planted fault (col0 off by one) reads {fault_rel}, "
                                 f"within RING_BWD_REL {RING_BWD_REL}: the limit catches nothing")
        log(f"{label}, causal, lengths 33-{RING_OP[1]}: against its steps on one device max_abs_err "
            f"{err:.3e}, relative norm {json.dumps(rel)} (BWD_REL {BWD_REL[torch.bfloat16]}); against "
            f"the unsharded blockwise backward max_abs_err {err1:.3e}, relative norm {json.dumps(rel1)} "
            f"(RING_BWD_REL {RING_BWD_REL}; with col0 off by one {json.dumps(fault_rel)})")
        del q, k, v, g, leaves, single, steps, fault, parts, got
        torch.cuda.empty_cache()

        criterion = make_criterion("something")
        bwd_launches = 0
        for run in runs:
            frames, batch_size = run["frames"], run["batch_size"]
            label = f"train --context_parallel {RING_C}, {frames} frames, B = {batch_size}"
            entries = [report["runs"][str(frames)] for report in reports]
            want = ring_train_launches(frames, RING_TRAIN_STEPS)
            for r, entry in enumerate(entries):
                counts = entry["launches"]
                if counts != {name: want.get(name, 0) for name in counts}:
                    raise AssertionError(f"{label}, rank {r}: launches {counts}, expected {want}")
                if entry["steps"] != RING_TRAIN_STEPS or entry["device"] != "cuda:0" or not all(
                        math.isfinite(e["train_loss"]) for e in entry["epochs"]):
                    raise AssertionError(f"{label}, rank {r}: bad run {entry}")
                log(f"{label}, rank {r}: {entry['steps']} steps in {entry['seconds']:.3f} s (data, "
                    f"model set-up and validation included); launches {counts}; epochs "
                    f"{json.dumps(entry['epochs'])}")
            if [e["train_loss"] for e in entries[0]["epochs"]] != \
                    [e["train_loss"] for e in entries[1]["epochs"]]:
                raise AssertionError(f"{label}: the ranks' losses differ")
            if entries[0]["digest"] != entries[1]["digest"]:
                raise AssertionError(f"{label}: the ranks' trained weights differ")
            if os.path.exists(os.path.join(run["root"], "best_1.pt")):
                raise AssertionError(f"{label}: rank 1 wrote a checkpoint")
            bwd_launches += entries[0]["launches"]["blockwise_attention_bwd_offsets"]

            # One step at dropout 0 from the same seeded weights: each rank's
            # ring-summed gradients (equal on both ranks) against one process.
            if entries[0]["grad_digest"] != entries[1]["grad_digest"]:
                raise AssertionError(f"{label}: the ranks' summed gradients differ")
            ring = torch.load(os.path.join(root, f"train_rank_0_{frames}.pt"))
            model = _ring_train_model(frames, 0.0, device)
            batch = _ring_train_batch(run["paths"], frames, batch_size, device, train=False)
            loss, grads = _one_step(model, batch, criterion)
            _compare_steps(f"train step {frames} frames, B = {batch_size}, dropout 0",
                           f"{RING_C} ranks (gradients summed over the ring) vs one process",
                           (ring["loss"], {n: x.to(device) for n, x in ring["grads"].items()}),
                           (loss, grads))
            del model, batch, grads, ring
            model = _ring_train_model(frames, DROPOUT, device)
            batch = _ring_train_batch(run["paths"], frames, batch_size, device, train=True)
            torch.cuda.reset_peak_memory_stats()
            ms = _step_ms(model, batch, criterion, steps=3)
            peak = torch.cuda.max_memory_allocated()
            log(f"train step {frames} frames, B = {batch_size} (full width, bf16, dropout {DROPOUT}): "
                + ", ".join(f"rank {r} {e['step_ms']:.3f} ms, peak {e['peak_bytes'] / 2**30:.3f} GiB"
                            for r, e in enumerate(entries))
                + f"; one process {ms:.3f} ms, peak {peak / 2**30:.3f} GiB (two ranks share this "
                  f"one card, the ring and the gradient sum staged through host memory: no speed "
                  f"claim)")
            del model, batch
            torch.cuda.empty_cache()
    return {"blockwise_attention_bwd_offsets": bwd_launches}


# --- phase 12: the data axis ----------------------------------------------------

DATA_N = 2  # data ranks, both on this one card (gloo)
DATA_TRAIN_STEPS = 2  # one epoch of two AdamW steps and one validation batch
DATA_PREDICT_CLIPS = 2 * BATCH + BATCH // 4  # the last batch's rank 1 holds padding alone
DATA_STEP_REPEATS = 3  # timed steps of each rank and of the one process
# (b)'s steps: (model, layout frames, global batch, the clips' frame counts).
DATA_STEPS = (("stlt", 16, BATCH, (3, 25)), ("cacnf", 16, 32, (3, 25)))
# (b)'s ranks against one process on the same rows (loss atol, joined, each,
# each in the appearance branch): the same function with the parts summed
# in the same f32 order, bit for bit where the card repeats its bits. In
# another process cuDNN may take another algorithm for the R3D's first
# convolution's bf16 weight gradient: one bf16 rounding, 2**-8, for the
# appearance branch's tensors (2.1e-3 measured, all else bit for bit;
# H100; PERF.md §6).
DATA_HALVES_LIMITS = (1e-6, 1e-4, 1e-5, 2.0 ** -8)


def _data_step_inputs(case, device, rows=None):
    """(b)'s seeded full-width bf16 model (dropout 0.1, FrozenBatchNorm
    frozen as ``make_optimizer`` freezes it) in train mode and the first
    train batch of its set (``rows``: a data rank's rows of it)."""
    from stlt_tpu_torch.configs import DataConfig, make_model_config, position_table_rows
    from stlt_tpu_torch.data import collaters_factory, datasets_factory
    from stlt_tpu_torch.data.loader import Loader, to_device
    from stlt_tpu_torch.models import models_factory
    from stlt_tpu_torch.training.optimizer import frozen_stats_mask

    name, frames, clips = case["name"], case["frames"], case["batch"]
    multimodal = name == "cacnf"
    data_cfg = DataConfig(dataset_name="something", dataset_path=case["train"],
                          labels_path=case["labels"], videoid2size_path=case["videoid2size"],
                          videos_path=case.get("videos"), layout_num_frames=frames,
                          appearance_num_frames=APPEARANCE_FRAMES, device_normalize=multimodal,
                          train=True)
    kw = dict(FUSION_MODEL) if multimodal else dict(
        num_classes=NUM_CLASSES, unique_categories=4, hidden_size=H, num_attention_heads=HEADS,
        num_spatial_layers=SPATIAL_LAYERS, num_temporal_layers=TEMPORAL_LAYERS,
        compute_dtype="bfloat16")
    cfg = make_model_config(name, **kw, hidden_dropout_prob=DROPOUT,
                            layout_num_frames=position_table_rows(data_cfg))
    model = models_factory[name](cfg, torch.Generator().manual_seed(SEED + 31))
    trainable = frozen_stats_mask(model)
    for n, p in model.named_parameters():
        p.requires_grad_(trainable[n])
    kind = "multimodal" if multimodal else "layout"
    loader = Loader(datasets_factory[kind](data_cfg), clips, collaters_factory[kind](data_cfg),
                    prefetch=0, workers=8, rows=rows)
    return model.to(device).train(), next(iter(to_device(loader, device)))


def _halves_step(model, batch, criterion, device):
    """The data ranks' step computed in one process: each rank's rows of
    ``batch`` through ``loss_and_grads`` under that rank's view of the data
    mesh (its dropout bases, the global valid count) with the all-reduce
    left out, the ranks' parts then summed in f32 as the all-reduce sums
    them. (loss, gradients)."""
    from stlt_tpu_torch.data.loader import VALID_TOTAL
    from stlt_tpu_torch.parallel.distributed import process_row_span
    from stlt_tpu_torch.parallel.mesh import Mesh, set_active_mesh
    from stlt_tpu_torch.training import loop

    saved = loop.all_sum
    loop.all_sum = lambda x, mesh: x  # this rank's part alone
    loss, grads = 0.0, {}
    try:
        for r in range(DATA_N):
            mesh = Mesh((DATA_N, 1, 1), r, "none", device)
            set_active_mesh(mesh)
            lo, hi = process_row_span(mesh, batch["valid"].shape[0])
            part = {k: v[lo:hi] for k, v in batch.items()}
            part[VALID_TOTAL] = batch["valid"].sum()
            loss = loss + loop.loss_and_grads(model, criterion, part, loop.step_generator(SEED, 0))
            for n, p in model.named_parameters():
                if p.grad is not None:
                    grads[n] = grads[n] + p.grad if n in grads else p.grad.detach().clone()
    finally:
        loop.all_sum = saved
        set_active_mesh(None)
    return loss, grads


def _deterministic_convolutions():
    """The same cuDNN algorithms in every process (the R3D convolutions)."""
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = False, True


def data_rank(rank: int, workdir: str) -> int:
    """One rank of phase 12 (``chip_smoke.py --data-rank R WORKDIR``), each
    part under its own process group at the ports of ``spec.json``: (a)
    ``train --num_processes 2`` (launch counts, epoch records, a digest of
    the trained weights); (c) ``predict --num_processes 2`` (rows, launch
    counts); then (b) one step of each DATA_STEPS model on this rank's rows
    at dropout 0.1, its all-reduced loss and gradients (saved by rank 0, a
    digest on both) and its step time, the all-reduce's time on the STLT
    step's bucket, and (c) this rank's rows of the first served batch's
    logits. Writes ``data_rank_R.json`` (and ``data_step_NAME.pt``,
    ``data_logits_R.npy``)."""
    from stlt_tpu_torch import predict
    from stlt_tpu_torch import train as port_train
    from stlt_tpu_torch.configs import DataConfig, position_table_rows
    from stlt_tpu_torch.data import collaters_factory, datasets_factory
    from stlt_tpu_torch.data.loader import VALID_TOTAL, Loader, to_device
    from stlt_tpu_torch.parallel.distributed import process_row_span
    from stlt_tpu_torch.parallel.mesh import active_data_mesh, all_sum
    from stlt_tpu_torch.parser import build_parser
    from stlt_tpu_torch.training.criterion import make_criterion
    from stlt_tpu_torch.training.loop import loss_and_grads, step_generator

    with open(os.path.join(workdir, "spec.json")) as f:
        spec = json.load(f)
    process = ["--num_processes", str(DATA_N), "--process_id", str(rank), "--coordinator_address"]
    report = {"rank": rank}
    reset_all_launches()
    t0 = time.perf_counter()
    result = port_train.main(spec["train_argv"] + process + [
        f"localhost:{spec['ports'][0]}", "--save_model_path", os.path.join(workdir, f"best_{rank}.pt"),
        "--resume_dir", os.path.join(workdir, f"steps_{rank}")])
    torch.cuda.synchronize()
    report["train"] = {"seconds": time.perf_counter() - t0, "launches": all_launches(),
                       "steps": result.step, "epochs": result.epochs,
                       "digest": _digest(result.model.parameters()),
                       "device": str(next(result.model.parameters()).device)}
    del result
    torch.cuda.empty_cache()

    reset_all_launches()
    rows = predict.main(spec["predict_argv"] + process + [
        f"localhost:{spec['ports'][1]}", "--output", os.path.join(workdir, f"predictions_{rank}.jsonl")])
    torch.cuda.synchronize()
    report["predict"] = {"rows": len(rows), "launches": all_launches()}

    args = build_parser("chip_smoke data rank").parse_args(
        spec["train_argv"] + process + [f"localhost:{spec['ports'][2]}"])
    device = predict.start_processes(args)
    report["device"] = str(device)
    criterion = make_criterion("something")
    _deterministic_convolutions()
    try:
        mesh = active_data_mesh()
        with frames_directory_videos():
            for case in spec["steps"]:
                span = process_row_span(mesh, case["batch"])
                model, batch = _data_step_inputs(case, device, rows=span)
                model.zero_grad(set_to_none=True)
                loss = loss_and_grads(model, criterion, batch, step_generator(SEED, 0))
                grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()
                         if p.grad is not None}
                entry = {"rows": list(span), "loss": loss.item(), "grad_digest": _digest(grads.values()),
                         "params": sum(p.numel() for p in model.parameters() if p.requires_grad)}
                if rank == 0:
                    torch.save({"loss": loss.item(), "grads": grads},
                               os.path.join(workdir, f"data_step_{case['name']}.pt"))
                del grads
                torch.cuda.reset_peak_memory_stats()
                entry["step_ms"] = _step_ms(model, batch, criterion, steps=DATA_STEP_REPEATS)
                entry["peak_bytes"] = torch.cuda.max_memory_allocated()
                report[case["name"]] = entry
                del model, batch
                torch.cuda.empty_cache()
        bucket = torch.ones(report["stlt"]["params"] + 1, dtype=torch.float32, device=device)
        times = []
        for _ in range(DATA_STEP_REPEATS + 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            all_sum(bucket, mesh)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        report["allreduce_ms"] = sorted(times[1:])[len(times[1:]) // 2]
        report["allreduce_bytes"] = bucket.numel() * 4
        del bucket

        pargs = build_parser("chip_smoke data rank").parse_args(spec["predict_argv"])
        data_cfg = DataConfig(dataset_name="something", dataset_path=pargs.test_dataset_path,
                              labels_path=pargs.labels_path, videoid2size_path=pargs.videoid2size_path)
        model_kw = dict(num_classes=NUM_CLASSES, unique_categories=4, hidden_size=H,
                        num_attention_heads=HEADS, num_spatial_layers=SPATIAL_LAYERS,
                        num_temporal_layers=TEMPORAL_LAYERS, compute_dtype="bfloat16")
        model = _served_model(pargs.checkpoint_path, model_kw, position_table_rows(data_cfg), device)
        loader = Loader(datasets_factory["layout"](data_cfg), BATCH,
                        collaters_factory["layout"](data_cfg), prefetch=0,
                        rows=process_row_span(mesh, BATCH))
        batch = next(iter(to_device(loader, device)))
        with torch.inference_mode():
            logits = model({k: v for k, v in batch.items()
                            if k not in ("labels", "valid", VALID_TOTAL)})
        np.save(os.path.join(workdir, f"data_logits_{rank}.npy"), logits["stlt"].float().cpu().numpy())
    finally:
        predict.stop_processes()
    with open(os.path.join(workdir, f"data_rank_{rank}.json"), "w") as f:
        json.dump(report, f)
    return 0


def run_data_axis_path(device):
    """Phase 12, the data axis (``--num_processes 2``): two rank processes
    on this one card (gloo; host-staged collectives, as phases 9 and 10).
    (a) ``train --num_processes 2``: phase 4's full-width bf16 STLT (17
    frames, B = 64, 32 a rank, dropout 0.1), two steps and one validation
    batch; each rank's backend line and device, finite losses equal on both
    ranks, the trained weights equal bit for bit, the checkpoint written by
    rank 0 alone, each rank's launch counts phase 4's per step and per
    validation batch. (b) one step from the same seeded weights, batch and
    seeds at dropout 0.1, STLT (B = 64) and CACNF (16 layout frames, B =
    32): the two ranks' all-reduced loss and gradients (equal on both)
    against one process on the same rows (``_halves_step``, within
    DATA_HALVES_LIMITS, bit-identity logged) and against the one process's
    kernel path on the global batch within the one-step limits (the fusion
    step's for CACNF, but for its R3D trunk: cuDNN runs other bf16
    convolution algorithms at B / 2, so the trunk's gradients move by
    rounding through its ReLU gates; logged beside the one process's own
    halves against its whole batch). (c) ``predict
    --num_processes 2`` (17 frames, 144 clips in batches of 64): the one
    process's clips in its order, each rank's launch counts, and the ranks'
    rows of the first batch's logits against the one process's within
    LOGITS_ATOL. (e) each rank's step time, the all-reduce's time on the
    STLT step's bucket and the one process's step time (two ranks share
    one card: no speed claim)."""
    import socket

    from stlt_tpu_torch import predict
    from stlt_tpu_torch.configs import DataConfig, make_model_config, position_table_rows
    from stlt_tpu_torch.data import collaters_factory, datasets_factory
    from stlt_tpu_torch.data.loader import Loader, to_device
    from stlt_tpu_torch.models import models_factory
    from stlt_tpu_torch.training.criterion import make_criterion

    def free_port():
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            return sock.getsockname()[1]

    criterion = make_criterion("something")
    with tempfile.TemporaryDirectory(prefix="stlt_chip_smoke_data_") as root, frames_directory_videos():
        train_clips = BATCH * DATA_TRAIN_STEPS
        paths = write_something_dataset(root, train_clips + BATCH, SEED + 30, num_used=TRAIN_LABELS)
        split = _split_dataset(paths, root, train_clips)
        train_argv_ = train_argv(split, paths, os.path.join(root, "unused.pt")) + ["--epochs", "1"]
        serve_root = os.path.join(root, "serve")
        os.makedirs(serve_root)
        serve_paths = write_something_dataset(serve_root, DATA_PREDICT_CLIPS, SEED + 32)
        serve_cfg = DataConfig(dataset_name="something", dataset_path=serve_paths["dataset"],
                               labels_path=serve_paths["labels"],
                               videoid2size_path=serve_paths["videoid2size"])
        ckpt = os.path.join(serve_root, "random.pt")
        served_kw = dict(num_classes=NUM_CLASSES, unique_categories=4, hidden_size=H,
                         num_attention_heads=HEADS, num_spatial_layers=SPATIAL_LAYERS,
                         num_temporal_layers=TEMPORAL_LAYERS, compute_dtype="bfloat16")
        torch.save(models_factory["stlt"](make_model_config(
            "stlt", **served_kw, layout_num_frames=position_table_rows(serve_cfg)),
            torch.Generator().manual_seed(SEED + 33)).state_dict(), ckpt)
        predict_argv = [
            "--dataset_name", "something", "--dataset_type", "layout", "--model_name", "stlt",
            "--test_dataset_path", serve_paths["dataset"], "--labels_path", serve_paths["labels"],
            "--videoid2size_path", serve_paths["videoid2size"], "--checkpoint_path", ckpt,
            "--hidden_size", str(H), "--num_attention_heads", str(HEADS),
            "--num_spatial_layers", str(SPATIAL_LAYERS), "--num_temporal_layers", str(TEMPORAL_LAYERS),
            "--batch_size", str(BATCH), "--compute_dtype", "bfloat16", "--use_pallas",
        ]
        steps = []
        for name, frames, clips, frames_range in DATA_STEPS:
            sub = os.path.join(root, f"step_{name}")
            os.makedirs(sub)
            step_paths = write_something_dataset(sub, clips, SEED + 34, num_used=TRAIN_LABELS,
                                                 frames_range=frames_range)
            case = {"name": name, "frames": frames, "batch": clips, "train": step_paths["dataset"],
                    "labels": step_paths["labels"], "videoid2size": step_paths["videoid2size"]}
            if name == "cacnf":
                with open(step_paths["dataset"]) as f:
                    case["videos"] = write_video_frames(os.path.join(sub, "frames"),
                                                        [c["id"] for c in json.load(f)], SEED + 34)
            steps.append(case)
        with open(os.path.join(root, "spec.json"), "w") as f:
            json.dump({"train_argv": train_argv_, "predict_argv": predict_argv, "steps": steps,
                       "ports": [free_port() for _ in range(3)]}, f)
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--data-rank", str(r),
                                   root], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(DATA_N)]
        outs = []
        try:
            for proc in procs:
                outs.append(proc.communicate(timeout=900)[0])
        finally:
            for proc in procs:
                proc.kill()
        reports = []
        for r, (proc, out) in enumerate(zip(procs, outs)):
            tail = "\n".join(out.splitlines()[-40:])
            if proc.returncode != 0:
                raise AssertionError(f"data rank {r} exited {proc.returncode}:\n{tail}")
            want_line = f"distributed: rank {r} of {DATA_N} on cuda:0, backend gloo"
            if out.count(want_line) != 3:
                raise AssertionError(f"data rank {r}: not 3 lines '{want_line}' in its log:\n{tail}")
            with open(os.path.join(root, f"data_rank_{r}.json")) as f:
                reports.append(json.load(f))
            if reports[-1]["device"] != "cuda:0" or reports[-1]["train"]["device"] != "cuda:0":
                raise AssertionError(f"data rank {r} ran on {reports[-1]['device']}")

        # (a) the train CLI.
        label = f"train --num_processes {DATA_N}, 17 frames, B = {BATCH}"
        layers = SPATIAL_LAYERS + TEMPORAL_LAYERS
        entries = [report["train"] for report in reports]
        for r, entry in enumerate(entries):
            counts = entry["launches"]
            want = dict.fromkeys(counts, 0)
            want.update({name: layers * DATA_TRAIN_STEPS for name in TRAIN_KERNELS})
            want.update({name: layers for name in EVAL_KERNELS})  # one validation batch
            if counts != want:
                raise AssertionError(f"{label}, rank {r}: launches {counts}, expected {want} (phase "
                                     f"4's per step and per validation batch)")
            if entry["steps"] != DATA_TRAIN_STEPS or not all(
                    math.isfinite(e["train_loss"]) for e in entry["epochs"]):
                raise AssertionError(f"{label}, rank {r}: bad run {entry}")
            log(f"{label}, rank {r}: {entry['steps']} steps in {entry['seconds']:.3f} s (data, model "
                f"set-up and validation included); launches {counts}; epochs "
                f"{json.dumps(entry['epochs'])}")
        if [e["train_loss"] for e in entries[0]["epochs"]] != \
                [e["train_loss"] for e in entries[1]["epochs"]]:
            raise AssertionError(f"{label}: the ranks' losses differ")
        if entries[0]["digest"] != entries[1]["digest"]:
            raise AssertionError(f"{label}: the ranks' trained weights differ")
        # Each rank is given its own paths: only rank 0 writes the step
        # checkpoint, and the best model when an epoch is the best.
        best = any(e["is_best"] for e in entries[0]["epochs"])
        if best != os.path.exists(os.path.join(root, "best_0.pt")) or \
                os.path.exists(os.path.join(root, "best_1.pt")) or \
                len(os.listdir(os.path.join(root, "steps_0"))) != 1 or \
                os.path.exists(os.path.join(root, "steps_1")):
            raise AssertionError(f"{label}: the checkpoints were not written by rank 0 alone")
        log(f"{label}: both ranks' losses and trained weights equal bit for bit; the step "
            f"checkpoint{' and the best model' if best else ''} written by rank 0 alone")

        # (b) one step, two ranks against one process.
        saved = torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic
        _deterministic_convolutions()
        times = {}
        for case in steps:
            name = case["name"]
            label = f"train step {name}, {case['frames']} frames, B = {case['batch']}, dropout {DROPOUT}"
            if reports[0][name]["grad_digest"] != reports[1][name]["grad_digest"] or \
                    reports[0][name]["loss"] != reports[1][name]["loss"]:
                raise AssertionError(f"{label}: the ranks' all-reduced loss or gradients differ")
            ranks = torch.load(os.path.join(root, f"data_step_{name}.pt"))
            ranks = (ranks["loss"], {n: x.to(device) for n, x in ranks["grads"].items()})
            model, batch = _data_step_inputs(case, device)
            whole = _one_step(model, batch, criterion)
            halves = _halves_step(model, batch, criterion, device)
            # The ranks against one process on the same rows: the same
            # function, the parts summed in the same f32 order.
            same = float(ranks[0]) == float(halves[0]) and all(
                torch.equal(ranks[1][n], halves[1][n]) for n in halves[1])
            _compare_steps(label, f"{DATA_N} data ranks (all-reduced) vs one process on the same "
                           f"rows (bit for bit: {same})", ranks, halves, DATA_HALVES_LIMITS)
            # ... and against one process on the global batch.
            limits = FUSION_STEP_BF16 if name == "cacnf" else None
            trunk = {n for n in whole[1] if "appearance_branch.resnet." in n}
            if trunk:
                # R3D's bf16 convolutions run other cuDNN algorithms at B / 2
                # than at B (its features differ by rounding), and the
                # trunk's ReLU gates make its gradients follow: one process
                # on the two halves differs from itself on the whole batch.
                with torch.no_grad():
                    trunk_fwd = model.backbone.appearance_branch.resnet.forward_features
                    h = batch["valid"].shape[0] // DATA_N
                    feats = trunk_fwd(batch)
                    parts = torch.cat([trunk_fwd({k: v[i * h:(i + 1) * h] for k, v in batch.items()})
                                       for i in range(DATA_N)])
                own = {n: _rel(halves[1][n], whole[1][n]) for n in trunk}
                log(f"{label}: one process on the two halves vs on the global batch: the R3D "
                    f"features' max_abs_err {(feats.float() - parts.float()).abs().max().item():.3e}, "
                    f"the trunk's gradients relative norm up to {max(own.values()):.3e} (its worst "
                    + ", ".join(f"{n} {own[n]:.3e}" for n in sorted(own, key=own.get)[-3:])
                    + "); the trunk is held to one process on the same rows above")
                del feats, parts
            _compare_steps(label, f"{DATA_N} data ranks (all-reduced) vs one process on the global batch"
                           + (" (R3D trunk left out)" if trunk else ""),
                           (ranks[0], {n: g for n, g in ranks[1].items() if n not in trunk}),
                           (whole[0], {n: g for n, g in whole[1].items() if n not in trunk}), limits)
            del whole, halves, ranks
            torch.cuda.reset_peak_memory_stats()
            times[name] = {"ranks_ms": [report[name]["step_ms"] for report in reports],
                           "ranks_peak_bytes": [report[name]["peak_bytes"] for report in reports],
                           "one_process_ms": _step_ms(model, batch, criterion, steps=DATA_STEP_REPEATS),
                           "one_process_peak_bytes": torch.cuda.max_memory_allocated()}
            del model, batch
            torch.cuda.empty_cache()
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = saved

        # (c) serving.
        label = f"predict --num_processes {DATA_N}, 17 frames, {DATA_PREDICT_CLIPS} clips, B = {BATCH}"
        reset_all_launches()
        single = predict.main(predict_argv + ["--output", os.path.join(root, "predictions_one.jsonl")])
        batches = -(-DATA_PREDICT_CLIPS // BATCH)
        want = dict.fromkeys(all_launches(), 0)
        want.update({name: layers * batches for name in EVAL_KERNELS})
        for r, report in enumerate(reports):
            if report["predict"]["launches"] != want or report["predict"]["rows"] != len(single):
                raise AssertionError(f"{label}, rank {r}: {report['predict']}, expected {len(single)} "
                                     f"rows and launches {want}")
        with open(os.path.join(root, "predictions_0.jsonl")) as f:
            two = [json.loads(line) for line in f]
        if [row["video_id"] for row in two] != [row["video_id"] for row in single] or \
                len(single) != DATA_PREDICT_CLIPS or \
                os.path.exists(os.path.join(root, "predictions_1.jsonl")):
            raise AssertionError(f"{label}: the ranks' predictions are not the one process's clips "
                                 f"in its order, written by rank 0 alone")
        model = _served_model(ckpt, served_kw, position_table_rows(serve_cfg), device)
        loader = Loader(datasets_factory["layout"](serve_cfg), BATCH,
                        collaters_factory["layout"](serve_cfg), prefetch=0)
        batch = next(iter(to_device(loader, device)))
        with torch.inference_mode():
            want_logits = model({k: v for k, v in batch.items() if k not in ("labels", "valid")})["stlt"]
        got = torch.from_numpy(np.concatenate(
            [np.load(os.path.join(root, f"data_logits_{r}.npy")) for r in range(DATA_N)])).to(device)
        _check_logits(f"{label}, the first batch's rows of both ranks", got, want_logits.float(),
                      "one process")
        same_top1 = sum(a["top_k"][0]["label_id"] == b["top_k"][0]["label_id"]
                        for a, b in zip(two, single))
        log(f"{label}: {len(two)} rows in the one process's order; top-1 label equal in "
            f"{same_top1} of {len(two)}")
        del model, batch

        # (e) times.
        log("data_axis_times " + json.dumps({
            "card": card_line(), "steps": times,
            "allreduce_ms": [report["allreduce_ms"] for report in reports],
            "allreduce_bytes": reports[0]["allreduce_bytes"],
            "note": "two ranks share one card, the all-reduce staged through host memory (gloo): "
                    "no speed claim"}))
    return None


# --- phase 12 (d): each dropout kernel at a global-row base --------------------


def _base_run(make, call, sl, base, cot):
    """``call(rows, weights, sl, base)`` on fresh leaves ``make(sl)`` (the
    row-indexed inputs cut to ``sl`` and the weights), then its backward
    from ``cot``: (output, the row inputs' gradients, the weights'
    gradients)."""
    rows, weights = make(sl)
    out = call(rows, weights, sl, base)
    out.backward(cot)
    return out.detach(), [t.grad for t in rows], [t.grad for t in weights]


def _base_case(label, make, call, b, cot, dtype, row_rel, sum_rel):
    """One kernel family at base ``b`` (phase 12 (d)): the launch on rows
    [b:] at base b against rows [b:] of the launch at base 0 on the whole
    input, whose cotangent is zero on rows [:b] (so its weight gradients
    sum rows [b:] alone): the output within OP_TOL, each row input's
    gradient within ``row_rel`` and each weight gradient within ``sum_rel``
    in relative norm, bit-identity logged; then the launch at base b
    against its plain version at base b, the same limits. Returns a log
    row."""
    whole = cot.clone()
    whole[:b] = 0
    out0, rows0, weights0 = _base_run(make, call, slice(None), 0, whole)
    out1, rows1, weights1 = _base_run(make, call, slice(b, None), b, cot[b:])
    with plain_kernels():
        outp, rowsp, weightsp = _base_run(make, call, slice(b, None), b, cot[b:])
    row = {"case": label, "dtype": str(dtype).replace("torch.", ""), "base": b}
    for against, (o, rg, wg) in (("base 0 sliced", (out0[b:], [g[b:] for g in rows0], weights0)),
                                 ("plain at base b", (outp, rowsp, weightsp))):
        tol = OP_TOL[dtype]
        err = (out1.float() - o.float()).abs()
        if not torch.isfinite(out1).all() or (err > tol["atol"] + tol["rtol"] * o.float().abs()).any():
            raise AssertionError(f"{label} {dtype} at base {b}: output off by {err.max().item():.3e} "
                                 f"against {against}")
        rels = [_rel(x, y) for x, y in zip(rows1, rg)]
        sums = [_rel(x, y) for x, y in zip(weights1, wg)]
        if max(rels, default=0.0) > row_rel or max(sums, default=0.0) > sum_rel:
            raise AssertionError(f"{label} {dtype} at base {b} against {against}: row gradients "
                                 f"{rels} (limit {row_rel}), summed gradients {sums} (limit {sum_rel})")
        key = "sliced" if against.startswith("base 0") else "plain"
        row[key] = {"max_abs_err": err.max().item(), "row_grad_rel": max(rels, default=0.0),
                    "sum_grad_rel": max(sums, default=0.0)}
        if key == "sliced":
            row[key]["bit_identical"] = bool(torch.equal(out1, o)) and all(
                torch.equal(x, y) for x, y in zip(rows1, rg))
    log("base_check " + json.dumps(row))
    return row


def check_base_kernels(device):
    """Phase 12 (d): every dropout kernel at a global-row base, bf16 and f32,
    dropout 0.1, at the main paths' shapes with a data rank's base (rank 1
    of 2): rows 3 and 4 (the train sublayer) at the spatial stage of 64
    clips (rows 1,088, T = 8, ragged ``rows_live``, base 544 rows) and the
    temporal one (64 rows of 17 frames, base 32); rows 6 and 7 at 32 clips
    of 257 frames (base 16); rows 8 and 9-10 at 16 clips of 513 frames in
    the lengths mode and the dense-bias mode (base 8); rows 11-14 (the fused
    train tail) at 32 clips of 257 temporal tokens (base 16 clips: token
    4,112). Row 5 is the eval cross-attention: no dropout, no base (the
    train cross-attention runs on rows 6-10). ``_base_case`` per family."""
    from stlt_tpu_torch.ops import flash
    from stlt_tpu_torch.ops import fused_encoder as fe
    from stlt_tpu_torch.ops import fused_tail_train as ftt

    gen = torch.Generator().manual_seed(SEED + 40)
    w = make_weights(gen, device)
    seed = 0x5EED5EED
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        proj_rel = PROJ_BWD_REL if dtype == torch.bfloat16 else GRAD_REL[torch.float32]
        for stage, clips in (("spatial", BATCH), ("temporal", BATCH)):
            x, _, bias, live_kw, _, _ = make_stage(stage, clips, dtype, gen, device)
            rows_live = live_kw.get("rows_live")
            per_clip = x.shape[0] // clips
            b = clips // 2 * per_clip
            g = torch.randn(x.shape, generator=gen).to(device, dtype)
            if rows_live is not None:
                g[~rows_live] = 0

            def make(sl, x=x):
                in_proj = w["wqkv"].t().contiguous().requires_grad_()
                wo = w["wo"].t().contiguous().requires_grad_()
                return [x[sl].detach().clone().requires_grad_()], [
                    in_proj, w["bqkv"].clone().requires_grad_(), wo, w["bo"].clone().requires_grad_()]

            def call(r, ws, sl, base, bias=bias, rows_live=rows_live, dtype=dtype):
                return fe.fused_proj_attention_train(
                    r[0], ws[0].t(), ws[1], ws[2].t(), ws[3], bias[sl], seed, num_heads=HEADS,
                    dropout_rate=DROPOUT, compute_dtype=dtype,
                    rows_live=None if rows_live is None else rows_live[sl], row0=base)

            rows.append(_base_case(f"rows 3-4 {stage} rows={x.shape[0]} T={x.shape[1]}", make, call, b,
                                   g, dtype, proj_rel, proj_rel))
        attn_rel = BWD_REL[dtype]
        for clips, T, mode in ((LONG_TRAIN[256][0], 257, "short"), (LONG_TRAIN[512][0], 513, "lengths"),
                               (LONG_TRAIN[512][0], 513, "dense")):
            q, k, v = make_heads(clips, T, dtype, gen, device)
            lengths = ragged_lengths(clips, T, gen)
            bias = _causal_padding_bias(lengths, T, device) if mode == "dense" else None
            lengths = lengths.to(device)
            g = torch.randn(q.shape, generator=gen).to(device, dtype)
            g[torch.arange(T, device=device)[None, :] >= lengths[:, None]] = 0

            def make(sl, q=q, k=k, v=v):
                return [t[sl].detach().clone().requires_grad_() for t in (q, k, v)], []

            def call(r, ws, sl, base, lengths=lengths, bias=bias, mode=mode):
                kw = (dict(bias=bias[sl]) if mode == "dense"
                      else dict(kv_lengths=lengths[sl], causal=True))
                return flash.flash_attention(*r, dropout_seed=seed, dropout_rate=DROPOUT,
                                             dropout_row0=base, **kw)

            rows.append(_base_case(f"rows {'6-7' if T < 513 else '8-10'} {mode} B={clips} T={T}", make,
                                   call, clips // 2, g, dtype, attn_rel, attn_rel))
        clips, T = LONG_TRAIN[256][0], 257
        x = torch.randn((clips, T, H), generator=gen).to(device, dtype)
        a = (0.5 * torch.randn((clips, T, H), generator=gen)).to(device, dtype)
        live = torch.arange(T)[None, :] < ragged_lengths(clips, T, gen)[:, None]
        live = live.to(device)
        g = torch.randn((clips, T, H), generator=gen).to(device, dtype)

        def make(sl, x=x, a=a):
            return ([t[sl].detach().clone().requires_grad_() for t in (x, a)],
                    [t.clone().requires_grad_() for t in _tail_weights(w)])

        def call(r, ws, sl, base, live=live, dtype=dtype):
            return ftt.fused_layer_tail_train(
                *r, *ws, eps=EPS, compute_dtype=dtype, activation="gelu",
                gelu_approximate=dtype == torch.bfloat16, dropout_rate=DROPOUT, seed=seed,
                tokens_live=live[sl], token0=base * T)

        rows.append(_base_case(f"rows 11-14 B={clips} T={T}", make, call, clips // 2, g, dtype,
                               TAIL_BWD_REL[dtype], TAIL_SUM_REL[dtype]))
        del x, a, g, q, k, v
        torch.cuda.empty_cache()
    log(f"base_checks: {len(rows)} cases, every kernel at its base equal to the slice of its launch "
        f"at base 0 and to its plain version at that base; bit-identical to the slice: "
        f"{sum(r['sliced']['bit_identical'] for r in rows)} of {len(rows)}")
    return rows + check_map_kernels(device)


# The strided map of phase 12 (d): rank (data 1, context 1) of a grid of
# rings of C = 2 at 514 frame slots, 3 clips a data rank: the rank's
# (clip, frame) rows are frames [257, 514) of clips [3, 6), the global row
# of its local row i (i // 257) * 514 + 514 * 3 + 257 + i % 257.
MAP_CLIPS, MAP_FRAMES, MAP_PERIOD = 6, 514, 257
MAP_OFFSET = MAP_FRAMES * 3 + MAP_PERIOD


def _map_rows(device):
    """The rank's rows of the whole batch's MAP_CLIPS * MAP_FRAMES rows,
    in its local order."""
    clips = torch.arange(3, MAP_CLIPS, device=device)[:, None]
    return (clips * MAP_FRAMES + MAP_PERIOD + torch.arange(MAP_PERIOD, device=device)[None, :]).reshape(-1)


def _map_case(label, run, whole, idx, rank_map, dtype):
    """``run(inputs, map)`` -> the kernels' outputs, each indexed by row;
    the rank's launch (rows ``idx`` of the inputs ``whole`` at
    ``rank_map``) against rows ``idx`` of the launch on ``whole`` at the
    affine map 0, bit for bit, then against its plain version at the map
    (OP_TOL). Returns a log row."""
    from stlt_tpu_torch.ops.dropout import RowMap

    outs0 = run(whole, RowMap())
    part = [x[idx] for x in whole]
    outs1 = run(part, rank_map)
    with plain_kernels():
        outsp = run(part, rank_map)
    equal = [bool(torch.equal(a, b[idx])) for a, b in zip(outs1, outs0)]
    tol = OP_TOL[dtype]
    errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(outs1, outsp)]
    ok = all((a.float() - b.float()).abs().le(tol["atol"] + tol["rtol"] * b.float().abs()).all()
             for a, b in zip(outs1, outsp))
    row = {"case": label, "dtype": str(dtype).replace("torch.", ""), "map": list(rank_map),
           "bit_identical": equal, "plain_max_abs_err": errs}
    log("map_check " + json.dumps(row))
    if not all(equal):
        raise AssertionError(f"{label} {dtype} at the map {tuple(rank_map)}: not bit-identical to the "
                             f"whole launch's rows ({equal})")
    if not ok:
        raise AssertionError(f"{label} {dtype} at the map {tuple(rank_map)}: off its plain version "
                             f"by {errs}")
    return row


def check_map_kernels(device):
    """Phase 12 (d), the strided map (a ring rank's frame rows under a
    data axis): rows 3 and 4 at the spatial stage (rows of 8 tokens) and
    rows 11-13 at the spatial tail's tokens (the map times 8) and the
    temporal tail's (the map itself: rows of one token), bf16 and f32,
    dropout 0.1: the rank's launch on its rows of MAP_CLIPS clips of
    MAP_FRAMES slots against the matching rows of one launch over the whole
    batch, bit for bit (rows 3 and 4: the output and the backward kernel's
    dqkv; the tail: its output and the input gradients dx and dattn, which
    rows 12 and 13 write), and against its plain version at the map.
    ``map_check`` lines."""
    from stlt_tpu_torch.ops import fused_encoder as fe
    from stlt_tpu_torch.ops import fused_tail_train as ftt
    from stlt_tpu_torch.ops.dropout import RowMap

    gen = torch.Generator().manual_seed(SEED + 41)
    w = make_weights(gen, device)
    seed = 0x5EED5EED
    rank_map = RowMap(MAP_OFFSET, MAP_PERIOD, MAP_FRAMES)
    idx = _map_rows(device)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        x, attn, bias, live_kw, _, _ = make_stage("spatial", MAP_CLIPS, dtype, gen, device,
                                                  frames=MAP_FRAMES)
        rows_live = live_kw["rows_live"]
        g = torch.randn(x.shape, generator=gen).to(device, dtype)
        # The weights as the model passes them: in_proj_weight.t(), out_proj.weight.t().
        wqkv, wo = (w[k].t().contiguous().to(dtype).t() for k in ("wqkv", "wo"))
        kw = dict(num_heads=HEADS, compute_dtype=dtype, dropout_rate=DROPOUT)

        def run_proj(inp, m, kw=kw, wqkv=wqkv, wo=wo):
            x_, bias_, live_, g_ = inp
            out = fe._launch_proj("fused_proj_attention_train", x_, wqkv, w["bqkv"], wo, w["bo"],
                                  bias_, seed=seed, rows_live=live_, row0=m, **kw)
            dqkv = fe._launch_proj_bwd(x_, wqkv, w["bqkv"], wo, bias_, g_, seed, rows_live=live_,
                                       row0=m, **kw)[0]
            return [out, dqkv]

        rows.append(_map_case(f"rows 3-4 spatial rows={x.shape[0]} T={x.shape[1]}", run_proj,
                              [x, bias, rows_live, g], idx, rank_map, dtype))
        tail_live = rows_live[:, None].expand(x.shape[0], x.shape[1])
        for stage, inputs, per in (
                ("spatial", [x, attn, tail_live, g], NUM_BOXES),
                ("temporal", [x[:, :1], attn[:, :1], rows_live[:, None], g[:, :1]], 1)):

            def run_tail(inp, m, per=per, dtype=dtype):
                x_, a_, l_, g_ = (t.detach().clone() for t in inp)
                x_.requires_grad_()
                a_.requires_grad_()
                y = ftt.fused_layer_tail_train(
                    x_, a_, *_tail_weights(w), eps=EPS, compute_dtype=dtype, activation="gelu",
                    gelu_approximate=dtype == torch.bfloat16, dropout_rate=DROPOUT, seed=seed,
                    tokens_live=l_, token0=m.scaled(per))
                y.backward(g_)
                return [y.detach(), x_.grad, a_.grad]

            label = f"rows 11-13 {stage} tail tokens={inputs[0].shape[0] * per}"
            rows.append(_map_case(label, run_tail, inputs, idx, rank_map, dtype))
        del x, attn, g
        torch.cuda.empty_cache()
    log(f"map_checks: {len(rows)} cases at the map {tuple(rank_map)}, every launch bit-identical to "
        f"the whole launch's rows and within its plain version's limits")
    return rows


# --- phase 13: the data axis under the ring ------------------------------------


GRID_D, GRID_C = 2, RING_C  # two rings of two ranks, all four on this one card (gloo)
GRID_WORLD = GRID_D * GRID_C
GRID_FRAMES = 512  # 514 slots: 257 frames a rank
GRID_TRAIN_BATCH = LONG_TRAIN[512][0]  # 16 global clips: 8 a ring
GRID_PREDICT_BATCH = LONG_CLIPS[512][0]  # 32 global clips
GRID_STEP_REPEATS = 3  # timed steps of each rank
GRID_PORTS = ("train", "predict")  # the two process groups of each rank, in order


def _grid_part(batch, mesh):
    """The rows of ``batch`` (a global batch) of this rank's data index,
    with the global valid count (``loader.VALID_TOTAL``) where the batch has
    ``valid``."""
    from stlt_tpu_torch.data.loader import VALID_TOTAL
    from stlt_tpu_torch.parallel.distributed import process_row_span

    lo, hi = process_row_span(mesh, batch["lengths"].shape[0])
    part = {k: v[lo:hi] for k, v in batch.items()}
    if "valid" in batch:
        part[VALID_TOTAL] = batch["valid"].sum()
    return part


def _timed_sum(params, mesh, group, loss=None) -> float:
    """Mean wall ms of ``sum_grads_over_ring_`` over ``group`` on the
    gradients as they stand (repeated, the sums not kept)."""
    from stlt_tpu_torch.training.loop import sum_grads_over_ring_

    params = list(params)
    saved = [p.grad.clone() for p in params if p.grad is not None]
    times = []
    for _ in range(GRID_STEP_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sum_grads_over_ring_(params, mesh, loss, group=group)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        for p, g in zip((p for p in params if p.grad is not None), saved):
            p.grad.copy_(g)
    return float(np.median(times))


def grid_rank(rank: int, workdir: str) -> int:
    """One rank of phase 13 (``chip_smoke.py --grid-rank R WORKDIR``), rank R
    of a grid of GRID_D rings of GRID_C ranks: (a) ``train --num_processes 4
    --context_parallel 2`` (launch counts, epoch records, a digest of the
    trained weights); then under one more process group (c) ``predict`` on
    the grid (rows, launch counts) and the first batch's logits of this
    rank's rows, (b) one step at dropout 0 from the seeded weights on this
    rank's rows of the global batch, its gradients summed over the ring and
    then over the data group (``training/loop.loss_and_grads``), and (d) the
    step time at dropout 0.1, the two all-reduces' times and the peak
    memory. Writes ``grid_rank_R.json``, ``grid_rank_R_logits.npy`` and
    (rank 0) ``grid_rank_0_step.pt``."""
    from stlt_tpu_torch import predict
    from stlt_tpu_torch import train as port_train
    from stlt_tpu_torch.configs import DataConfig, position_table_rows
    from stlt_tpu_torch.parallel.mesh import active_data_mesh
    from stlt_tpu_torch.parser import build_parser
    from stlt_tpu_torch.training.criterion import make_criterion
    from stlt_tpu_torch.training.loop import loss_and_grads, step_generator

    with open(os.path.join(workdir, "grid.json")) as f:
        spec = json.load(f)
    process = ["--num_processes", str(GRID_WORLD), "--process_id", str(rank)]
    report = {"rank": rank}
    reset_all_launches()
    t0 = time.perf_counter()
    result = port_train.main(spec["train_argv"] + process + [
        "--coordinator_address", f"localhost:{spec['ports']['train']}",
        "--save_model_path", os.path.join(workdir, f"best_{rank}.pt")])
    torch.cuda.synchronize()
    report["train"] = {"seconds": time.perf_counter() - t0, "launches": all_launches(),
                       "steps": result.step, "epochs": result.epochs,
                       "digest": _digest(result.model.parameters())}
    del result
    torch.cuda.empty_cache()

    parser = build_parser("chip_smoke grid rank")
    parser.add_argument("--top_k", type=int, default=5)
    parser.add_argument("--output", type=str)
    args = parser.parse_args(spec["predict_argv"] + process + [
        "--coordinator_address", f"localhost:{spec['ports']['predict']}"])
    predict.check_flags(args)
    device = predict.start_processes(args)
    report["device"] = str(device)
    criterion = make_criterion("something")
    try:
        mesh = active_data_mesh()
        reset_all_launches()
        rows = predict.serve(args, device)
        torch.cuda.synchronize()
        report["predict"] = {"rows": len(rows), "launches": all_launches()}
        data_cfg = DataConfig(dataset_name="something", dataset_path=args.test_dataset_path,
                              labels_path=args.labels_path, videoid2size_path=args.videoid2size_path,
                              layout_num_frames=GRID_FRAMES, frames_multiple=GRID_C)
        model = _served_model(args.checkpoint_path, spec["model_kw"], position_table_rows(data_cfg),
                              device)
        _, batch = _first_batch(data_cfg, GRID_PREDICT_BATCH, device)
        with torch.inference_mode():
            logits = model(_grid_part(batch, mesh))["stlt"]
        np.save(os.path.join(workdir, f"grid_rank_{rank}_logits.npy"), logits.float().cpu().numpy())
        del model, batch

        paths = spec["train_paths"]
        model = _ring_train_model(GRID_FRAMES, 0.0, device)
        batch = _ring_train_batch(paths, GRID_FRAMES, GRID_TRAIN_BATCH, device, train=False)
        model.zero_grad(set_to_none=True)
        loss = loss_and_grads(model, criterion, _grid_part(batch, mesh), step_generator(SEED, 0))
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.grad is not None}
        report["step_loss"] = loss.item()
        report["grad_digest"] = _digest(grads.values())
        if rank == 0:
            torch.save({"loss": loss.item(), "grads": grads},
                       os.path.join(workdir, "grid_rank_0_step.pt"))
        del model, batch, grads

        model = _ring_train_model(GRID_FRAMES, DROPOUT, device)
        batch = _grid_part(_ring_train_batch(paths, GRID_FRAMES, GRID_TRAIN_BATCH, device,
                                             train=True), mesh)
        torch.cuda.reset_peak_memory_stats()
        report["step_ms"] = _step_ms(model, batch, criterion, steps=GRID_STEP_REPEATS)
        report["peak_bytes"] = torch.cuda.max_memory_allocated()
        # The two all-reduces of a step, on its last gradients: the
        # backbone's over the ring, then every gradient and the loss over
        # the data group.
        loss = torch.zeros((), device=device)
        report["ring_sum_ms"] = _timed_sum(model.backbone.parameters(), mesh, mesh.ring_group)
        report["data_sum_ms"] = _timed_sum(model.parameters(), mesh, mesh.data_group, loss)
        report["ring_sum_bytes"] = 4 * sum(p.numel() for p in model.backbone.parameters())
        report["data_sum_bytes"] = 4 * (sum(p.numel() for p in model.parameters()) + 1)
        del model, batch
        torch.cuda.empty_cache()
    finally:
        predict.stop_processes()
    with open(os.path.join(workdir, f"grid_rank_{rank}.json"), "w") as f:
        json.dump(report, f)
    return 0


def run_grid_path(device):
    """Phase 13: STLT on a grid of GRID_D rings of GRID_C ranks (``--num_processes
    4 --context_parallel 2``), the four rank processes on this one card
    (gloo), at full width (H = 768, 12 heads, 4 + 8 layers, bf16) and 512
    layout frames (514 slots):

    (a) ``train``, one epoch of two AdamW steps (global B = 16) and one
        validation batch: each rank's backend line and device, the four
        ranks' losses and trained weights equal bit for bit, the checkpoint
        written by rank 0 alone, each rank's launches (``ring_train_launches``:
        rows 3, 4, 8 and 9-10 in ring-offset mode and 11-14);
    (b) one step at dropout 0 from the seeded weights: the four ranks'
        gradients (the backbone's summed over the ring, then every one over
        the data group) equal bit for bit and within phase 10's one-step
        limits of one process's on the global batch;
    (c) ``predict`` on the grid (B = 32, clips of 32-513 frames): rank 0's
        predictions of every clip, each rank's launches per forward (phase
        9's), each ring's two ranks' logits of their rows equal, and the
        rings' rows joined within LOGITS_ATOL of one process's;
    (d) the ``grid_times`` line: each rank's step ms at dropout 0.1, its two
        all-reduces' ms and its peak memory, beside the card line (four
        ranks share one card: no speed claim)."""
    import socket

    from stlt_tpu_torch.configs import DataConfig, make_model_config, position_table_rows
    from stlt_tpu_torch.models import models_factory
    from stlt_tpu_torch.training.criterion import make_criterion

    def free_port():
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            return sock.getsockname()[1]

    model_kw = dict(num_classes=NUM_CLASSES, unique_categories=4, hidden_size=H,
                    num_attention_heads=HEADS, num_spatial_layers=SPATIAL_LAYERS,
                    num_temporal_layers=TEMPORAL_LAYERS, compute_dtype="bfloat16")
    with tempfile.TemporaryDirectory(prefix="stlt_chip_smoke_grid_") as root:
        train_root, predict_root = os.path.join(root, "train"), os.path.join(root, "predict")
        os.makedirs(train_root)
        os.makedirs(predict_root)
        train_clips = GRID_TRAIN_BATCH * RING_TRAIN_STEPS
        paths = write_something_dataset(train_root, train_clips + GRID_TRAIN_BATCH, SEED + 51,
                                        num_used=TRAIN_LABELS, frames_range=(32, 513))
        split = _split_dataset(paths, train_root, train_clips)
        train_paths = {**split, "labels": paths["labels"], "videoid2size": paths["videoid2size"]}
        served = write_something_dataset(predict_root, GRID_PREDICT_BATCH, SEED + 52,
                                         frames_range=(32, 513))
        data_cfg = DataConfig(dataset_name="something", dataset_path=served["dataset"],
                              labels_path=served["labels"], videoid2size_path=served["videoid2size"],
                              layout_num_frames=GRID_FRAMES, frames_multiple=GRID_C)
        table_rows = position_table_rows(data_cfg)
        model = models_factory["stlt"](make_model_config("stlt", **model_kw, layout_num_frames=table_rows),
                                       torch.Generator().manual_seed(SEED + 53))
        ckpt = os.path.join(predict_root, "stlt_random.pt")
        torch.save(model.state_dict(), ckpt)
        del model
        out_path = os.path.join(predict_root, "predictions.jsonl")
        spec = {"ports": {name: free_port() for name in GRID_PORTS}, "model_kw": model_kw,
                "train_paths": train_paths,
                "train_argv": _ring_train_argv(split, paths, GRID_FRAMES, GRID_TRAIN_BATCH),
                "predict_argv": _ring_argv(served, ckpt, GRID_FRAMES, GRID_PREDICT_BATCH, out_path)}
        with open(os.path.join(root, "grid.json"), "w") as f:
            json.dump(spec, f)
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--grid-rank", str(r),
                                   root], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(GRID_WORLD)]
        outs = []
        try:
            for proc in procs:
                outs.append(proc.communicate(timeout=900)[0])
        finally:
            for proc in procs:
                proc.kill()
        for r, (proc, out) in enumerate(zip(procs, outs)):
            tail = "\n".join(out.splitlines()[-40:])
            if proc.returncode != 0:
                raise AssertionError(f"grid rank {r} exited {proc.returncode}:\n{tail}")
            want_line = f"distributed: rank {r} of {GRID_WORLD} on cuda:0, backend gloo"
            if out.count(want_line) != len(GRID_PORTS):
                raise AssertionError(f"grid rank {r}: not {len(GRID_PORTS)} lines '{want_line}' in "
                                     f"its log:\n{tail}")
        reports = []
        for r in range(GRID_WORLD):
            with open(os.path.join(root, f"grid_rank_{r}.json")) as f:
                reports.append(json.load(f))
            if reports[-1]["device"] != "cuda:0":
                raise AssertionError(f"grid rank {r} ran on {reports[-1]['device']}")

        # (a) train on the grid.
        label = (f"train --num_processes {GRID_WORLD} --context_parallel {GRID_C}, {GRID_FRAMES} "
                 f"frames, B = {GRID_TRAIN_BATCH}")
        want = ring_train_launches(GRID_FRAMES, RING_TRAIN_STEPS)
        for r, report in enumerate(reports):
            entry = report["train"]
            counts = entry["launches"]
            if counts != {name: want.get(name, 0) for name in counts}:
                raise AssertionError(f"{label}, rank {r}: launches {counts}, expected {want}")
            if entry["steps"] != RING_TRAIN_STEPS or not all(
                    math.isfinite(e["train_loss"]) for e in entry["epochs"]):
                raise AssertionError(f"{label}, rank {r}: bad run {entry}")
            log(f"{label}, rank {r} (data {r // GRID_C}, context {r % GRID_C}): {entry['steps']} steps "
                f"in {entry['seconds']:.3f} s (data, model set-up and validation included); launches "
                f"{counts}; epochs {json.dumps(entry['epochs'])}")
        losses = [[e["train_loss"] for e in report["train"]["epochs"]] for report in reports]
        if any(x != losses[0] for x in losses):
            raise AssertionError(f"{label}: the ranks' losses differ: {losses}")
        digests = {report["train"]["digest"] for report in reports}
        if len(digests) != 1:
            raise AssertionError(f"{label}: the ranks' trained weights differ ({len(digests)} digests)")
        written = [r for r in range(GRID_WORLD) if os.path.exists(os.path.join(root, f"best_{r}.pt"))]
        if written != [0]:
            raise AssertionError(f"{label}: checkpoints written by ranks {written}, not by rank 0 alone")
        log(f"{label}: the {GRID_WORLD} ranks' losses {losses[0]} and trained weights equal bit for "
            f"bit; rank 0 alone wrote the checkpoint")

        # (b) one step at dropout 0 against one process on the global batch.
        criterion = make_criterion("something")
        step_label = f"train step {GRID_FRAMES} frames, B = {GRID_TRAIN_BATCH}, dropout 0"
        if len({report["grad_digest"] for report in reports}) != 1:
            raise AssertionError(f"{step_label}: the {GRID_WORLD} ranks' summed gradients differ")
        grid = torch.load(os.path.join(root, "grid_rank_0_step.pt"))
        model = _ring_train_model(GRID_FRAMES, 0.0, device)
        batch = _ring_train_batch(train_paths, GRID_FRAMES, GRID_TRAIN_BATCH, device, train=False)
        loss, grads = _one_step(model, batch, criterion)
        _compare_steps(step_label, f"{GRID_D} x {GRID_C} grid (summed over the ring, then the data "
                                   f"group; equal on all {GRID_WORLD} ranks) vs one process",
                       (grid["loss"], {n: x.to(device) for n, x in grid["grads"].items()}), (loss, grads))
        del model, batch, grads, grid

        # (c) predict on the grid.
        plabel = f"predict on the grid, {GRID_FRAMES} frames, B = {GRID_PREDICT_BATCH}"
        with open(out_path) as f:
            written_rows = sum(1 for _ in f)
        if written_rows != GRID_PREDICT_BATCH:
            raise AssertionError(f"{plabel}: {written_rows} predictions written, not {GRID_PREDICT_BATCH}")
        per_forward = {"blockwise_attention_offsets": TEMPORAL_LAYERS * GRID_C,
                       "fused_proj_attention": SPATIAL_LAYERS,
                       "fused_layer_tail": SPATIAL_LAYERS + TEMPORAL_LAYERS}
        for r, report in enumerate(reports):
            run = report["predict"]
            counts = run["launches"]
            if counts != {name: per_forward.get(name, 0) for name in counts} or \
                    run["rows"] != GRID_PREDICT_BATCH:
                raise AssertionError(f"{plabel}, rank {r}: {run['rows']} rows, launches {counts}, "
                                     f"expected {per_forward} (one forward)")
        logits = [np.load(os.path.join(root, f"grid_rank_{r}_logits.npy")) for r in range(GRID_WORLD)]
        for d in range(GRID_D):
            ring = logits[d * GRID_C:(d + 1) * GRID_C]
            if any(not np.array_equal(x, ring[0]) for x in ring):
                raise AssertionError(f"{plabel}: ring {d}'s ranks' logits differ")
        got = torch.from_numpy(np.concatenate(logits[::GRID_C])).to(device)
        model = _served_model(ckpt, model_kw, table_rows, device)
        _, batch = _first_batch(data_cfg, GRID_PREDICT_BATCH, device)
        with torch.inference_mode():
            single = model(batch)["stlt"].float()
        _check_logits(f"{plabel}, the rings' rows joined", got, single, "one process")
        del model, batch

        # (d) times.
        log("grid_times " + json.dumps({
            "card": card_line(),
            "ranks": [{k: report[k] for k in ("rank", "step_ms", "ring_sum_ms", "data_sum_ms",
                                              "peak_bytes")} for report in reports],
            "ring_sum_bytes": reports[0]["ring_sum_bytes"],
            "data_sum_bytes": reports[0]["data_sum_bytes"],
            "note": "four ranks share one card, the ring and both sums staged through host memory "
                    "(gloo): no speed claim"}))
    return None


# --- phase 14: the fusion models under the ring ---------------------------------


# (a)'s runs: (label, model, layout frames, batch), one batch each: CACNF at
# 512 layout frames (FUSION_RUNS[512]: B = 16, the frame axis 513 -> 514),
# LCF and CAF at 16 (B = 32, 17 -> 18 frames, 9 a rank).
FUSION_RING_SERVE = (("cacnf 512", "cacnf", 512, 16), ("lcf 16", "lcf", 16, 32),
                     ("caf 16", "caf", 16, 32))
FUSION_RING_FRAMES = 512  # (b)-(d): CACNF at FUSION_TRAIN[512], B = 16
FUSION_GRID_FRAMES = 16  # (e): CACNF on GRID_D rings of RING_C ranks, B = 32
FUSION_RING_STEP_REPEATS = 2  # timed steps of each rank and of the one process
FUSION_RING_PORTS = ("train", "serve")


def _on_the_ring(counts: dict, frames: int, train: bool = False) -> dict:
    """``counts`` (the launches of one forward, or train step, of a fusion
    model in one process) with the layout branch's temporal encoder on the
    ring: each of its TEMPORAL_LAYERS attentions RING_C ring-offset launches
    (and in training as many of the ring-offset backward) in place of its
    one-process kernel."""
    out = dict(counts)
    if frames >= _BLOCKWISE_FRAMES:
        out["blockwise_attention"] -= TEMPORAL_LAYERS
        if train:
            out["blockwise_attention_bwd"] -= TEMPORAL_LAYERS
    else:
        out["fused_proj_attention_train" if train else "fused_proj_attention"] -= TEMPORAL_LAYERS
        if train:
            out["fused_proj_attention_train_bwd"] -= TEMPORAL_LAYERS
    out["blockwise_attention_offsets"] = out.get("blockwise_attention_offsets", 0) + \
        TEMPORAL_LAYERS * RING_C
    if train:
        out["blockwise_attention_bwd_offsets"] = out.get("blockwise_attention_bwd_offsets", 0) + \
            TEMPORAL_LAYERS * RING_C
    return out


def fusion_ring_train_launches(frames: int, steps: int) -> dict:
    """The launches of one ``train --context_parallel 2`` run of CACNF on each
    rank: ``steps`` train steps and one validation batch, the layout
    branch's temporal encoder on the ring (``_on_the_ring``), the fusion
    blocks, the appearance branch and the heads as in one process."""
    return _added(_scaled(_on_the_ring(fusion_train_launches("cacnf", frames), frames, True), steps),
                  _on_the_ring(fusion_launches("cacnf", frames), frames))


def _fusion_predict_argv(name, test_path, paths, videos, ckpt, frames, batch_size):
    return [
        "--dataset_name", "something", "--dataset_type", "multimodal", "--model_name", name,
        "--test_dataset_path", test_path, "--labels_path", paths["labels"],
        "--videoid2size_path", paths["videoid2size"], "--videos_path", videos,
        "--checkpoint_path", ckpt, "--hidden_size", str(FUSION_MODEL["hidden_size"]),
        "--num_attention_heads", str(FUSION_MODEL["num_attention_heads"]),
        "--num_spatial_layers", str(SPATIAL_LAYERS), "--num_temporal_layers", str(TEMPORAL_LAYERS),
        "--num_appearance_layers", str(APPEARANCE_LAYERS), "--num_fusion_layers", str(FUSION_LAYERS),
        "--resnet_depth", str(FUSION_MODEL["resnet_depth"]),
        "--appearance_num_frames", str(APPEARANCE_FRAMES), "--layout_num_frames", str(frames),
        "--batch_size", str(batch_size), "--compute_dtype", FUSION_MODEL["compute_dtype"],
        "--use_pallas", "--num_workers", "8",
    ]


def _fusion_data_cfg(run: dict, train: bool = False):
    """The data config of a phase 14 run (``run``: its paths, videos and
    layout frames), the frame axis padded to a multiple of RING_C as the
    ring's CLIs pad it."""
    from stlt_tpu_torch.configs import DataConfig

    return DataConfig(dataset_name="something", dataset_path=run["train" if train else "test"],
                      labels_path=run["labels"], videoid2size_path=run["videoid2size"],
                      videos_path=run["videos"], layout_num_frames=run["frames"],
                      appearance_num_frames=APPEARANCE_FRAMES, device_normalize=train, train=train,
                      frames_multiple=RING_C)


def _fusion_ring_step_inputs(run: dict, dropout: float, device, batch=None):
    """(c)'s seeded full-width bf16 CACNF in train mode (FrozenBatchNorm
    frozen as ``make_optimizer`` freezes it) and ``batch``, by default the
    first train batch of ``run``. At a nonzero dropout the layout branch's temporal attention
    drops nothing: it is the one site on the ring, whose bits are the
    ring's own (``ops/ring.py``), so one process cannot draw them; every
    other site drops at ``dropout``."""
    from stlt_tpu_torch.configs import make_model_config, position_table_rows
    from stlt_tpu_torch.data import collaters_factory, datasets_factory
    from stlt_tpu_torch.data.loader import Loader, to_device
    from stlt_tpu_torch.models import models_factory
    from stlt_tpu_torch.training.optimizer import frozen_stats_mask

    data_cfg = _fusion_data_cfg(run, train=True)
    cfg = make_model_config("cacnf", **FUSION_MODEL, hidden_dropout_prob=dropout,
                            layout_num_frames=position_table_rows(data_cfg))
    model = models_factory["cacnf"](cfg, torch.Generator().manual_seed(SEED + 61))
    trainable = frozen_stats_mask(model)
    for n, p in model.named_parameters():
        p.requires_grad_(trainable[n])
    for layer in model.backbone.layout_branch.transformer.layers:
        layer.self_attn.dropout_rate = 0.0
    if batch is None:
        loader = Loader(datasets_factory["multimodal"](data_cfg), run["batch"],
                        collaters_factory["multimodal"](data_cfg), prefetch=0, workers=8)
        batch = next(iter(to_device(loader, device)))
    return model.to(device).train(), batch


def fusion_ring_rank(rank: int, workdir: str) -> int:
    """One rank of phase 14 (``chip_smoke.py --fusion-ring-rank R WORKDIR``),
    rank R of a ring of RING_C on this card: (b) ``train --num_processes 2
    --context_parallel 2`` of CACNF at FUSION_RING_FRAMES (launch counts,
    epoch records, a digest of the trained weights); then under one more
    process group (a) ``predict.serve`` of each FUSION_RING_SERVE run (rows,
    launch counts) and its first batch's logits; (c) one step of the seeded
    CACNF at dropout 0, first with the convolutions' algorithms timed as
    before the ring fixed them (``cudnn.benchmark``: the replicated
    gradients' digest), then as ``predict.set_conv_algorithms`` sets them
    under a ring, and one at dropout 0.1, each step's loss and gradients
    (saved by rank 0, a digest on both); (d) the step's wall ms under both
    settings, the ring sum's and the gather's ms and bytes and the peak
    memory. Writes ``fusion_ring_R.json`` and ``fusion_ring_R_*.npz`` /
    ``fusion_ring_0_step*.pt`` to WORKDIR."""
    from stlt_tpu_torch import predict
    from stlt_tpu_torch import train as port_train
    from stlt_tpu_torch.ops.ring import gather_frames
    from stlt_tpu_torch.parallel.mesh import active_context_mesh, broadcast
    from stlt_tpu_torch.parser import build_parser
    from stlt_tpu_torch.training.criterion import make_criterion
    from stlt_tpu_torch.training.loop import ring_sharded_parameters, step_generator

    with open(os.path.join(workdir, "fusion_ring.json")) as f:
        spec = json.load(f)
    process = ["--num_processes", str(RING_C), "--process_id", str(rank), "--coordinator_address"]
    report, seconds = {"rank": rank}, {}
    with frames_directory_videos():
        reset_all_launches()
        t0 = time.perf_counter()
        result = port_train.main(spec["train_argv"] + process + [
            f"localhost:{spec['ports']['train']}",
            "--save_model_path", os.path.join(workdir, f"best_{rank}.pt")])
        torch.cuda.synchronize()
        report["train"] = {"seconds": time.perf_counter() - t0, "launches": all_launches(),
                           "steps": result.step, "epochs": result.epochs,
                           "digest": _digest(result.model.parameters()),
                           "device": str(next(result.model.parameters()).device)}
        del result
        torch.cuda.empty_cache()
        seconds["train"] = time.perf_counter() - t0

        t_serve = time.perf_counter()
        parser = build_parser("chip_smoke fusion ring rank")
        parser.add_argument("--top_k", type=int, default=5)
        parser.add_argument("--output", type=str)
        serve = process + [f"localhost:{spec['ports']['serve']}"]
        device = predict.start_processes(parser.parse_args(spec["serve"][0]["argv"] + serve))
        report["device"] = str(device)
        criterion = make_criterion("something")
        try:
            mesh = active_context_mesh()
            report["serve"] = {}
            for run in spec["serve"]:
                args = parser.parse_args(run["argv"] + serve)
                predict.check_flags(args)
                reset_all_launches()
                t0 = time.perf_counter()
                with served_model_of() as served:
                    rows = predict.serve(args, device)
                torch.cuda.synchronize()
                report["serve"][run["label"]] = {"rows": len(rows), "launches": all_launches(),
                                                 "seconds": time.perf_counter() - t0}
                model = served.model
                _, batch = _first_batch(_fusion_data_cfg(run), run["batch"], device, "multimodal")
                with torch.inference_mode():
                    logits = model(batch)
                np.savez(os.path.join(workdir, f"fusion_ring_{rank}_{run['name']}.npz"),
                         **{head: x.float().cpu().numpy() for head, x in logits.items()})
                del model, batch, logits
                torch.cuda.empty_cache()
            seconds["serve"] = time.perf_counter() - t_serve

            step_run = spec["step"]
            t0 = time.perf_counter()
            model, batch = _fusion_ring_step_inputs(step_run, 0.0, device)
            sharded = {id(p) for p in ring_sharded_parameters(model)}
            replicated = [n for n, p in model.named_parameters()
                          if id(p) not in sharded and p.requires_grad]
            # No repair: the replicated gradients as each rank computes them,
            # with the convolutions' algorithms timed per process (as before
            # the ring fixed them), then fixed; neither synchronised.
            for convs, settings in (("benchmark", (True, False)), ("deterministic", (False, True))):
                torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = settings
                model.zero_grad(set_to_none=True)
                inputs = {k: v for k, v in batch.items() if k not in ("labels", "valid")}
                criterion(model(inputs, step_generator(SEED, 0)), batch["labels"],
                          batch["valid"]).backward()
                report[f"unsynced_{convs}"] = {n: _digest([model.get_parameter(n).grad])
                                               for n in replicated
                                               if model.get_parameter(n).grad is not None}
            predict.set_conv_algorithms(device)
            for dropout in (0.0, DROPOUT):
                if dropout:
                    del model
                    model, batch = _fusion_ring_step_inputs(step_run, dropout, device, batch)
                loss, grads = _one_step(model, batch, criterion)
                report[f"step_{dropout}"] = {"loss": loss.item(), "digest": _digest(grads.values())}
                if rank == 0:
                    torch.save({"loss": loss.item(), "grads": {n: g.cpu() for n, g in grads.items()}},
                               os.path.join(workdir, f"fusion_ring_0_step_{dropout}.pt"))
                del grads
            seconds["steps"] = time.perf_counter() - t0
            # (d): the step (AdamW included), then its collectives alone.
            t0 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            report["step_ms"] = _step_ms(model, batch, criterion, steps=1)
            report["peak_bytes"] = torch.cuda.max_memory_allocated()
            params = ring_sharded_parameters(model)
            report["ring_sum_ms"] = _timed_sum(params, mesh, mesh.ring_group)
            report["ring_sum_bytes"] = 4 * sum(p.numel() for p in params if p.grad is not None)
            flat = torch.cat([model.get_parameter(n).grad.reshape(-1).float() for n in replicated
                              if model.get_parameter(n).grad is not None])
            report["broadcast_ms"] = _host_ms(lambda: broadcast(flat, mesh, mesh.ring_rank(0),
                                                                group=mesh.ring_group), 2)
            report["broadcast_bytes"] = flat.numel() * 4
            with torch.no_grad():
                inputs = {k: v for k, v in batch.items() if k not in ("labels", "valid")}
                local = model.eval().backbone.layout_branch(inputs)
            report["gather_ms"] = _host_ms(lambda: gather_frames(local, mesh), 2)
            report["gather_bytes"] = local.numel() * local.element_size() * RING_C
            seconds["times"] = time.perf_counter() - t0
            report["seconds"] = seconds
            del model, batch, local, flat
            torch.cuda.empty_cache()
        finally:
            predict.stop_processes()
    with open(os.path.join(workdir, f"fusion_ring_{rank}.json"), "w") as f:
        json.dump(report, f)
    return 0


def fusion_grid_rank(rank: int, workdir: str) -> int:
    """One rank of phase 14 (e) (``chip_smoke.py --fusion-grid-rank R
    WORKDIR``), rank R of GRID_D rings of RING_C ranks on this card:
    ``train`` of CACNF at FUSION_GRID_FRAMES (launch counts, epoch records,
    a digest of the trained weights), then under one more process group
    ``predict.serve`` (rows, launch counts) and the logits of this rank's
    rows of the first batch. Writes ``fusion_grid_R.json`` and
    ``fusion_grid_R.npz``."""
    from stlt_tpu_torch import predict
    from stlt_tpu_torch import train as port_train
    from stlt_tpu_torch.parallel.mesh import active_data_mesh
    from stlt_tpu_torch.parser import build_parser

    with open(os.path.join(workdir, "fusion_grid.json")) as f:
        spec = json.load(f)
    process = ["--num_processes", str(GRID_WORLD), "--process_id", str(rank), "--coordinator_address"]
    report = {"rank": rank}
    with frames_directory_videos():
        reset_all_launches()
        t0 = time.perf_counter()
        result = port_train.main(spec["train_argv"] + process + [
            f"localhost:{spec['ports']['train']}",
            "--save_model_path", os.path.join(workdir, f"best_{rank}.pt")])
        torch.cuda.synchronize()
        report["train"] = {"seconds": time.perf_counter() - t0, "launches": all_launches(),
                           "steps": result.step, "epochs": result.epochs,
                           "digest": _digest(result.model.parameters())}
        del result
        torch.cuda.empty_cache()

        parser = build_parser("chip_smoke fusion grid rank")
        parser.add_argument("--top_k", type=int, default=5)
        parser.add_argument("--output", type=str)
        run = spec["serve"]
        args = parser.parse_args(run["argv"] + process + [f"localhost:{spec['ports']['predict']}"])
        predict.check_flags(args)
        device = predict.start_processes(args)
        report["device"] = str(device)
        try:
            reset_all_launches()
            with served_model_of() as served:
                rows = predict.serve(args, device)
            torch.cuda.synchronize()
            report["predict"] = {"rows": len(rows), "launches": all_launches()}
            _, batch = _first_batch(_fusion_data_cfg(run), run["batch"], device, "multimodal")
            model = served.model
            with torch.inference_mode():
                logits = model(_grid_part(batch, active_data_mesh()))
            np.savez(os.path.join(workdir, f"fusion_grid_{rank}.npz"),
                     **{head: x.float().cpu().numpy() for head, x in logits.items()})
        finally:
            predict.stop_processes()
    with open(os.path.join(workdir, f"fusion_grid_{rank}.json"), "w") as f:
        json.dump(report, f)
    return 0


def _start_ranks(flag: str, world: int, workdir: str) -> list:
    """Start ``world`` processes ``chip_smoke.py FLAG R WORKDIR``; returns
    them (``_wait_ranks`` waits for them)."""
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), flag, str(r), workdir],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def _wait_ranks(procs: list, label: str, groups: int, device) -> list:
    """Wait for the rank processes of ``_start_ranks`` (killing any left at
    the end): any rank's failure, or a rank without ``groups`` backend
    lines (``distributed: rank R of WORLD on DEVICE, backend gloo``: every
    rank on this process's ``device``), fails the phase. Returns each
    rank's output."""
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=900)[0])
    finally:
        for proc in procs:
            proc.kill()
    for r, (proc, out) in enumerate(zip(procs, outs)):
        tail = "\n".join(out.splitlines()[-40:])
        if proc.returncode != 0:
            raise AssertionError(f"{label} rank {r} exited {proc.returncode}:\n{tail}")
        want_line = f"distributed: rank {r} of {len(procs)} on {device}, backend gloo"
        if out.count(want_line) != groups:
            raise AssertionError(f"{label} rank {r}: not {groups} lines '{want_line}' in its log:\n{tail}")
    return outs


class served_model_of:
    """Within the block, ``predict.load_served_model`` keeps the last model it
    returned in ``.model``: the served model's logits without a second load."""

    def __enter__(self):
        from stlt_tpu_torch import predict

        self.predict, self.load, self.model = predict, predict.load_served_model, None

        def load(*args):
            self.model = self.load(*args)
            return self.model

        predict.load_served_model = load
        return self

    def __exit__(self, *exc):
        self.predict.load_served_model = self.load
        return False


def _replicated_ms(model, batch) -> dict:
    """Wall ms of one forward and backward (``_host_ms``) of the work every
    ring rank repeats whole in a CACNF train step: the appearance branch on
    the batch's clips, and the fusion blocks on the whole layout axis (the
    layout branch's output, taken once, as their input)."""
    from stlt_tpu_torch.ops import masks
    from stlt_tpu_torch.training.loop import step_generator

    inputs = {k: v for k, v in batch.items() if k not in ("labels", "valid")}
    backbone = model.train().backbone
    with torch.no_grad():
        layout = backbone.layout_branch(inputs, step_generator(SEED, 0))
        appearance = backbone.appearance_branch.forward_features(inputs, step_generator(SEED, 0))
    pad = masks.key_padding_bias(masks.frames_padding_mask(inputs["frame_types"]))
    causal = masks.causal_bias(layout.shape[1], layout.device) + pad

    def appearance_step():
        out = backbone.appearance_branch.forward_features(inputs, step_generator(SEED, 0))
        out.float().sum().backward()

    def fusion_step():
        lay, app = (x.detach().requires_grad_() for x in (layout, appearance))
        gen = step_generator(SEED, 0)
        for block in backbone.mm_fusion:
            lay, app = block(lay, app, causal, pad, gen)
        (lay.float().sum() + app.float().sum()).backward()

    out = {"appearance_branch_ms": _host_ms(appearance_step, 2),
           "fusion_blocks_ms": _host_ms(fusion_step, 2)}
    model.zero_grad(set_to_none=True)
    return out


def run_fusion_ring_path(device):
    """Phase 14: the fusion models under the ring (``--context_parallel 2``),
    the rank processes on this one card (gloo), at the full width of
    FUSION_MODEL (bench_cacnf's config: H = 768, 12 heads, 4 + 8 layout
    layers, R3D-50 and 4 appearance layers over 32 frames of 112 px, 4
    fusion layers, bf16, random seeded weights), fabricated JPEG frames read
    through ``frames_directory_videos``:

    (a) ``predict --num_processes 2 --context_parallel 2`` of CACNF at 512
        layout frames (B = 16, clips of 32-257 frames, 514 slots) and of LCF
        and CAF at 16 (B = 32, 18 slots), one batch each: each rank's rows
        and launches per forward (``_on_the_ring``), the two ranks' logits of
        every head bit-identical and within LOGITS_ATOL of one process's on
        the same weights and batch;
    (b) ``train --num_processes 2 --context_parallel 2`` of CACNF at 512
        layout frames (FUSION_TRAIN[512]: two AdamW steps, one validation
        batch, dropout 0.1): each rank's launches
        (``fusion_ring_train_launches``), its losses and trained weights
        equal bit for bit, rank 0 alone writing the checkpoint;
    (c) whether the ranks' replicated gradients (everything but the layout
        branch) are bit-identical with no repair, logged per tensor with the
        convolutions' algorithms timed per process (``cudnn.benchmark``)
        and fixed and deterministic; then one step of a seeded CACNF at 512
        frames (B = 16) at dropout 0 and at 0.1 (the layout branch's
        temporal attention, the one site on the ring, at 0 in both runs:
        ``_fusion_ring_step_inputs``), the two ranks' gradients (the layout
        branch summed over the ring, the rest rank 0's) bit for bit and
        within FUSION_STEP_BF16 of one process's on the same batch;
    (d) the ``fusion_ring_times`` line: each rank's step ms, the ring sum's,
        the broadcast's and the layout stream's gather's ms and bytes, its
        peak memory, beside one process's step (its convolutions fixed and
        timed), peak and replicated work (``_replicated_ms``), timed
        after every rank has ended (two ranks share one card: no speed
        claim);
    (e) ``train`` and ``predict --num_processes 4 --context_parallel 2`` of
        CACNF at 16 layout frames (B = 32: two rings of two ranks): the four
        ranks' launches, losses and trained weights equal bit for bit after
        two steps, and the rings' rows of the first batch's logits (each
        ring's two ranks bit-identical) within LOGITS_ATOL of one process's.
        Its ranks run while this process takes (c)'s one-process steps and
        checks (a)-(c).

    Returns rank 0's launches over its runs of (a), (b) and (e)."""
    import socket

    from stlt_tpu_torch.training.criterion import make_criterion

    def free_port():
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            return sock.getsockname()[1]

    launches = {}

    def count(counts):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    criterion = make_criterion("something")
    saved = torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic
    with tempfile.TemporaryDirectory(prefix="stlt_chip_smoke_fusion_ring_") as root, \
            frames_directory_videos():
        ckpts = _fusion_checkpoints(root)  # CACNF's weights, and CAF's and LCF's from them
        sets = {}
        for frames, (clips, frames_range) in FUSION_TRAIN.items():
            sub = os.path.join(root, str(frames))
            os.makedirs(sub)
            train_clips = clips * FUSION_TRAIN_STEPS
            paths = write_something_dataset(sub, train_clips + clips, SEED + 60 + frames,
                                            num_used=TRAIN_LABELS, frames_range=frames_range)
            split = _split_dataset(paths, sub, train_clips)
            with open(paths["dataset"]) as f:
                videos = write_video_frames(os.path.join(sub, "frames"), [c["id"] for c in json.load(f)],
                                            SEED + 60 + frames)
            sets[frames] = dict(split=split, paths=paths, videos=videos,
                                run=dict(test=split["val"], train=split["train"], labels=paths["labels"],
                                         videoid2size=paths["videoid2size"], videos=videos,
                                         frames=frames, batch=clips))

        def serve_run(label, name, frames, batch_size, out_dir):
            s = sets[frames]
            return dict(s["run"], label=label, name=name, batch=batch_size, argv=_fusion_predict_argv(
                name, s["split"]["val"], s["paths"], s["videos"], ckpts[name], frames, batch_size)
                + ["--context_parallel", str(RING_C), "--output",
                   os.path.join(out_dir, f"predictions_{name}_{frames}.jsonl")])

        big = sets[FUSION_RING_FRAMES]
        ring_dir = os.path.join(root, "ring")
        os.makedirs(ring_dir)
        spec = {"ports": {name: free_port() for name in FUSION_RING_PORTS},
                "train_argv": _fusion_train_argv(
                    "cacnf", big["split"], big["paths"], big["videos"], FUSION_RING_FRAMES,
                    big["run"]["batch"], ring_dir, "--context_parallel", str(RING_C)),
                "serve": [serve_run(*run, ring_dir) for run in FUSION_RING_SERVE], "step": big["run"]}
        with open(os.path.join(ring_dir, "fusion_ring.json"), "w") as f:
            json.dump(spec, f)
        _wait_ranks(_start_ranks("--fusion-ring-rank", RING_C, ring_dir), "phase 14 ring",
                    len(FUSION_RING_PORTS), device)
        reports = []
        for r in range(RING_C):
            with open(os.path.join(ring_dir, f"fusion_ring_{r}.json")) as f:
                reports.append(json.load(f))
            if {reports[-1]["device"], reports[-1]["train"]["device"]} != {str(device)}:
                raise AssertionError(f"phase 14 ring rank {r} ran on {reports[-1]['device']}")

        # (e)'s ranks run while this process checks (a)-(d).
        grid_dir = os.path.join(root, "grid")
        os.makedirs(grid_dir)
        small = sets[FUSION_GRID_FRAMES]
        grid_serve = serve_run("cacnf grid", "cacnf", FUSION_GRID_FRAMES, small["run"]["batch"], grid_dir)
        with open(os.path.join(grid_dir, "fusion_grid.json"), "w") as f:
            json.dump({"ports": {name: free_port() for name in GRID_PORTS},
                       "train_argv": _fusion_train_argv(
                           "cacnf", small["split"], small["paths"], small["videos"], FUSION_GRID_FRAMES,
                           small["run"]["batch"], grid_dir, "--context_parallel", str(RING_C)),
                       "serve": grid_serve}, f)
        grid_procs = _start_ranks("--fusion-grid-rank", GRID_WORLD, grid_dir)
        try:
            one, model, batch = _one_process_steps(big["run"], criterion, device)
            _check_ring_reports(reports, spec, ring_dir, ckpts, one, device, count)
            del one
        finally:
            _wait_ranks(grid_procs, "phase 14 grid", len(GRID_PORTS), device)
        _check_grid_reports(grid_dir, grid_serve, ckpts, device, count)
        times = _one_process_times(model, batch, criterion)  # the card to this process alone
        del model, batch
        torch.cuda.empty_cache()
        log("fusion_ring_times " + json.dumps({
                "card": card_line(), "config": f"cacnf, {FUSION_RING_FRAMES} layout frames, B = "
                                               f"{big['run']['batch']}, dropout {DROPOUT}",
                "ranks": [{k: rep[k] for k in ("rank", "step_ms", "ring_sum_ms", "broadcast_ms",
                                               "gather_ms", "peak_bytes", "seconds")} for rep in reports],
                "ring_sum_bytes": reports[0]["ring_sum_bytes"],
                "broadcast_bytes": reports[0]["broadcast_bytes"],
                "gather_bytes": reports[0]["gather_bytes"], **times,
                "note": "two ranks share one card, the ring, the sum, the broadcast and the gather "
                        "staged through host memory (gloo): no speed claim; the ranks' convolutions "
                        "fixed and deterministic, the one process's both ways, timed alone on the card"}))
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = saved
    return launches


def _one_process_steps(run, criterion, device):
    """(c)'s one-process references: {dropout: (loss, gradients on the
    host)} of ``_fusion_ring_step_inputs``' seeded CACNF, the convolutions
    fixed and deterministic as on the ring; returns them with the
    dropout-0.1 model and the batch, for ``_one_process_times``."""
    one, batch = {}, None
    saved = torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic
    _deterministic_convolutions()
    for dropout in (0.0, DROPOUT):
        if dropout:
            del model
            torch.cuda.empty_cache()
        model, batch = _fusion_ring_step_inputs(run, dropout, device, batch)
        loss, grads = _one_step(model, batch, criterion)
        one[dropout] = (loss.item(), {n: g.cpu() for n, g in grads.items()})
        del grads
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = saved
    return one, model, batch


def _one_process_times(model, batch, criterion) -> dict:
    """(d)'s one process: its step ms with the convolutions fixed and
    deterministic and with them timed (``cudnn.benchmark``), its peak
    memory and its replicated work (``_replicated_ms``)."""
    saved = torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic
    _deterministic_convolutions()
    torch.cuda.reset_peak_memory_stats()
    times = {"one_process_ms": _step_ms(model, batch, criterion, steps=FUSION_RING_STEP_REPEATS),
             "one_process_peak_bytes": torch.cuda.max_memory_allocated()}
    times.update(_replicated_ms(model, batch))
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = True, False
    times["one_process_ms_benchmark_convs"] = _step_ms(model, batch, criterion,
                                                       steps=FUSION_RING_STEP_REPEATS)
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = saved
    return times


def _check_ring_reports(reports, spec, ring_dir, ckpts, one, device, count) -> None:
    """Phase 14 (a)-(c) from the two ring ranks' reports (see
    ``run_fusion_ring_path``); ``one``: the one process's (loss,
    gradients) by dropout; ``count`` takes rank 0's launches. The one
    process's logits take the ranks' fixed convolution algorithms."""
    from stlt_tpu_torch.configs import position_table_rows

    _deterministic_convolutions()

    # (a) serving on the ring.
    for run in spec["serve"]:
        frames, batch_size, name = run["frames"], run["batch"], run["name"]
        label = (f"predict {name} --num_processes {RING_C} --context_parallel {RING_C}, {frames} "
                 f"layout frames, B = {batch_size}")
        want = _on_the_ring(fusion_launches(name, frames), frames)
        for r, report in enumerate(reports):
            entry = report["serve"][run["label"]]
            counts = entry["launches"]
            if counts != {k: want.get(k, 0) for k in counts} or entry["rows"] != batch_size:
                raise AssertionError(f"{label}, rank {r}: {entry['rows']} rows, launches {counts}, "
                                     f"expected {want} (one forward)")
            log(f"{label}, rank {r}: {entry['rows']} rows in {entry['seconds']:.3f} s; launches {counts}")
        count(reports[0]["serve"][run["label"]]["launches"])
        logits = [np.load(os.path.join(ring_dir, f"fusion_ring_{r}_{name}.npz")) for r in range(RING_C)]
        for head in logits[0].files:
            if not all(np.array_equal(x[head], logits[0][head]) for x in logits):
                raise AssertionError(f"{label}: the ranks' {head} logits differ")
        data_cfg = _fusion_data_cfg(run)
        model = _served_model(ckpts[name], FUSION_MODEL, position_table_rows(data_cfg), device, name=name)
        _, batch = _first_batch(data_cfg, batch_size, device, "multimodal")
        with torch.inference_mode():
            single = model(batch)
        for head in model.logit_names:
            _check_logits(f"{label} {head} (both ranks bit-identical)",
                          torch.from_numpy(logits[0][head]).to(device), single[head].float(),
                          "one process")
        del model, batch, single
        torch.cuda.empty_cache()

    # (c) the replicated gradients with no repair, then one step against one process.
    step_label = (f"train step cacnf on the ring, {FUSION_RING_FRAMES} layout frames, "
                  f"B = {spec['step']['batch']}")
    for convs in ("benchmark", "deterministic"):
        mine, other = (rep[f"unsynced_{convs}"] for rep in reports)
        differ = [n for n in mine if mine[n] != other[n]]
        log(f"{step_label}, dropout 0, no repair (the replicated gradients as each rank computes "
            f"them, not synchronised; the convolutions' algorithms "
            + ("timed per process, cudnn.benchmark" if convs == "benchmark"
               else "fixed and deterministic") + f"): {len(mine) - len(differ)} of {len(mine)} "
            f"tensors bit-identical on both ranks; differing: {differ[:8]}"
            + (f" and {len(differ) - 8} more" if len(differ) > 8 else ""))
    for dropout in (0.0, DROPOUT):
        what = f"{step_label}, dropout {dropout}"
        if len({json.dumps(rep[f"step_{dropout}"]) for rep in reports}) != 1:
            raise AssertionError(f"{what}: the ranks' losses or gradients differ")
        ranks = torch.load(os.path.join(ring_dir, f"fusion_ring_0_step_{dropout}.pt"))
        loss, grads = one[dropout]
        _compare_steps(what, f"{RING_C} ranks (the layout branch summed over the ring, the rest "
                       "rank 0's; bit for bit on both) vs one process",
                       (ranks["loss"], {n: g.to(device) for n, g in ranks["grads"].items()}),
                       (loss, {n: g.to(device) for n, g in grads.items()}), FUSION_STEP_BF16)
        del ranks

    # (b) training on the ring.
    label = (f"train cacnf --num_processes {RING_C} --context_parallel {RING_C}, "
             f"{FUSION_RING_FRAMES} layout frames, B = {spec['step']['batch']}")
    want = fusion_ring_train_launches(FUSION_RING_FRAMES, FUSION_TRAIN_STEPS)
    for r, report in enumerate(reports):
        entry = report["train"]
        counts = entry["launches"]
        if counts != {k: want.get(k, 0) for k in counts}:
            raise AssertionError(f"{label}, rank {r}: launches {counts}, expected {want}")
        if entry["steps"] != FUSION_TRAIN_STEPS or not all(
                math.isfinite(e["train_loss"]) for e in entry["epochs"]):
            raise AssertionError(f"{label}, rank {r}: bad run {entry}")
        log(f"{label}, rank {r}: {entry['steps']} steps in {entry['seconds']:.3f} s (data, model "
            f"set-up and validation included); launches {counts}; epochs {json.dumps(entry['epochs'])}")
    count(reports[0]["train"]["launches"])
    losses = [[e["train_loss"] for e in report["train"]["epochs"]] for report in reports]
    if any(x != losses[0] for x in losses) or len({rep["train"]["digest"] for rep in reports}) != 1:
        raise AssertionError(f"{label}: the ranks' losses {losses} or trained weights differ")
    # Only rank 0 writes the best model, when an epoch is the best.
    best = any(e["is_best"] for e in reports[0]["train"]["epochs"])
    written = [r for r in range(RING_C) if os.path.exists(os.path.join(ring_dir, f"best_{r}.pt"))]
    if written != ([0] if best else []):
        raise AssertionError(f"{label}: checkpoints written by ranks {written} (best epoch: {best})")
    log(f"{label}: both ranks' losses {losses[0]} and trained weights equal bit for bit (the "
        f"replicated gradients rank 0's); "
        + ("rank 0 alone wrote the checkpoint" if best else "no best epoch, no checkpoint written"))


def _check_grid_reports(grid_dir, run, ckpts, device, count) -> None:
    """Phase 14 (e) from the four grid ranks' reports (see
    ``run_fusion_ring_path``); ``count`` takes rank 0's launches. The one
    process's logits take the ranks' fixed convolution algorithms."""
    from stlt_tpu_torch.configs import position_table_rows

    _deterministic_convolutions()

    reports = []
    for r in range(GRID_WORLD):
        with open(os.path.join(grid_dir, f"fusion_grid_{r}.json")) as f:
            reports.append(json.load(f))
        if reports[-1]["device"] != str(device):
            raise AssertionError(f"phase 14 grid rank {r} ran on {reports[-1]['device']}")
    label = (f"train cacnf --num_processes {GRID_WORLD} --context_parallel {RING_C}, "
             f"{FUSION_GRID_FRAMES} layout frames, B = {run['batch']}")
    want = fusion_ring_train_launches(FUSION_GRID_FRAMES, FUSION_TRAIN_STEPS)
    for r, report in enumerate(reports):
        entry = report["train"]
        counts = entry["launches"]
        if counts != {k: want.get(k, 0) for k in counts} or entry["steps"] != FUSION_TRAIN_STEPS \
                or not all(math.isfinite(e["train_loss"]) for e in entry["epochs"]):
            raise AssertionError(f"{label}, rank {r}: launches {counts}, expected {want}; {entry}")
        log(f"{label}, rank {r} (data {r // RING_C}, context {r % RING_C}): {entry['steps']} steps "
            f"in {entry['seconds']:.3f} s; launches {counts}; epochs {json.dumps(entry['epochs'])}")
    count(reports[0]["train"]["launches"])
    losses = [[e["train_loss"] for e in report["train"]["epochs"]] for report in reports]
    if any(x != losses[0] for x in losses) or len({rep["train"]["digest"] for rep in reports}) != 1:
        raise AssertionError(f"{label}: the ranks' losses {losses} or trained weights differ")
    log(f"{label}: the {GRID_WORLD} ranks' losses {losses[0]} and trained weights equal bit for bit")
    plabel = (f"predict cacnf --num_processes {GRID_WORLD} --context_parallel {RING_C}, "
              f"{FUSION_GRID_FRAMES} layout frames, B = {run['batch']}")
    want = _on_the_ring(fusion_launches("cacnf", FUSION_GRID_FRAMES), FUSION_GRID_FRAMES)
    for r, report in enumerate(reports):
        entry = report["predict"]
        if entry["launches"] != {k: want.get(k, 0) for k in entry["launches"]} or \
                entry["rows"] != run["batch"]:
            raise AssertionError(f"{plabel}, rank {r}: {entry}, expected launches {want}")
    count(reports[0]["predict"]["launches"])
    logits = [np.load(os.path.join(grid_dir, f"fusion_grid_{r}.npz")) for r in range(GRID_WORLD)]
    data_cfg = _fusion_data_cfg(run)
    model = _served_model(ckpts["cacnf"], FUSION_MODEL, position_table_rows(data_cfg), device,
                          name="cacnf")
    _, batch = _first_batch(data_cfg, run["batch"], device, "multimodal")
    with torch.inference_mode():
        single = model(batch)
    for head in model.logit_names:
        for d in range(GRID_D):
            ring = logits[d * RING_C:(d + 1) * RING_C]
            if any(not np.array_equal(x[head], ring[0][head]) for x in ring):
                raise AssertionError(f"{plabel}: ring {d}'s ranks' {head} logits differ")
        got = torch.from_numpy(np.concatenate([logits[d * RING_C][head] for d in range(GRID_D)]))
        _check_logits(f"{plabel} {head}, the rings' rows joined", got.to(device), single[head].float(),
                      "one process")
    del model, batch, single
    torch.cuda.empty_cache()
    log(f"{plabel}: each rank's launches per forward {want}")

def main(argv=()) -> int:
    argv = list(argv)
    if argv[:1] == ["--ring-rank"]:  # one rank of phase 9, started by run_ring_path
        return ring_rank(int(argv[1]), int(argv[2]), argv[3])
    if argv[:1] == ["--ring-train-rank"]:  # one rank of phase 10, started by run_ring_train_path
        return ring_train_rank(int(argv[1]), argv[2])
    if argv[:1] == ["--data-rank"]:  # one rank of phase 12, started by run_data_axis_path
        return data_rank(int(argv[1]), argv[2])
    if argv[:1] == ["--grid-rank"]:  # one rank of phase 13, started by run_grid_path
        return grid_rank(int(argv[1]), argv[2])
    if argv[:1] == ["--fusion-ring-rank"]:  # one rank of phase 14, started by run_fusion_ring_path
        return fusion_ring_rank(int(argv[1]), argv[2])
    if argv[:1] == ["--fusion-grid-rank"]:  # one rank of phase 14 (e)
        return fusion_grid_rank(int(argv[1]), argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the GPU",
              file=sys.stderr)
        return 1
    from stlt_tpu_torch.ops import _kernels

    device = torch.device("cuda", 0)
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _kernels.build_all(verbose=True)
    log(f"build: {time.perf_counter() - t0:.1f} s")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def timed(fn):
        """fn(device), with its wall time logged."""
        t = time.perf_counter()
        out = fn(device)
        log(f"phase_time {fn.__name__}: {time.perf_counter() - t:.1f} s")
        return out

    if argv[:1] == ["--only"]:  # named phases alone (to repeat one on the card): no result line
        for name in argv[1].split(","):
            timed(globals()[name])
        return 0

    table = timed(check_kernels)
    table.update(timed(check_train_kernels))
    table.update(timed(check_long_kernels))
    timed(check_fwd_bodies)  # rows 6 and 8: the device kernel each mode launches
    table.update(timed(check_long_train_kernels))
    table.update(timed(check_tail_train_kernels))
    table.update(timed(check_fusion_kernels))
    timed(check_sublayer_stages)  # rows 1, 3 and 5 stage by stage, by CUDA kernel
    table.update(timed(check_fusion_train_kernels))
    timed(check_width_kernels)  # every kernel at other head dims and widths
    table.update(timed(check_offsets_kernel))
    table.update(timed(check_offsets_bwd_kernel))
    timed(check_mask_kernels)  # rows 6-10 with the dropout-mask operand (no main path passes one)
    launches = timed(run_main_path)  # the predict path: eval kernels
    train_launches, _ = timed(run_train_path)  # the train path: train kernels
    launches.update({name: train_launches[name] for name in TRAIN_KERNELS})
    # The train CLI's levers (--grad_accum_steps, --remat, --resume_dir, --profile_dir).
    for name, count in timed(run_train_levers_path)["launches"].items():
        launches[name] += count
    launches.update(timed(run_long_clip_path))  # long clips: the long-clip kernels
    # Long-clip training: the attention backwards and the fused train tail.
    launches.update(timed(run_long_train_path)[0])
    launches.update(timed(run_fusion_path))  # the fusion models: row 5 and row 8's dense mode
    # Fusion training: the dense-bias mode of the blockwise backward (rows 9, 10).
    launches.update(timed(run_fusion_train_path)[0])
    # Serving under --context_parallel 2: two ranks on this card, the ring's offsets mode.
    launches.update(timed(run_ring_path))
    # Training under --context_parallel 2: the ring-offset mode of the blockwise backward.
    launches.update(timed(run_ring_train_path))
    # The data axis (--num_processes 2): every dropout kernel at a global-row
    # base, then train, one step and predict on two ranks against one process.
    timed(check_base_kernels)
    timed(run_data_axis_path)
    # The data axis under the ring (--num_processes 4 --context_parallel 2): four ranks on this card.
    timed(run_grid_path)
    # The fusion models under the ring and on the grid: rank 0's launches.
    for name, count in timed(run_fusion_ring_path).items():
        launches[name] = launches.get(name, 0) + count

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
        if name in CUDA_KERNELS:
            kernels[-1]["cuda_kernels"] = list(CUDA_KERNELS[name])
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
