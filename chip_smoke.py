#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``stlt_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. print the card's name and power limit, build every kernel of the STLT eval
   path from ``stlt_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel);
2. hold each kernel against its plain PyTorch version on the card, in bf16
   and f32, at the shapes the main path gives it (spatial: rows = B*17,
   T = 8, ragged ``rows_live``; temporal: rows = B, T = 17, causal plus
   padding bias, ragged ``tokens_live``), and time kernel, plain version and
   a composition of PyTorch library calls (a yardstick only) with CUDA
   events, at the main-path batch and at B = 1024;
3. write a synthetic Something-Else dataset, save a randomly initialised
   full-width bf16 STLT as a reference-format ``.pt`` and serve it with
   ``python -m stlt_tpu_torch.predict``'s entry point (3 batches of 64 clips,
   ragged lengths): the row count, finite scores and the launch counts are
   asserted, and one batch's logits are held against the plain path on the
   card;
4. print the kernel table as one JSON line, then the result line.

Tolerances (kernel against plain version, same inputs, same rounding
points; the two differ only in the order of their sums):

- f32 ops: atol = rtol = 1e-4. Sums run over up to 3072 products, and
  LayerNorm divides by the row's spread, so reordering moves the last bits
  of an f32 value; 1e-4 holds that with margin and nothing more.
- bf16 ops: atol = 6e-2, rtol = 2e-2. A reordered f32 sum can round to the
  neighbouring bf16 value (2**-8 relative), and a flipped intermediate moves
  a LayerNorm output by a few bf16 steps.
- bf16 logits of the whole model: atol = 5e-2. The whole bf16 path differs
  from the f32 path by 2.5e-2 at most at this config (randomly initialised
  STLT, 4 clips, CPU); kernel and plain differ by less than bf16 itself.
"""

from __future__ import annotations

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

REPLACES = {
    "fused_proj_attention": "stlt_tpu/ops/fused_encoder.py:154",
    "fused_layer_tail": "stlt_tpu/ops/fused_encoder.py:456",
}


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


def make_stage(stage: str, clips: int, dtype, gen, device):
    """Inputs one encoder layer of ``stage`` sees at ``clips`` clips:
    (x, attn_out, bias, live kwargs, [rows, T] bool of the tokens the
    attention computes, [rows, T] bool of the tokens the tail computes)."""
    from stlt_tpu_torch.ops import masks

    lengths = torch.randint(4, NUM_FRAMES + 1, (clips,), generator=gen)
    frame_live = torch.arange(NUM_FRAMES)[None, :] < lengths[:, None]  # [clips, F]
    if stage == "spatial":
        rows, T = clips * NUM_FRAMES, NUM_BOXES
        boxes = torch.randint(1, NUM_BOXES + 1, (rows,), generator=gen)
        pad = torch.arange(T)[None, :] >= boxes[:, None]  # slot 0 (CLS) is always live
        bias = masks.key_padding_bias(pad)  # [rows, 1, 1, T]
        rows_live = frame_live.reshape(rows)
        live_kw = {"rows_live": rows_live.to(device)}
        proj_live = tail_live = rows_live[:, None].expand(rows, T)
    else:
        rows, T = clips, NUM_FRAMES
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


def library_tail(w, dtype):
    """``F.layer_norm`` / ``F.linear`` / ``F.gelu``: the same function from
    PyTorch's library calls, a yardstick only."""
    c = {k: w[k].to(dtype) for k in ("n1s", "n1b", "b1", "b2", "n2s", "n2b")}
    w1, w2 = w["w1"].t().contiguous().to(dtype), w["w2"].t().contiguous().to(dtype)
    approximate = "tanh" if dtype == torch.bfloat16 else "none"

    def run(x, a):
        u = F.layer_norm(x + a, (H,), c["n1s"], c["n1b"], EPS)
        h = F.gelu(F.linear(u, w1, c["b1"]), approximate=approximate)
        return F.layer_norm(u + F.linear(h, w2, c["b2"]), (H,), c["n2s"], c["n2b"], EPS)

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


def check_kernels(device):
    """Compare and time both kernels; returns the rows of the kernel table,
    keyed by kernel name, measured at the main-path batch in bf16 on the
    spatial stage (the larger one), with every other measurement printed."""
    from stlt_tpu_torch.ops import fused_encoder as fe

    gen = torch.Generator().manual_seed(SEED)
    w = make_weights(gen, device)
    table = {}
    for dtype in (torch.bfloat16, torch.float32):
        tol = OP_TOL[dtype]
        lib_p, lib_t = library_proj(w, dtype), library_tail(w, dtype)
        for stage in ("spatial", "temporal"):
            for clips in (BATCH, THROUGHPUT_BATCH):
                if clips == THROUGHPUT_BATCH and dtype != torch.bfloat16:
                    continue
                x, a, bias, live_kw, proj_live, tail_live = make_stage(stage, clips, dtype, gen, device)
                rows_live = live_kw.get("rows_live")
                proj_args = (x, w["wqkv"], w["bqkv"], w["wo"], w["bo"], bias)
                proj_kw = dict(num_heads=HEADS, compute_dtype=dtype, rows_live=rows_live)
                tail_args = (x, a, w["n1s"], w["n1b"], w["w1"], w["b1"], w["w2"], w["b2"],
                             w["n2s"], w["n2b"])
                tail_kw = dict(eps=EPS, compute_dtype=dtype, activation="gelu",
                               gelu_approximate=dtype == torch.bfloat16, **live_kw)
                ops = {
                    "fused_proj_attention": (
                        lambda: fe.fused_proj_attention(*proj_args, **proj_kw),
                        lambda: fe.fused_proj_attention_plain(*proj_args, **proj_kw),
                        lambda: lib_p(x, bias.to(dtype)),
                        proj_bound(x, bias, proj_live, dtype),
                        proj_live,
                    ),
                    "fused_layer_tail": (
                        lambda: fe.fused_layer_tail(*tail_args, **tail_kw),
                        lambda: fe.fused_layer_tail_plain(*tail_args, **tail_kw),
                        lambda: lib_t(x, a),
                        tail_bound(x, tail_live, dtype),
                        tail_live,
                    ),
                }
                for name, (kernel, plain, library, (bound_ms, bound_by), live) in ops.items():
                    got, want = kernel(), plain()
                    torch.cuda.synchronize()
                    err = _check_close(f"{name} {stage} {dtype} B={clips}", got, want, live, tol)
                    iters = 20 if clips == BATCH else 5
                    ms = cuda_ms(kernel, iters)
                    plain_ms = cuda_ms(plain, iters)
                    library_ms = cuda_ms(library, iters)
                    row = {
                        "name": name, "stage": stage, "dtype": str(dtype).split(".")[1],
                        "clips": clips, "rows": x.shape[0], "T": x.shape[1],
                        "live_fraction": round(float(live.float().mean()), 4),
                        "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
                        "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                    }
                    log("kernel_check " + json.dumps(row))
                    if stage == "spatial" and clips == BATCH and dtype == torch.bfloat16:
                        table[name] = row
                del x, a, bias, live_kw, proj_live, tail_live, ops
                torch.cuda.empty_cache()
    return table


# --- phase 3: the main path through the prediction entry point ----------------


def write_something_dataset(root: str, num_videos: int, seed: int):
    """A synthetic dataset in the Something-Else layout schema (174 labels,
    hand/object boxes, 3..24 frames a clip, so sampled lengths are ragged).
    Returns {dataset_path, labels_path, videoid2size_path}."""
    rng = np.random.default_rng(seed)
    templates = [f"Doing something {i}" for i in range(NUM_CLASSES)]
    labels = {t: str(i) for i, t in enumerate(templates)}
    videos, sizes = [], {}
    for v in range(num_videos):
        vid = str(100000 + v)
        width, height = int(rng.integers(200, 480)), int(rng.integers(150, 360))
        sizes[vid] = [width, height]
        frames = []
        for _ in range(int(rng.integers(3, 25))):
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
        videos.append({"id": vid, "template": templates[int(rng.integers(NUM_CLASSES))],
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
    from stlt_tpu_torch.ops import fused_encoder as fe
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

        fe.reset_launches()
        t0 = time.perf_counter()
        rows = predict.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(fe.LAUNCHES)
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
        for name in REPLACES:
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
            kernels = fe.fused_proj_attention, fe.fused_layer_tail
            fe.fused_proj_attention, fe.fused_layer_tail = (
                fe.fused_proj_attention_plain, fe.fused_layer_tail_plain)
            try:
                want_logits = model(batch)["stlt"]
                plain_forward_ms = cuda_ms(lambda: model(batch), 10)
            finally:
                fe.fused_proj_attention, fe.fused_layer_tail = kernels
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
    launches = run_main_path(device)

    kernels = []
    for name, row in table.items():
        kernels.append({
            "name": name, "route": "cuda", "source": f"stlt_tpu_torch/csrc/{name}.cu",
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
