"""Fused encoder-layer ops: projection+attention (eval and train) and the
eval layer tail. Port of ``stlt_tpu/ops/fused_encoder.py``:
``fused_proj_attention`` (:327), ``fused_layer_tail`` (:578),
``fused_proj_attention_train`` (:946) with its forward (:961) and backward
(:1028), ``fused_cross_attention`` (:1186), and the host helpers ``live_prefix_capacity`` / ``frame_capacity``
(:75-118) of the ragged levers.

Each op has three parts:

- the wrapper (``fused_proj_attention``, ``fused_layer_tail``,
  ``fused_proj_attention_train``, ``fused_cross_attention``): a CUDA tensor
  launches the hand-written kernels (``csrc/<op>.cu``; the train op's
  backward ``csrc/fused_proj_attention_bwd.cu``) or raises; a CPU tensor
  takes the plain versions. The device alone decides; there is no
  fallback;
- the plain PyTorch version (``*_plain``) of the same function, with the same
  rounding points;
- a launch count in :data:`LAUNCHES`, raised by one where the wrapper
  launches its kernel and nowhere else (``fused_proj_attention_train`` for
  the train forward, ``fused_proj_attention_train_bwd`` for its backward;
  the model axis's sum epilogues in :data:`SUM_LAUNCHES`).

Numerics are the kernel contract of the JAX package's ``use_pallas=True``
path, not its TPU blocking:

- ``fused_proj_attention`` rounds ``wqkv``/``bqkv``/``wo``/``bo`` and ``qkv``
  (after the f32 bias add) to the compute dtype; logits and softmax are f32
  with scale ``1/sqrt(D)``; the attention output is rounded to the compute
  dtype before the out-projection, which accumulates in f32. T <= 64.
- ``fused_proj_attention_train`` is the same forward with each probability
  multiplied by keep * 1/(1-rate), the keep bits hashed from (seed, global
  row, head, t, s) (``ops/dropout.py``). Its backward recomputes qkv and the
  probabilities and follows ``_fused_proj_bwd_body`` step for step: dqkv in
  the compute dtype, dWo and dbo in f32; dx, dWqkv (f32) and dbqkv (f32) are
  plain GEMMs (:func:`proj_input_grads`).
- ``fused_cross_attention`` is the same contract with ``q`` projected from
  x [B, T, H] and ``kv`` from the context [B, S, H] (``wq``/``bq``,
  ``wkv``/``bkv`` rounded to the compute dtype, ``q`` and ``kv`` rounded
  after the f32 bias add). Eval only, T, S <= 64, no ``rows_live``.
- ``fused_layer_tail`` does the residual adds in the compute dtype, adds
  ``b1``, ``b2`` and the LayerNorm parameters in f32, and applies the
  activation to the compute-dtype hidden op for op in that dtype, as JAX
  does (:func:`gelu`).
- Dead rows (``rows_live``) and dead tokens (``tokens_live``) come out as
  exact zeros, and dead rows get zero gradients. The JAX kernels zero whole
  dead row blocks only; either way dead rows reach later attention only as
  -1e9-masked keys, so their cotangents are exactly zero.

Under the model axis (``--model_parallel M``) rows 1, 2 and 5 run partial
modes that stop before the row-parallel sum and return its f32 partial, and
sum epilogues that finish the row after the model ranks' sum
(:func:`fused_proj_attention_partial`, :func:`fused_layer_tail_partial`,
:func:`fused_cross_attention_partial`; :func:`sublayer_sum`,
:func:`fused_layer_tail_sum`), each with its plain version beside it.

The TPU artefacts (T padded to a multiple of 8, tokens flattened into rows of
8, row-block pickers, VMEM budgets) do not carry over.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from stlt_tpu_torch.ops import _kernels
from stlt_tpu_torch.ops.dropout import MASK32, RowMap, Rows, dropout_thresh, hash_keep_mask

LAUNCHES = {
    "fused_proj_attention": 0,
    "fused_layer_tail": 0,
    "fused_proj_attention_train": 0,
    "fused_proj_attention_train_bwd": 0,
    "fused_cross_attention": 0,
}
# The model axis's sum epilogues of rows 1, 2 and 5 (their partial launches
# count in LAUNCHES under the rows' own names).
SUM_LAUNCHES = {"fused_proj_attention_sum": 0, "fused_layer_tail_sum": 0, "fused_cross_attention_sum": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Hidden sizes the CUDA kernels take (64 x these) and head dims of the ones
# that fuse attention.
_KERNEL_WIDTHS = tuple(range(1, 17))
_KERNEL_HEAD_DIMS = (32, 64, 128)
_KERNEL_MAX_SEQ = 64  # FUSED_PROJ_MAX_SEQ of the JAX package
_KERNEL_FF_CHUNK = 128


def reset_launches() -> None:
    for counts in (LAUNCHES, SUM_LAUNCHES):
        for name in counts:
            counts[name] = 0


# --- host-side capacity buckets of the ragged levers ----------------------------


def live_prefix_capacity(live_rows: int, total_rows: int, buckets: int = 8) -> Optional[int]:
    """Spatial live-prefix capacity (``configs.spatial_live_capacity``) from a
    batch's live row count: the smallest of ``buckets`` evenly spaced
    capacities that holds ``live_rows``, rounded up to 8; None when it would
    not cut ``total_rows``. Own copy of ``stlt_tpu/ops/fused_encoder.py:75``
    without its environment switch."""
    live_rows = max(int(live_rows), 1)
    if live_rows >= total_rows:
        return None
    k = -(-live_rows * buckets // total_rows)
    if k >= buckets:
        return None
    cap = -(-total_rows * k // buckets)
    cap = min(total_rows, ((cap + 7) // 8) * 8)
    return None if cap >= total_rows else cap


def frame_capacity(max_live_frames: int, total_frames: int, buckets: int = 8) -> Optional[int]:
    """Frame capacity (``configs.temporal_frame_capacity``) from a batch's
    longest live prefix, in the buckets of :func:`live_prefix_capacity`. Own
    copy of ``stlt_tpu/ops/fused_encoder.py:97`` without its environment
    switch."""
    max_live_frames = max(int(max_live_frames), 1)
    if max_live_frames >= total_frames:
        return None
    k = -(-max_live_frames * buckets // total_frames)
    if k >= buckets:
        return None
    cap = -(-total_frames * k // buckets)
    cap = min(total_frames, ((cap + 7) // 8) * 8)
    return None if cap >= total_frames else cap


def _on_cpu(x: torch.Tensor, op: str) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise RuntimeError(f"{op}: no kernel for device {x.device}")


def _check_kernel_dtypes(op: str, compute_dtype, *tensors) -> int:
    if compute_dtype not in _DTYPE_CODES:
        raise TypeError(f"{op}: compute dtype {compute_dtype} is not float32 or bfloat16")
    for t in tensors:
        if t.dtype != compute_dtype:
            raise TypeError(
                f"{op}: the CUDA kernel takes activations in the compute dtype "
                f"{compute_dtype}, got {t.dtype}"
            )
    return _DTYPE_CODES[compute_dtype]


def _check_kernel_width(op: str, hidden: int) -> None:
    if hidden % 64 or hidden // 64 not in _KERNEL_WIDTHS:
        raise ValueError(
            f"{op}: the CUDA kernel takes H in 64 x {{1, ..., {_KERNEL_WIDTHS[-1]}}}, got H={hidden}"
        )


def _check_kernel_heads(op: str, hidden: int, num_heads: int) -> None:
    if num_heads < 1 or hidden % num_heads or hidden // num_heads not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"{op}: the CUDA kernel takes head dim in {_KERNEL_HEAD_DIMS}, "
                         f"got H/N={hidden / num_heads}")


def _check_tail_kernel(op: str, compute_dtype, H: int, w1, w2, *activations) -> int:
    """The dtype code of the layer-tail kernels (csrc/fused_layer_tail.cu and
    its train backward); raises on what they do not take."""
    code = _check_kernel_dtypes(op, compute_dtype, *activations)
    _check_kernel_width(op, H)
    FF = w1.shape[1]
    if FF % _KERNEL_FF_CHUNK or w1.shape != (H, FF) or w2.shape != (FF, H):
        raise ValueError(f"{op}: the CUDA kernel takes W1 [H, FF], W2 [FF, H] with FF % {_KERNEL_FF_CHUNK} == 0")
    return code


def _act_code(activation: str, gelu_approximate: bool) -> int:
    """The layer-tail kernels' activation code: 0 relu, 1 exact-erf GELU,
    2 tanh GELU."""
    if activation == "gelu":
        return 2 if gelu_approximate else 1
    if activation == "relu":
        return 0
    raise ValueError(f"unknown activation {activation}")


def _bias3(bias: Optional[torch.Tensor], rows: int, seq: int, device,
           keys: Optional[int] = None) -> torch.Tensor:
    """A head-invariant additive bias broadcastable to [rows, 1, T, S] (S =
    ``keys``, T by default), as f32 [rows or 1, T or 1, S]. The broadcast
    dims stay size 1: the spatial key-padding bias is read per row as
    [1, T], never materialised as [rows, 1, T, T]."""
    keys = seq if keys is None else keys
    if bias is None:
        return torch.zeros(1, 1, keys, dtype=torch.float32, device=device)
    b = bias.to(torch.float32)
    while b.dim() < 4:
        b = b[None]
    if b.dim() != 4 or b.shape[1] != 1:
        raise ValueError(f"head-invariant bias [rows, 1, T, S] expected, got {tuple(bias.shape)}")
    b0, tq, s = b.shape[0], b.shape[2], b.shape[3]
    if b0 not in (1, rows) or tq not in (1, seq) or s not in (1, keys):
        raise ValueError(f"bias {tuple(bias.shape)} does not broadcast to [{rows}, 1, {seq}, {keys}]")
    return b.expand(b0, 1, tq, keys).reshape(b0, tq, keys)


# --- projection + attention ---------------------------------------------------


def _keep_scale(seed: Optional[int], dropout_rate: float, B: int, N: int, T: int, device,
                row0: Rows = 0, head0: int = 0, heads: Optional[int] = None):
    """keep * 1/(1-rate) [B, N, T, T] f32 of the probability dropout at the
    global rows [row0, row0 + B) and the global heads [head0, head0 + N) of
    ``heads`` (default N), or None when it is off (no seed or rate 0), as
    in ``_fused_proj_train_fwd``."""
    if seed is None or dropout_rate <= 0.0:
        return None
    keep = hash_keep_mask(seed, B, N, T, T, dropout_rate, device, row0, head0, heads).to(torch.float32)
    return keep * (1.0 / (1.0 - dropout_rate))


def _qkv_probs(x, wqkv, bqkv, bias, num_heads: int, cd: torch.dtype):
    """q, k, v [B, N, T, D] (f32 holding compute-dtype values) and the f32
    softmax probabilities [B, N, T, T] of the kernels' contract."""
    B, T, H = x.shape
    N = num_heads
    D = wqkv.shape[1] // (3 * N)  # H / N; a model rank's shard holds N / M heads of it
    f32 = torch.float32
    qkv = x.to(cd).to(f32) @ wqkv.to(cd).to(f32) + bqkv.to(cd).to(f32)
    qkv = qkv.to(cd).to(f32).reshape(B, T, 3, N, D).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    logits = (q @ k.transpose(-1, -2)) * (1.0 / D ** 0.5)
    logits = logits + _bias3(bias, B, T, x.device)[:, None]
    logits = logits - logits.amax(dim=-1, keepdim=True)
    probs = torch.exp(logits)
    return q, k, v, probs / probs.sum(dim=-1, keepdim=True)


def _zero_dead_rows(t: torch.Tensor, rows_live) -> torch.Tensor:
    if rows_live is None:
        return t
    live = rows_live.reshape(-1, *([1] * (t.dim() - 1))).to(torch.bool)
    return torch.where(live, t, torch.zeros((), dtype=t.dtype, device=t.device))


def _proj_attention_plain(x, wqkv, bqkv, wo, bo, bias, keep, num_heads, cd, rows_live):
    B, T, H = x.shape
    f32 = torch.float32
    _, _, v, probs = _qkv_probs(x, wqkv, bqkv, bias, num_heads, cd)
    if keep is not None:
        probs = probs * keep
    attn = (probs @ v).transpose(1, 2).reshape(B, T, H)
    y = attn.to(cd).to(f32) @ wo.to(cd).to(f32) + bo.to(cd).to(f32)
    return _zero_dead_rows(y, rows_live)


def fused_proj_attention_plain(
    x: torch.Tensor,
    wqkv: torch.Tensor,
    bqkv: torch.Tensor,
    wo: torch.Tensor,
    bo: torch.Tensor,
    bias: Optional[torch.Tensor],
    *,
    num_heads: int,
    compute_dtype: torch.dtype,
    rows_live: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_proj_attention`."""
    return _proj_attention_plain(
        x, wqkv, bqkv, wo, bo, bias, None, num_heads, compute_dtype, rows_live
    ).to(x.dtype)


def _check_proj_kernel(op: str, x, wqkv, bqkv, wo, num_heads: int, compute_dtype) -> int:
    B, T, H = x.shape
    code = _check_kernel_dtypes(op, compute_dtype, x)
    _check_kernel_width(op, H)
    _check_kernel_heads(op, H, num_heads)
    if not 1 <= T <= _KERNEL_MAX_SEQ:
        raise ValueError(f"{op}: the CUDA kernel takes T <= {_KERNEL_MAX_SEQ}, got T={T}")
    if wqkv.shape != (H, 3 * H) or bqkv.shape != (3 * H,) or wo.shape != (H, H):
        raise ValueError(f"{op}: weight shapes do not match H={H}")
    return code


def _bias_operand(bias, B: int, T: int, device, keys: Optional[int] = None):
    """The bias as f32 [rows or 1, T or 1, S] (S = ``keys``, T by default)
    and its row and query strides; size-1 dims are read with stride 0."""
    b3 = _bias3(bias, B, T, device, keys).contiguous()
    S = b3.shape[2]
    row_stride = b3.shape[1] * S if b3.shape[0] > 1 else 0
    q_stride = S if b3.shape[1] > 1 else 0
    return b3, row_stride, q_stride


def _dropout_args(seed: Optional[int], dropout_rate: float, base: Rows = 0):
    """(on, seed, thresh, 1/(1-rate), and the map's base, period, stride and
    magic) of the kernels' dropout: ``base`` the global index of the
    launch's first row (the attention kernels) or token (the tails), or the
    rows' or tokens' :class:`~stlt_tpu_torch.ops.dropout.RowMap`
    (``RowMap.kernel_args``)."""
    if seed is None or dropout_rate <= 0.0:
        return (0, 0, 0, 0.0, *RowMap().kernel_args())
    return (1, int(seed) & MASK32, dropout_thresh(dropout_rate), 1.0 / (1.0 - dropout_rate),
            *RowMap.of(base).kernel_args())


def _live_flags(rows_live, B: int):
    return None if rows_live is None else rows_live.reshape(B).to(torch.uint8).contiguous()


def _launch_proj(op, x, wqkv, bqkv, wo, bo, bias, *, num_heads, compute_dtype, rows_live,
                 seed=None, dropout_rate=0.0, scratch=None, row0: Rows = 0) -> torch.Tensor:
    """Launch csrc/fused_proj_attention.cu (eval, or train with dropout).
    bf16 reads ``wqkv`` and ``wo`` in the storage of the model's
    ``in_proj_weight`` / ``out_proj.weight`` (their ``.t()`` is what the
    model passes: no copy when the dtype matches) and works in ``scratch``
    (:func:`proj_scratch`; allocated when None); f32 takes them
    input-major."""
    B, T, H = x.shape
    code = _check_proj_kernel(op, x, wqkv, bqkv, wo, num_heads, compute_dtype)
    if bo.shape != (H,):
        raise ValueError(f"{op}: bo shape does not match H={H}")
    cd = compute_dtype
    if code == _DTYPE_CODES[torch.bfloat16]:
        x = aligned16(x)
        wqkv, wo = weight_storage(wqkv, cd), weight_storage(wo, cd)  # [3H, H], [H, H]
        bqkv, bo = aligned16(bqkv.to(cd)), aligned16(bo.to(cd))
        scratch = proj_scratch(B, T, H, x) if scratch is None else scratch
    else:
        x = x.contiguous()
        wqkv, bqkv, wo, bo = (t.to(cd).contiguous() for t in (wqkv, bqkv, wo, bo))
    b3, row_stride, q_stride = _bias_operand(bias, B, T, x.device)
    live = tail_live_bytes(rows_live)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _kernels.launch(
            "fused_proj_attention", x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
            wo.data_ptr(), bo.data_ptr(), b3.data_ptr(), row_stride, q_stride,
            None if live is None else live.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            B, T, H, num_heads, float(1.0 / (H // num_heads) ** 0.5),
            *_dropout_args(seed, dropout_rate, row0), code, stream,
        )
    LAUNCHES[op] += 1
    return out


def fused_proj_attention(
    x: torch.Tensor,
    wqkv: torch.Tensor,
    bqkv: torch.Tensor,
    wo: torch.Tensor,
    bo: torch.Tensor,
    bias: Optional[torch.Tensor],
    *,
    num_heads: int,
    compute_dtype: torch.dtype,
    rows_live: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Self-attention sublayer ``out_proj(attention(x))``. x: [B, T, H];
    wqkv: [H, 3H] (q/k/v concatenated on the output axis); bqkv: [3H];
    wo: [H, H] (input-major); bo: [H]; bias: head-invariant, broadcastable
    to [B, 1, T, T]; rows_live: optional [B] bool, dead rows -> zeros.
    Returns [B, T, H] in x.dtype."""
    kw = dict(num_heads=num_heads, compute_dtype=compute_dtype, rows_live=rows_live)
    if _on_cpu(x, "fused_proj_attention"):
        return fused_proj_attention_plain(x, wqkv, bqkv, wo, bo, bias, **kw)
    return _launch_proj("fused_proj_attention", x, wqkv, bqkv, wo, bo, bias, **kw)


# --- projection + attention, train: hashed dropout and the backward -----------


def fused_proj_attention_train_plain(
    x, wqkv, bqkv, wo, bo, bias, seed: Optional[int], *, num_heads: int,
    dropout_rate: float, compute_dtype: torch.dtype, rows_live=None, row0: Rows = 0,
) -> torch.Tensor:
    """Plain PyTorch version of the train forward: the eval function with
    each probability multiplied by keep * 1/(1-rate) before the product with
    v, the keep bits those of the global rows [row0, row0 + B). Returns [B,
    T, H] in the compute dtype."""
    B, T, _ = x.shape
    keep = _keep_scale(seed, dropout_rate, B, num_heads, T, x.device, row0)
    return _proj_attention_plain(
        x, wqkv, bqkv, wo, bo, bias, keep, num_heads, compute_dtype, rows_live
    ).to(compute_dtype)


def fused_proj_attention_train_bwd_plain(
    x, wqkv, bqkv, wo, bias, g, seed: Optional[int], *, num_heads: int,
    dropout_rate: float, compute_dtype: torch.dtype, rows_live=None, row0: Rows = 0,
    head0: int = 0, heads: Optional[int] = None,
):
    """Plain PyTorch version of the backward kernel, step for step as
    ``_fused_proj_bwd_body``: (dqkv [B, T, 3Hq] in the compute dtype, dWo
    [Hq, H] f32, dbo [H] f32) with Hq = wo.shape[0]: H, or a model rank's
    H / M, whose heads are the global [head0, head0 + num_heads) of
    ``heads`` (row 4's partial mode). Dead rows get zero dqkv and add
    nothing to dWo and dbo: the forward's dead rows are constant zeros."""
    B, T, H = x.shape
    N = num_heads
    Hq = wo.shape[0]
    D = Hq // N
    cd = compute_dtype
    f32 = torch.float32
    q, k, v, p = _qkv_probs(x, wqkv, bqkv, bias, N, cd)
    g32 = _zero_dead_rows(g.to(cd).to(f32), rows_live)
    dattn = g32 @ wo.to(cd).to(f32).t()
    do = dattn.reshape(B, T, N, D).transpose(1, 2)
    dp = do @ v.transpose(-1, -2)
    pv = p
    keep = _keep_scale(seed, dropout_rate, B, N, T, x.device, row0, head0, heads)
    if keep is not None:
        pv = p * keep
        dp = dp * keep
    attn = (pv @ v).transpose(1, 2).reshape(B * T, Hq)
    dz = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    scale = 1.0 / D ** 0.5
    dq = (dz @ k) * scale
    dk = (dz.transpose(-1, -2) @ q) * scale
    dv = pv.transpose(-1, -2) @ do
    dqkv = torch.stack([dq, dk, dv], dim=2).permute(0, 3, 2, 1, 4).reshape(B, T, 3 * Hq)
    g2 = g32.reshape(B * T, H)
    dwo = attn.to(cd).to(f32).t() @ g2.to(cd).to(f32)
    dbo = g2.sum(dim=0)
    return dqkv.to(cd), dwo, dbo


def proj_bwd_weights(wqkv, wo, compute_dtype):
    """(Wqkv stored [3H, H], Wo stored [H_out, H_in]) in the compute dtype:
    the operands the bf16 backward (``csrc/fused_proj_attention_bwd.cu``
    ``launch_tc``) reads, Wqkv as a K-major and Wo as an MN-major B. For the
    views the model passes (``in_proj_weight.t()``, ``out_proj.weight.t()``)
    they are the parameters' own storage: no copy in the compute dtype, the
    one conversion otherwise."""
    return weight_storage(wqkv, compute_dtype), weight_storage(wo, compute_dtype)


# csrc/fused_proj_attention_bwd.cu launch_tc: the dWo/dbo GEMM's k step (the
# packed rows of a TMA box) and its splits over the packed rows, about
# _PROJ_BWD_SPLIT_TOKENS rows each, at most _PROJ_BWD_MAX_SPLITS of them.
_PROJ_BWD_STEP = 64
_PROJ_BWD_SPLIT_TOKENS = 1024
_PROJ_BWD_MAX_SPLITS = 8


def proj_bwd_splits(tokens: int):
    """(chunk, splits) of the bf16 backward's dWo/dbo products over
    ``tokens`` packed rows: chunks a multiple of 64 rows covering them all.
    From the token count alone, so the order of the ordered sums is fixed
    whatever rows are live."""
    splits = max(1, min(_PROJ_BWD_MAX_SPLITS, -(-tokens // _PROJ_BWD_SPLIT_TOKENS)))
    chunk = max(_PROJ_BWD_STEP, -(-tokens // (splits * _PROJ_BWD_STEP)) * _PROJ_BWD_STEP)
    return chunk, max(1, -(-tokens // chunk))


def _proj_bwd_layout(B: int, T: int, H: int, inner: Optional[int] = None):
    """Byte offsets of the bf16 backward's scratch regions (the rows, the dWo
    and the dbo partials) and its size; ``inner`` the q/k/v width Hq
    (default H; a model rank's H / M)."""
    Hq = H if inner is None else inner
    M = B * T
    _, splits = proj_bwd_splits(M)
    ints = M * (4 * H + 10 * Hq)
    partial = ints + -(-(B + 1) * 4 // 16) * 16
    partial_b = partial + splits * Hq * H * 4
    return ints, partial, partial_b, partial_b + splits * H * 4


def proj_bwd_scratch(B: int, T: int, H: int, x: torch.Tensor, inner: Optional[int] = None) -> torch.Tensor:
    """The bf16 projection+attention backward's scratch
    (``csrc/fused_proj_attention_bwd.cu`` ``launch_tc``): the packed x,
    overwritten by the packed attention output attn, and the packed g in
    bf16 [B*T, H] each, qkv [B*T, 3H] in bf16, do [B*T, H] in f32, then the
    packed rows [B] and their live count (int32), then the dWo partials
    [splits, H, H] and the dbo partials [splits, H] in f32: 0.77 GB at the
    512-clip spatial stage. Under the model axis (``inner`` = Hq = H / M)
    attn, qkv and do are Hq, 3Hq and Hq wide and the dWo partials [splits,
    Hq, H]."""
    return torch.empty(_proj_bwd_layout(B, T, H, inner)[3], dtype=torch.uint8, device=x.device)


def proj_bwd_scratch_views(scratch: torch.Tensor, B: int, T: int, H: int,
                           inner: Optional[int] = None) -> dict:
    """The regions of a :func:`proj_bwd_scratch` after a bf16 launch, by
    name: ``attn``, ``g``, ``qkv``, ``do`` (rows up to count*T are the packed
    rows', all B*T without rows_live, whose ``g`` region, ``rows`` and
    ``count`` stay unwritten: the kernels read g in place), ``rows`` (the
    live rows in order, then the dead), ``count``, ``partial`` [splits, H,
    H] (each split's dWo) and ``partial_b`` [splits, H] (each split's dbo);
    with ``inner`` = Hq those of the partial mode (attn, qkv and do Hq, 3Hq
    and Hq wide, ``partial`` [splits, Hq, H])."""
    Hq = H if inner is None else inner
    M = B * T
    ints, partial, partial_b, end = _proj_bwd_layout(B, T, H, Hq)
    bf_end = M * (4 * H + 6 * Hq)  # bytes of x / attn, g and qkv
    bf = scratch[:bf_end].view(torch.bfloat16)
    iv = scratch[ints:ints + (B + 1) * 4].view(torch.int32)
    return {
        "attn": bf[:M * Hq].view(M, Hq), "g": bf[M * H:2 * M * H].view(M, H),
        "qkv": bf[2 * M * H:].view(M, 3 * Hq),
        "do": scratch[bf_end:ints].view(torch.float32).view(M, Hq),
        "rows": iv[:B], "count": iv[B:],
        "partial": scratch[partial:partial_b].view(torch.float32).view(-1, Hq, H),
        "partial_b": scratch[partial_b:end].view(torch.float32).view(-1, H),
    }


def _launch_proj_bwd(x, wqkv, bqkv, wo, bias, g, seed, *, num_heads, dropout_rate,
                     compute_dtype, rows_live, scratch=None, row0: Rows = 0, head0: int = 0,
                     heads: Optional[int] = None):
    """Launch csrc/fused_proj_attention_bwd.cu. bf16 (``launch_tc``) reads
    Wqkv and Wo in place (:func:`proj_bwd_weights`) and works in ``scratch``
    (:func:`proj_bwd_scratch`; allocated when None): the row scan and the
    gather, the qkv and do GEMMs, the short-attention backward, the dWo/dbo
    GEMM into the scratch's split partials and the ordered sums. f32: the
    SIMT backward kernel, then the split dWo/dbo reduction over the
    attention scratch it writes into partials of their own, and the same
    ordered sums. wqkv [H, 3Hq], wo [Hq, H], dWo [Hq, H]: Hq = H in one
    process; under the model axis a rank's q/k/v width, its ``num_heads``
    heads hashed as the global heads from ``head0`` of ``heads`` (the whole
    N; default num_heads)."""
    op = "fused_proj_attention_train_bwd"
    B, T, H = x.shape
    Hq = wo.shape[0]
    code = _check_kernel_dtypes(op, compute_dtype, x)
    _check_partial_widths(op, H, Hq, num_heads)
    if not 1 <= T <= _KERNEL_MAX_SEQ:
        raise ValueError(f"{op}: the CUDA kernel takes T <= {_KERNEL_MAX_SEQ}, got T={T}")
    if wqkv.shape != (H, 3 * Hq) or bqkv.shape != (3 * Hq,) or wo.shape != (Hq, H):
        raise ValueError(f"{op}: weight shapes do not match H={H}, Hq={Hq}")
    cd = compute_dtype
    f32 = torch.float32
    tokens = B * T
    b3, row_stride, q_stride = _bias_operand(bias, B, T, x.device)
    dqkv = torch.empty((B, T, 3 * Hq), dtype=cd, device=x.device)
    dwo = torch.empty((Hq, H), dtype=f32, device=x.device)
    dbo = torch.empty((H,), dtype=f32, device=x.device)
    if code == _DTYPE_CODES[torch.bfloat16]:
        x, g = aligned16(x), aligned16(g.to(cd))
        wqkv, wo = proj_bwd_weights(wqkv, wo, cd)  # [3H, H], [H_out, H_in]
        bqkv = aligned16(bqkv.to(cd))
        live = tail_live_bytes(rows_live)
        chunk, splits = proj_bwd_splits(tokens)
        _, at_w, at_b, size = _proj_bwd_layout(B, T, H, Hq)
        if scratch is None:
            scratch = proj_bwd_scratch(B, T, H, x, Hq)
        elif scratch.nbytes < size or scratch.data_ptr() % 16:
            raise ValueError(f"{op}: the bf16 kernels take a 16-byte aligned scratch of "
                             f"{size} bytes (proj_bwd_scratch), got {scratch.nbytes}")
        partial_ptr, partial_b_ptr = scratch.data_ptr() + at_w, scratch.data_ptr() + at_b
    else:
        x = x.contiguous()
        g = g.to(cd).contiguous()
        wqkv = wqkv.to(cd).contiguous()
        bqkv = bqkv.to(cd).contiguous()
        wo = wo.to(cd).t().contiguous()  # Wo^T: out_proj.weight's layout
        live = _live_flags(rows_live, B)
        # Split the dWo reduction over token chunks until about two waves of
        # 64 x 64 tiles fill the card's 132 SMs, each chunk >= 256 tokens.
        tiles = (Hq // 64) * (H // 64)
        splits = max(1, min(-(-264 // tiles), -(-tokens // 256)))
        per_split = -(-tokens // splits)
        chunk = -(-per_split // 32) * 32
        scratch = torch.empty((tokens, Hq), dtype=cd, device=x.device)  # the attention output
        partial = torch.empty((splits, Hq, H), dtype=f32, device=x.device)
        partial_b = torch.empty((splits, H), dtype=f32, device=x.device)
        partial_ptr, partial_b_ptr = partial.data_ptr(), partial_b.data_ptr()
    ptrs = (x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wo.data_ptr(), b3.data_ptr(), row_stride,
            q_stride, g.data_ptr(), None if live is None else live.data_ptr(), dqkv.data_ptr(),
            scratch.data_ptr(), partial_ptr, partial_b_ptr, dwo.data_ptr(), dbo.data_ptr(), B, T, H)
    scale = float(1.0 / (Hq // num_heads) ** 0.5)
    drop = _dropout_args(seed, dropout_rate, row0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _kernels.launch("fused_proj_attention_bwd", *ptrs, Hq, num_heads, scale, *drop, head0,
                        num_heads if heads is None else heads, splits, chunk, code, stream)
    LAUNCHES[op] += 1
    return dqkv, dwo, dbo


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with f32 sums and an f32 result, as JAX's
    ``preferred_element_type=float32`` gives: bf16 operands on the card go
    to cuBLAS with an f32 output; on the CPU the operands are widened to f32
    (exact), which computes the same sums."""
    if a.device.type == "cuda" and a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.to(torch.float32) @ b.to(torch.float32)


def proj_input_grads(x, wqkv, dqkv, compute_dtype):
    """The three plain GEMMs after the backward kernel
    (``_fused_proj_train_bwd`` leaves them to XLA): dx = dqkv Wqkv^T in x's
    dtype, dWqkv = x^T dqkv and dbqkv = sum dqkv, both f32."""
    B, T, H = x.shape
    cd = compute_dtype
    d2 = dqkv.reshape(B * T, -1)
    dx = _mm_f32(d2, wqkv.to(cd).t()).reshape(B, T, H).to(x.dtype)
    dwqkv = _mm_f32(x.reshape(B * T, H).to(cd).t(), d2)
    return dx, dwqkv, d2.sum(dim=0, dtype=torch.float32)  # f32 sums, no f32 copy of dqkv


class _ProjAttentionTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wo, bo, bias, rows_live, seed, num_heads, dropout_rate,
                compute_dtype, row0=0):
        ctx.save_for_backward(x, wqkv, bqkv, wo, bias, rows_live)
        ctx.config = dict(num_heads=num_heads, dropout_rate=dropout_rate,
                          compute_dtype=compute_dtype, row0=row0)
        ctx.seed = seed
        kw = dict(ctx.config, rows_live=rows_live)
        if _on_cpu(x, "fused_proj_attention_train"):
            return fused_proj_attention_train_plain(x, wqkv, bqkv, wo, bo, bias, seed, **kw)
        return _launch_proj("fused_proj_attention_train", x, wqkv, bqkv, wo, bo, bias,
                            seed=seed, **kw)

    @staticmethod
    def backward(ctx, g):
        x, wqkv, bqkv, wo, bias, rows_live = ctx.saved_tensors
        kw = dict(ctx.config, rows_live=rows_live)
        # Converted once for the backward and proj_input_grads (the model's
        # in_proj_weight.t() keeps its transposed strides: the bf16 kernels
        # read that storage in place).
        wqkv = wqkv.to(ctx.config["compute_dtype"])
        if _on_cpu(g, "fused_proj_attention_train_bwd"):
            dqkv, dwo, dbo = fused_proj_attention_train_bwd_plain(
                x, wqkv, bqkv, wo, bias, g, ctx.seed, **kw)
        else:
            dqkv, dwo, dbo = _launch_proj_bwd(x, wqkv, bqkv, wo, bias, g, ctx.seed, **kw)
        dx, dwqkv, dbqkv = proj_input_grads(x, wqkv, dqkv, ctx.config["compute_dtype"])
        return dx, dwqkv, dbqkv, dwo, dbo, None, None, None, None, None, None, None


def fused_proj_attention_train(
    x: torch.Tensor,
    wqkv: torch.Tensor,
    bqkv: torch.Tensor,
    wo: torch.Tensor,
    bo: torch.Tensor,
    bias: Optional[torch.Tensor],
    seed: Optional[int],
    *,
    num_heads: int,
    dropout_rate: float,
    compute_dtype: torch.dtype,
    rows_live: Optional[torch.Tensor] = None,
    row0: Rows = 0,
) -> torch.Tensor:
    """Differentiable train-mode :func:`fused_proj_attention` with hashed
    probability dropout (``seed``: a uint32 or None for none; ``row0`` the
    global index of x's first row, at which the keep bits are hashed). x in the
    compute dtype; returns [B, T, H] in it. Forward and backward launch
    ``csrc/fused_proj_attention.cu`` (with dropout) and
    ``csrc/fused_proj_attention_bwd.cu`` on a CUDA tensor and take their
    plain versions on a CPU tensor; dx/dWqkv/dbqkv come from
    :func:`proj_input_grads`. The bias gets no gradient."""
    return _ProjAttentionTrain.apply(
        x, wqkv, bqkv, wo, bo, bias, rows_live, seed, num_heads, float(dropout_rate),
        compute_dtype, RowMap.of(row0),
    )


# --- layer tail: residual + LN1 -> FFN -> residual + LN2 ----------------------


def _layer_norm(r32: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    """flax LayerNorm on an f32 tensor: f32 stats, fast variance clipped at
    0, scale folded into the rsqrt."""
    mu = r32.mean(dim=-1, keepdim=True)
    var = torch.clamp((r32 * r32).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    mul = torch.rsqrt(var + eps) * scale.to(torch.float32)
    return (r32 - mu) * mul + bias.to(torch.float32)


def gelu(x: torch.Tensor, approximate: bool) -> torch.Tensor:
    """``jax.nn.gelu`` op for op in x's dtype: the constants are rounded to
    the dtype and every step rounds to it, as JAX computes a bf16 GELU (a
    GELU taken in f32 and rounded once differs from it in about half of the
    bf16 outputs)."""

    def const(v: float) -> float:
        return torch.tensor(v, dtype=x.dtype).item()

    if approximate:
        cube = x * x * x
        inner = const(math.sqrt(2.0 / math.pi)) * (x + const(0.044715) * cube)
        return x * (0.5 * (1.0 + torch.tanh(inner)))
    return (0.5 * x) * torch.special.erfc(-x * const(math.sqrt(0.5)))


def activation_fn(h: torch.Tensor, activation: str, gelu_approximate: bool) -> torch.Tensor:
    if activation == "gelu":
        return gelu(h, gelu_approximate)
    if activation == "relu":
        return F.relu(h)
    raise ValueError(f"unknown activation {activation}")


def _live_tokens(rows_live, tokens_live, B: int, T: int) -> Optional[torch.Tensor]:
    if tokens_live is not None:
        return tokens_live.reshape(B * T).to(torch.bool)
    if rows_live is not None:
        return rows_live.reshape(B).to(torch.bool).repeat_interleave(T)
    return None


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte aligned base: the bf16 layer tail
    reads its rows as 16-byte vectors and its matrices through TMA maps."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def weight_storage(w: torch.Tensor, cd) -> torch.Tensor:
    """``w.t()`` row-major in ``cd``, 16-byte aligned: the layout the
    layer-tail kernels read a weight in. For the model's ``linear.weight.t()``
    it is the weight's own storage (no copy in its dtype, the one conversion
    otherwise); a contiguous [in, out] weight is transposed in that
    conversion."""
    return aligned16(w.t().to(cd, memory_format=torch.contiguous_format))


def tail_live_bytes(live: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """[tokens] live flags as the layer-tail kernels read them: 0/1 bytes,
    16-byte aligned (a bool tensor is viewed, not copied)."""
    if live is None:
        return None
    live = live.reshape(-1).contiguous()
    return aligned16(live.view(torch.uint8) if live.dtype == torch.bool else (live != 0).to(torch.uint8))


def tail_scratch(tokens: int, H: int, FF: int, x: torch.Tensor) -> Optional[torch.Tensor]:
    """The bf16 layer-tail kernels' scratch (``csrc/fused_layer_tail.cu``
    ``launch_tc``): u [tokens, H] and h1 [tokens, FF] in bf16, which
    pass between its row and GEMM kernels with the live tokens packed, then
    the packed rows' token indices and their count (int32); None for the f32
    kernel, which keeps u and h1 on the chip."""
    if x.dtype != torch.bfloat16:
        return None
    nbytes = tokens * (H + FF) * 2 + (tokens + 1) * 4
    return torch.empty(nbytes, dtype=torch.uint8, device=x.device)


def proj_scratch(B: int, T: int, H: int, x: torch.Tensor, inner: Optional[int] = None) -> torch.Tensor:
    """The bf16 projection+attention kernels' scratch
    (``csrc/fused_proj_attention.cu`` ``launch_tc``): qkv [B*T, 3Hq] (Hq =
    ``inner``, H by default; a model rank's H / M in the partial mode), then
    the packed x [B*T, H], overwritten by o [B*T, Hq], in bf16, then the
    packed rows [B] and their live count (int32): 0.86 GB at the 1024-clip
    spatial stage."""
    Hq = H if inner is None else inner
    return torch.empty(B * T * (3 * Hq + H) * 2 + (B + 1) * 4, dtype=torch.uint8, device=x.device)


def proj_scratch_views(scratch: torch.Tensor, B: int, T: int, H: int):
    """(qkv [B*T, 3H], o [B*T, H], rows [B], count [1]) of a
    :func:`proj_scratch` after a bf16 launch: the first count*T rows of qkv
    and o are the packed rows' (all B*T without rows_live, whose rows and
    count stay unwritten); rows holds the live rows in order, then the dead
    ones."""
    M = B * T
    bf = scratch[:M * 4 * H * 2].view(torch.bfloat16)
    ints = scratch[M * 4 * H * 2:].view(torch.int32)
    return bf[:M * 3 * H].view(M, 3 * H), bf[M * 3 * H:].view(M, H), ints[:B], ints[B:B + 1]


def cross_scratch(B: int, T: int, S: int, H: int, x: torch.Tensor) -> torch.Tensor:
    """The cross-attention kernels' scratch: in bf16 (``launch_tc``) q
    [B*T, H], kv [B*S, 2H] and o [B*T, H]; in f32 kv [B*S, 2H]."""
    if x.dtype != torch.bfloat16:
        return torch.empty((B * S, 2 * H), dtype=x.dtype, device=x.device)
    return torch.empty((2 * B * T * H + 2 * B * S * H) * 2, dtype=torch.uint8, device=x.device)


def cross_scratch_views(scratch: torch.Tensor, B: int, T: int, S: int, H: int):
    """(q [B*T, H], kv [B*S, 2H], o [B*T, H]) of a bf16
    :func:`cross_scratch` after a launch."""
    bf = scratch.view(torch.bfloat16)
    q, kv = bf[:B * T * H], bf[B * T * H:B * T * H + 2 * B * S * H]
    return q.view(B * T, H), kv.view(B * S, 2 * H), bf[B * T * H + 2 * B * S * H:].view(B * T, H)


# --- the bf16 sublayers' stages, plain (csrc/sublayer.cuh) ----------------------


def live_rows_plain(rows_live: Optional[torch.Tensor], B: int, device=None):
    """(rows [B] int32, count): the live rows in order, then the dead ones
    in order, and the number of live rows, as the bf16 projection+attention
    packs them (``proj_live_rows_kernel``); rows_live None: every row."""
    idx = torch.arange(B, dtype=torch.int32, device=device)
    if rows_live is None:
        return idx, B
    live = rows_live.reshape(B).to(device=device, dtype=torch.bool)
    return torch.cat([idx[live], idx[~live]]), int(live.sum())


def projection_plain(a: torch.Tensor, w_stored: torch.Tensor, b: torch.Tensor, compute_dtype) -> torch.Tensor:
    """``a W^T + b`` in f32 for a weight stored [N, K] as the model holds it
    (``in_proj_weight`` or a row slice of it, ``out_proj.weight``): operands
    and bias rounded to the compute dtype, f32 sums; a projection GEMM of the
    bf16 kernels before its rounding (``sublayer.cuh::gemm_body``)."""
    cd = compute_dtype
    f32 = torch.float32
    return a.to(cd).to(f32) @ w_stored.to(cd).to(f32).t() + b.to(cd).to(f32)


def short_attention_plain(q, k, v, bias3, rows, *, num_heads: int, seed: Optional[int] = None,
                          dropout_rate: float = 0.0, row0: Rows = 0) -> torch.Tensor:
    """The short-attention stage (``sublayer.cuh::attn_body``) on packed
    rows. q [R, T, H], k and v [R, S, H] hold compute-dtype values; packed
    row r is the original row ``rows[r]`` (None: r), by which the bias3
    ([B or 1, T or 1, S] f32, :func:`_bias3`) and the dropout keep bits are
    indexed. f32 logits, a normalise-first softmax, each probability times
    keep * 1/(1-rate) with dropout. Returns o [R, T, H] rounded to q's
    dtype."""
    R, T, H = q.shape
    S = k.shape[1]
    N = num_heads
    D = H // N
    f32 = torch.float32
    orig = torch.arange(R, device=q.device) if rows is None else rows.to(q.device).long()

    def heads(t, L):
        return t.to(f32).reshape(R, L, N, D).transpose(1, 2)

    logits = (heads(q, T) @ heads(k, S).transpose(-1, -2)) * (1.0 / D ** 0.5)
    logits = logits + (bias3[orig] if bias3.shape[0] > 1 else bias3)[:, None]
    logits = logits - logits.amax(dim=-1, keepdim=True)
    probs = torch.exp(logits)
    probs = probs / probs.sum(dim=-1, keepdim=True)
    if seed is not None and dropout_rate > 0.0 and R:
        keep = hash_keep_mask(seed, int(orig.max()) + 1, N, T, S, dropout_rate, q.device,
                              row0)[orig]
        probs = probs * (keep.to(f32) * (1.0 / (1.0 - dropout_rate)))
    return (probs @ heads(v, S)).transpose(1, 2).reshape(R, T, H).to(q.dtype)


def fused_proj_attention_stages_plain(x, wqkv, bqkv, wo, bo, bias, *, num_heads: int,
                                      compute_dtype, rows_live=None, seed: Optional[int] = None,
                                      dropout_rate: float = 0.0, row0: Rows = 0) -> torch.Tensor:
    """The bf16 kernels' split (``csrc/fused_proj_attention.cu``
    ``launch_tc``) in plain PyTorch, stage by stage: pack the live rows,
    the QKV GEMM on their tokens (rounded to the compute dtype), the short
    attention on the packed rows (keep bits at the ORIGINAL rows), the out
    GEMM scattered back to the rows' own tokens, dead rows exact zeros.
    The function of :func:`fused_proj_attention_plain` (and, with a seed, of
    :func:`fused_proj_attention_train_plain`); returns f32."""
    B, T, H = x.shape
    cd = compute_dtype
    rows, count = live_rows_plain(rows_live, B, x.device)
    live = rows[:count].long()
    qkv = projection_plain(x[live].reshape(count * T, H), wqkv.t(), bqkv, cd).to(cd)
    q, k, v = qkv.reshape(count, T, 3 * H).split(H, dim=-1)
    o = short_attention_plain(q, k, v, _bias3(bias, B, T, x.device), live, num_heads=num_heads,
                              seed=seed, dropout_rate=dropout_rate, row0=row0)
    y = torch.zeros((B, T, H), dtype=torch.float32, device=x.device)
    y[live] = projection_plain(o.reshape(count * T, H), wo.t(), bo, cd).reshape(count, T, H)
    return y


def short_attention_bwd_plain(q, k, v, do, bias3, rows, *, num_heads: int, seed: Optional[int] = None,
                              dropout_rate: float = 0.0, row0: Rows = 0):
    """The short-attention backward stage of the bf16 backward
    (``csrc/fused_proj_attention_bwd.cu`` ``proj_bwd_attn_kernel``) on
    packed rows, step for step as ``_fused_proj_bwd_body``. q, k, v [R, T,
    H] hold compute-dtype values, do [R, T, H] is f32; packed row r is the
    original row ``rows[r]`` (None: r), by which the bias3 and the keep bits
    are indexed. Recomputes the f32 probabilities p (normalise-first), then
    dp = (do v^T) keep, pv = p keep (keep = keep bit * 1/(1-rate)), dz = p
    (dp - sum p dp), dq = dz k scale, dk = dz^T q scale, dv = pv^T do.
    Returns (dqkv [R, T, 3H] f32, attn [R, T, H] = pv v rounded to q's
    dtype)."""
    R, T, H = q.shape
    N = num_heads
    D = H // N
    f32 = torch.float32
    cd = q.dtype
    orig = torch.arange(R, device=q.device) if rows is None else rows.to(q.device).long()

    def heads(t):
        return t.to(f32).reshape(R, T, N, D).transpose(1, 2)

    q, k, v, do = heads(q), heads(k), heads(v), heads(do)
    scale = 1.0 / D ** 0.5
    logits = (q @ k.transpose(-1, -2)) * scale
    logits = logits + (bias3[orig] if bias3.shape[0] > 1 else bias3)[:, None]
    logits = logits - logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits)
    p = p / p.sum(dim=-1, keepdim=True)
    dp = do @ v.transpose(-1, -2)
    pv = p
    if seed is not None and dropout_rate > 0.0 and R:
        keep = hash_keep_mask(seed, int(orig.max()) + 1, N, T, T, dropout_rate, q.device,
                              row0)[orig]
        keep = keep.to(f32) * (1.0 / (1.0 - dropout_rate))
        pv = p * keep
        dp = dp * keep
    attn = (pv @ v).transpose(1, 2).reshape(R, T, H).to(cd)
    dz = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = (dz @ k) * scale
    dk = (dz.transpose(-1, -2) @ q) * scale
    dv = pv.transpose(-1, -2) @ do
    dqkv = torch.stack([dq, dk, dv], dim=2).permute(0, 3, 2, 1, 4).reshape(R, T, 3 * H)
    return dqkv, attn


def fused_proj_attention_train_bwd_stages_plain(x, wqkv, bqkv, wo, bias, g, seed: Optional[int], *,
                                                num_heads: int, dropout_rate: float, compute_dtype,
                                                rows_live=None, row0: Rows = 0):
    """The bf16 backward's split (``csrc/fused_proj_attention_bwd.cu``
    ``launch_tc``) in plain PyTorch, stage by stage: pack the live rows of x
    and g (g rounded to the compute dtype); qkv = round(x_p Wqkv + bqkv) on
    the packed tokens; do = g_p Wo^T in f32, no rounding (the contract keeps
    it f32); the short-attention backward on the packed rows with the keep
    bits at the ORIGINAL rows (:func:`short_attention_bwd_plain`); dqkv
    scattered back to the rows' own tokens in the compute dtype, dead rows
    zero; dWo = attn_p(cd)^T g_p and dbo = sum g_p over the packed tokens
    in f32. The function of :func:`fused_proj_attention_train_bwd_plain`;
    returns (dqkv, dWo, dbo)."""
    B, T, H = x.shape
    cd = compute_dtype
    f32 = torch.float32
    rows, count = live_rows_plain(rows_live, B, x.device)
    live = rows[:count].long()
    n = count * T
    gp = g[live].reshape(n, H).to(cd).to(f32)
    qkv = projection_plain(x[live].reshape(n, H), wqkv.t(), bqkv, cd).to(cd)
    do = gp @ wo.to(cd).to(f32).t()
    q, k, v = qkv.reshape(count, T, 3 * H).split(H, dim=-1)
    dqkv_p, attn = short_attention_bwd_plain(q, k, v, do.reshape(count, T, H), _bias3(bias, B, T, x.device),
                                             live, num_heads=num_heads, seed=seed,
                                             dropout_rate=dropout_rate, row0=row0)
    dqkv = torch.zeros((B, T, 3 * H), dtype=cd, device=x.device)
    dqkv[live] = dqkv_p.to(cd)
    dwo = attn.reshape(n, H).to(f32).t() @ gp
    return dqkv, dwo, gp.sum(dim=0)


def fused_cross_attention_stages_plain(x, ctx, wq, bq, wkv, bkv, wo, bo, bias, *, num_heads: int,
                                       compute_dtype) -> torch.Tensor:
    """The bf16 cross-attention kernels' split (``csrc/fused_cross_attention.cu``
    ``launch_tc``) in plain PyTorch: the q and kv GEMMs (rounded), the short
    attention over the real S keys, the out GEMM. The function of
    :func:`fused_cross_attention_plain`; returns f32."""
    B, T, H = x.shape
    S = ctx.shape[1]
    cd = compute_dtype
    q = projection_plain(x.reshape(B * T, H), wq.t(), bq, cd).to(cd).reshape(B, T, H)
    kv = projection_plain(ctx.reshape(B * S, H), wkv.t(), bkv, cd).to(cd).reshape(B, S, 2 * H)
    o = short_attention_plain(q, kv[..., :H], kv[..., H:], _bias3(bias, B, T, x.device, S), None,
                              num_heads=num_heads)
    return projection_plain(o.reshape(B * T, H), wo.t(), bo, cd).reshape(B, T, H)


def fused_layer_tail_plain(
    x: torch.Tensor,
    attn_out: torch.Tensor,
    n1_scale: torch.Tensor,
    n1_bias: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    n2_scale: torch.Tensor,
    n2_bias: torch.Tensor,
    *,
    eps: float,
    compute_dtype: torch.dtype,
    activation: str = "gelu",
    gelu_approximate: bool = False,
    rows_live: Optional[torch.Tensor] = None,
    tokens_live: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_layer_tail`."""
    B, T, H = x.shape
    cd = compute_dtype
    f32 = torch.float32
    r = x.to(cd) + attn_out.to(cd)
    u = _layer_norm(r.to(f32), n1_scale, n1_bias, eps).to(cd)
    h1 = (u.to(f32) @ w1.to(cd).to(f32) + b1.to(f32)).to(cd)
    h1 = activation_fn(h1, activation, gelu_approximate)
    h2 = (h1.to(f32) @ w2.to(cd).to(f32) + b2.to(f32)).to(cd)
    y = _layer_norm((u + h2).to(f32), n2_scale, n2_bias, eps)
    live = _live_tokens(rows_live, tokens_live, B, T)
    if live is not None:
        y = torch.where(live.reshape(B, T, 1), y, torch.zeros((), dtype=f32, device=y.device))
    return y.to(x.dtype)


def fused_layer_tail(
    x: torch.Tensor,
    attn_out: torch.Tensor,
    n1_scale: torch.Tensor,
    n1_bias: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    n2_scale: torch.Tensor,
    n2_bias: torch.Tensor,
    *,
    eps: float,
    compute_dtype: torch.dtype,
    activation: str = "gelu",
    gelu_approximate: bool = False,
    rows_live: Optional[torch.Tensor] = None,
    tokens_live: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``norm2(u + FFN(u))`` for ``u = norm1(x + attn_out)``. x/attn_out:
    [B, T, H]; w1: [H, FF]; w2: [FF, H] (input-major); rows_live: [B] or
    tokens_live: [B, T] bool, dead tokens -> zeros. Returns [B, T, H] in
    x.dtype."""
    kwargs = dict(
        eps=eps, compute_dtype=compute_dtype, activation=activation,
        gelu_approximate=gelu_approximate, rows_live=rows_live, tokens_live=tokens_live,
    )
    args = (x, attn_out, n1_scale, n1_bias, w1, b1, w2, b2, n2_scale, n2_bias)
    if _on_cpu(x, "fused_layer_tail"):
        return fused_layer_tail_plain(*args, **kwargs)
    op = "fused_layer_tail"
    B, T, H = x.shape
    FF = w1.shape[1]
    code = _check_tail_kernel(op, compute_dtype, H, w1, w2, x, attn_out)
    act = _act_code(activation, gelu_approximate)
    cd = compute_dtype
    f32 = torch.float32
    x, attn_out = aligned16(x), aligned16(attn_out)
    w1, w2 = weight_storage(w1, cd), weight_storage(w2, cd)  # [FF, H], [H, FF]
    vecs = [v.reshape(-1).to(f32).contiguous() for v in (n1_scale, n1_bias, b1, b2, n2_scale, n2_bias)]
    n1s, n1b, b1v, b2v, n2s, n2b = vecs
    live = tail_live_bytes(_live_tokens(rows_live, tokens_live, B, T))
    out = torch.empty_like(x)
    scratch = tail_scratch(B * T, H, FF, x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _kernels.launch(
            op, x.data_ptr(), attn_out.data_ptr(), n1s.data_ptr(), n1b.data_ptr(),
            w1.data_ptr(), b1v.data_ptr(), w2.data_ptr(), b2v.data_ptr(),
            n2s.data_ptr(), n2b.data_ptr(), None if live is None else live.data_ptr(),
            out.data_ptr(), None, None if scratch is None else scratch.data_ptr(),
            B * T, H, FF, float(eps), act, *_dropout_args(None, 0.0), code, stream,
        )
    LAUNCHES[op] += 1
    return out


# --- cross-attention (eval): queries from x, keys and values from a context ---


def fused_cross_attention_plain(
    x: torch.Tensor,
    ctx: torch.Tensor,
    wq: torch.Tensor,
    bq: torch.Tensor,
    wkv: torch.Tensor,
    bkv: torch.Tensor,
    wo: torch.Tensor,
    bo: torch.Tensor,
    bias: Optional[torch.Tensor],
    *,
    num_heads: int,
    compute_dtype: torch.dtype,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_cross_attention`, with the
    kernel contract's rounding points: the weights and biases rounded to
    the compute dtype, ``q`` and ``kv`` rounded after the f32 bias add,
    f32 logits and a normalise-first softmax, the heads' outputs rounded
    before ``Wo``."""
    return _cross_attention_plain(x, ctx, wq, bq, wkv, bkv, wo, bo, bias, num_heads,
                                  compute_dtype).to(x.dtype)


def _cross_attention_plain(x, ctx, wq, bq, wkv, bkv, wo, bo, bias, num_heads: int, cd):
    """The cross-attention's f32 output with its rounding points; the q/k/v
    width Hq = wq.shape[1] (H, or a model rank's H / M) and no ``bo`` when
    it is None (a partial)."""
    B, T, H = x.shape
    S = ctx.shape[1]
    N = num_heads
    Hq = wq.shape[1]
    D = Hq // N
    f32 = torch.float32

    def project(a, w, b):
        return (a.to(cd).to(f32) @ w.to(cd).to(f32) + b.to(cd).to(f32)).to(cd).to(f32)

    q = project(x, wq, bq).reshape(B, T, N, D).transpose(1, 2)
    kv = project(ctx, wkv, bkv)
    k = kv[..., :Hq].reshape(B, S, N, D).transpose(1, 2)
    v = kv[..., Hq:].reshape(B, S, N, D).transpose(1, 2)
    logits = (q @ k.transpose(-1, -2)) * (1.0 / D ** 0.5)
    logits = logits + _bias3(bias, B, T, x.device, S)[:, None]
    logits = logits - logits.amax(dim=-1, keepdim=True)
    probs = torch.exp(logits)
    probs = probs / probs.sum(dim=-1, keepdim=True)
    attn = (probs @ v).transpose(1, 2).reshape(B, T, Hq)
    y = attn.to(cd).to(f32) @ wo.to(cd).to(f32)
    return y if bo is None else y + bo.to(cd).to(f32)


def _check_cross_kernel(op: str, x, ctx, wq, bq, wkv, bkv, wo, bo, num_heads: int,
                        compute_dtype) -> int:
    """The dtype code of csrc/fused_cross_attention.cu; raises on what it
    does not take."""
    B, T, H = x.shape
    code = _check_kernel_dtypes(op, compute_dtype, x, ctx)
    _check_kernel_width(op, H)
    _check_kernel_heads(op, H, num_heads)
    S = ctx.shape[1]
    if ctx.dim() != 3 or ctx.shape[0] != B or ctx.shape[2] != H:
        raise ValueError(f"{op}: ctx [B={B}, S, H={H}] expected, got {tuple(ctx.shape)}")
    if not (1 <= T <= _KERNEL_MAX_SEQ and 1 <= S <= _KERNEL_MAX_SEQ):
        raise ValueError(f"{op}: the CUDA kernel takes T, S <= {_KERNEL_MAX_SEQ}, got T={T}, S={S}")
    if (wq.shape != (H, H) or bq.shape != (H,) or wkv.shape != (H, 2 * H) or bkv.shape != (2 * H,)
            or wo.shape != (H, H) or bo.shape != (H,)):
        raise ValueError(f"{op}: weight shapes do not match H={H}")
    return code


def fused_cross_attention(
    x: torch.Tensor,
    ctx: torch.Tensor,
    wq: torch.Tensor,
    bq: torch.Tensor,
    wkv: torch.Tensor,
    bkv: torch.Tensor,
    wo: torch.Tensor,
    bo: torch.Tensor,
    bias: Optional[torch.Tensor],
    *,
    num_heads: int,
    compute_dtype: torch.dtype,
) -> torch.Tensor:
    """Cross-attention sublayer ``out_proj(attention(q = x, k = v = ctx))``
    (eval). x: [B, T, H] queries; ctx: [B, S, H] keys and values, both in the
    compute dtype; wq: [H, H], wkv: [H, 2H] (k and v concatenated on the
    output axis), wo: [H, H] (input-major); bq [H], bkv [2H], bo [H]; bias:
    head-invariant, broadcastable to [B, 1, T, S]. Returns [B, T, H] in
    x.dtype. A CUDA tensor launches csrc/fused_cross_attention.cu (T, S <=
    64, head dim in ``_KERNEL_HEAD_DIMS``, H in 64 x ``_KERNEL_WIDTHS``) or raises; a CPU tensor
    takes :func:`fused_cross_attention_plain`."""
    args = (x, ctx, wq, bq, wkv, bkv, wo, bo, bias)
    kw = dict(num_heads=num_heads, compute_dtype=compute_dtype)
    if _on_cpu(x, "fused_cross_attention"):
        return fused_cross_attention_plain(*args, **kw)
    return _launch_cross(*args, **kw)


def _launch_cross(x, ctx, wq, bq, wkv, bkv, wo, bo, bias, *, num_heads, compute_dtype,
                  scratch=None) -> torch.Tensor:
    """Launch csrc/fused_cross_attention.cu. bf16 reads ``wq``, ``wkv`` and
    ``wo`` in the storage of the model's ``in_proj_weight[:H]``,
    ``in_proj_weight[H:]`` and ``out_proj.weight`` (no copy when the dtype
    matches) and works in ``scratch`` (:func:`cross_scratch`; allocated when
    None); f32 takes them input-major."""
    op = "fused_cross_attention"
    B, T, H = x.shape
    S = ctx.shape[1]
    code = _check_cross_kernel(op, x, ctx, wq, bq, wkv, bkv, wo, bo, num_heads, compute_dtype)
    cd = compute_dtype
    if code == _DTYPE_CODES[torch.bfloat16]:
        x, ctx = aligned16(x), aligned16(ctx)
        wq, wkv, wo = (weight_storage(w, cd) for w in (wq, wkv, wo))  # [H, H], [2H, H], [H, H]
        bq, bkv, bo = (aligned16(b.to(cd)) for b in (bq, bkv, bo))
    else:
        x, ctx = x.contiguous(), ctx.contiguous()
        wq, bq, wkv, bkv, wo, bo = (t.to(cd).contiguous() for t in (wq, bq, wkv, bkv, wo, bo))
    scratch = cross_scratch(B, T, S, H, x) if scratch is None else scratch
    b3, row_stride, q_stride = _bias_operand(bias, B, T, x.device, S)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _kernels.launch(
            op, x.data_ptr(), ctx.data_ptr(), wq.data_ptr(), bq.data_ptr(), wkv.data_ptr(),
            bkv.data_ptr(), wo.data_ptr(), bo.data_ptr(), b3.data_ptr(), row_stride, q_stride,
            scratch.data_ptr(), out.data_ptr(), B, T, S, H, num_heads,
            float(1.0 / (H // num_heads) ** 0.5), code, stream,
        )
    LAUNCHES[op] += 1
    return out


# --- the model axis: partial modes and their sum epilogues (rows 1, 2, 5) ------
#
# Under --model_parallel M a model rank holds N / M heads (q/k/v widths
# Hq = H / M) and FF / M hidden units, and the out-projection and linear2
# are row-parallel (``parallel/sharding.py``). Each row's partial mode stops
# before that product's sum: it returns the f32 partial o_m Wo_m (rows 1
# and 5) or h1_m W2_m (row 2), no bias, dead rows zeros. The caller sums
# the partials over the model group in f32 (``parallel/mesh.all_sum``: a
# bf16 sum would add a rounding point the contract lacks), then the sum
# epilogue adds the bias and rounds: a = round(s + bo) for rows 1 and 5
# (:func:`sublayer_sum`, dead rows exact zeros, not bo), and for row 2
# h2 = round(s + b2), r2 = round(u + h2), y = LN2(r2)
# (:func:`fused_layer_tail_sum`, dead tokens zeros). The column products
# still run over the whole K = H, so every shard computes one process's
# bits for its columns; only the row-parallel products sum in another
# order. Serving only: no dropout.


def _check_partial_widths(op: str, H: int, Hq: int, num_heads: int) -> None:
    """A model rank's widths the kernels take: H and Hq in 64 x
    ``_KERNEL_WIDTHS``, Hq / num_heads in ``_KERNEL_HEAD_DIMS``."""
    _check_kernel_width(op, H)
    _check_kernel_width(op, Hq)
    _check_kernel_heads(op, Hq, num_heads)


def fused_proj_attention_partial_plain(x, wqkv, bqkv, wo, bias, *, num_heads: int,
                                       compute_dtype: torch.dtype,
                                       rows_live: Optional[torch.Tensor] = None,
                                       seed: Optional[int] = None, dropout_rate: float = 0.0,
                                       row0: Rows = 0, head0: int = 0,
                                       heads: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_proj_attention_partial` (with
    ``seed`` and ``dropout_rate``: of the train forward's partial mode, the
    keep bits at the global rows from ``row0`` and the global heads
    [head0, head0 + num_heads) of ``heads``)."""
    B, T, _ = x.shape
    cd = compute_dtype
    f32 = torch.float32
    _, _, v, probs = _qkv_probs(x, wqkv, bqkv, bias, num_heads, cd)
    keep = _keep_scale(seed, dropout_rate, B, num_heads, T, x.device, row0, head0, heads)
    if keep is not None:
        probs = probs * keep
    attn = (probs @ v).transpose(1, 2).reshape(B, T, wo.shape[0])
    return _zero_dead_rows(attn.to(cd).to(f32) @ wo.to(cd).to(f32), rows_live)


def fused_proj_attention_partial(x, wqkv, bqkv, wo, bias, *, num_heads: int,
                                 compute_dtype: torch.dtype,
                                 rows_live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row 1's partial mode: a model rank's self-attention sublayer up to
    its out-projection's partial. x [B, T, H]; wqkv [H, 3Hq] (the rank's q,
    k and v columns, each Hq = N Hd / M wide), bqkv [3Hq], wo [Hq, H]
    (input-major: the rank's rows of Wo); num_heads the rank's N / M.
    Returns the f32 partial o_m Wo_m [B, T, H], dead rows zeros; the sum of
    the model ranks' partials goes to :func:`sublayer_sum`. A CUDA tensor
    launches csrc/fused_proj_attention.cu's partial mode or raises."""
    kw = dict(num_heads=num_heads, compute_dtype=compute_dtype, rows_live=rows_live)
    if _on_cpu(x, "fused_proj_attention"):
        return fused_proj_attention_partial_plain(x, wqkv, bqkv, wo, bias, **kw)
    return _launch_proj_partial(x, wqkv, bqkv, wo, bias, **kw)


def _launch_proj_partial(x, wqkv, bqkv, wo, bias, *, num_heads, compute_dtype, rows_live,
                         scratch=None, train: bool = False, seed: Optional[int] = None,
                         dropout_rate: float = 0.0, row0: Rows = 0, head0: int = 0,
                         heads: Optional[int] = None) -> torch.Tensor:
    """Launch ``stlt_fused_proj_attention_partial``: row 1's partial mode, or
    with ``train`` row 3's (counted as ``fused_proj_attention_train``), the
    probabilities dropped with ``seed`` and ``dropout_rate``, the heads
    hashed as the global heads from ``head0`` of ``heads`` (default
    num_heads)."""
    op = "fused_proj_attention_train" if train else "fused_proj_attention"
    B, T, H = x.shape
    Hq = wo.shape[0]
    code = _check_kernel_dtypes(op, compute_dtype, x)
    _check_partial_widths(op, H, Hq, num_heads)
    if not 1 <= T <= _KERNEL_MAX_SEQ:
        raise ValueError(f"{op}: the CUDA kernel takes T <= {_KERNEL_MAX_SEQ}, got T={T}")
    if wqkv.shape != (H, 3 * Hq) or bqkv.shape != (3 * Hq,) or wo.shape != (Hq, H):
        raise ValueError(f"{op}: partial weight shapes do not match H={H}, Hq={Hq}")
    cd = compute_dtype
    bf16 = code == _DTYPE_CODES[torch.bfloat16]
    if bf16:
        x = aligned16(x)
        wqkv, wo = weight_storage(wqkv, cd), weight_storage(wo, cd)  # [3Hq, H], [H, Hq]
        bqkv = aligned16(bqkv.to(cd))
        scratch = proj_scratch(B, T, H, x, Hq) if scratch is None else scratch
    else:
        x = x.contiguous()
        wqkv, bqkv, wo = (t.to(cd).contiguous() for t in (wqkv, bqkv, wo))
    b3, row_stride, q_stride = _bias_operand(bias, B, T, x.device)
    live = tail_live_bytes(rows_live)
    # bf16 scatters the live rows only: the dead ones start as zeros.
    alloc = torch.zeros if bf16 and live is not None else torch.empty
    out = alloc((B, T, H), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _kernels.launch(
            "fused_proj_attention_partial", x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
            wo.data_ptr(), b3.data_ptr(), row_stride, q_stride,
            None if live is None else live.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            B, T, H, Hq, num_heads, float(1.0 / (Hq // num_heads) ** 0.5),
            *_dropout_args(seed, dropout_rate, row0), head0,
            num_heads if heads is None else heads, code, stream,
        )
    LAUNCHES[op] += 1
    return out


class _ProjAttentionTrainPartial(torch.autograd.Function):
    """Row 3's partial mode and row 4's: a model rank's heads of the train
    sublayer up to the f32 partial o_m Wo_m, and its backward for the
    cotangent of the ranks' summed partials (the same on every rank)."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wo, bias, rows_live, seed, num_heads, dropout_rate,
                compute_dtype, row0, head0, heads):
        ctx.save_for_backward(x, wqkv, bqkv, wo, bias, rows_live)
        ctx.config = dict(num_heads=num_heads, dropout_rate=dropout_rate,
                          compute_dtype=compute_dtype, row0=row0, head0=head0, heads=heads)
        ctx.seed = seed
        kw = dict(ctx.config, rows_live=rows_live, seed=seed)
        if _on_cpu(x, "fused_proj_attention_train"):
            return fused_proj_attention_partial_plain(x, wqkv, bqkv, wo, bias, **kw)
        return _launch_proj_partial(x, wqkv, bqkv, wo, bias, train=True, **kw)

    @staticmethod
    def backward(ctx, g):
        x, wqkv, bqkv, wo, bias, rows_live = ctx.saved_tensors
        kw = dict(ctx.config, rows_live=rows_live)
        wqkv = wqkv.to(ctx.config["compute_dtype"])
        g = g.to(ctx.config["compute_dtype"])  # the out GEMM's operand, as row 4 takes it
        if _on_cpu(g, "fused_proj_attention_train_bwd"):
            dqkv, dwo, _ = fused_proj_attention_train_bwd_plain(x, wqkv, bqkv, wo, bias, g, ctx.seed, **kw)
        else:
            dqkv, dwo, _ = _launch_proj_bwd(x, wqkv, bqkv, wo, bias, g, ctx.seed, **kw)
        dx, dwqkv, dbqkv = proj_input_grads(x, wqkv, dqkv, ctx.config["compute_dtype"])
        return dx, dwqkv, dbqkv, dwo, None, None, None, None, None, None, None, None, None


def fused_proj_attention_train_partial(x, wqkv, bqkv, wo, bias, seed: Optional[int], *, num_heads: int,
                                       dropout_rate: float, compute_dtype: torch.dtype,
                                       rows_live: Optional[torch.Tensor] = None, row0: Rows = 0,
                                       head0: int = 0, heads: Optional[int] = None) -> torch.Tensor:
    """Differentiable row 3 partial mode: :func:`fused_proj_attention_partial`
    with the train forward's hashed probability dropout, the rank's
    ``num_heads`` heads hashed as the global heads [head0, head0 +
    num_heads) of ``heads`` (the model's N; default num_heads) at the
    global rows from ``row0``. Returns the f32 partial [B, T, H] (no bo)
    for the model group's sum and :func:`sublayer_sum`. Its backward takes
    the cotangent of that sum and launches row 4 at the rank's width and
    head base on a CUDA tensor, the plain backward on a CPU one: dWqkv_m,
    dbqkv_m and dWo_m are the rank's whole shard gradients; dx is the
    rank's part, which the caller sums over the model group (``parallel/mesh.model_copy``)."""
    return _ProjAttentionTrainPartial.apply(
        x, wqkv, bqkv, wo, bias, rows_live, seed, num_heads, float(dropout_rate), compute_dtype,
        RowMap.of(row0), int(head0), num_heads if heads is None else int(heads))


def sublayer_sum_plain(s, bo, *, compute_dtype: torch.dtype,
                       rows_live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`sublayer_sum`."""
    f32 = torch.float32
    y = (s.to(f32) + bo.to(compute_dtype).to(f32)).to(compute_dtype)
    return _zero_dead_rows(y, rows_live)


def _sublayer_sum(s, bo, compute_dtype, rows_live, op) -> torch.Tensor:
    name = f"{op}_sum"
    if _on_cpu(s, name):
        return sublayer_sum_plain(s, bo, compute_dtype=compute_dtype, rows_live=rows_live)
    B, T, H = s.shape
    code = _check_kernel_dtypes(name, compute_dtype)
    if s.dtype != torch.float32 or bo.shape != (H,):
        raise ValueError(f"{name}: f32 sums [B, T, H] and bo [H] expected")
    s = s.contiguous()
    bo = bo.to(compute_dtype).contiguous()
    live = tail_live_bytes(rows_live)
    out = torch.empty((B, T, H), dtype=compute_dtype, device=s.device)
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        _kernels.launch(name, s.data_ptr(), bo.data_ptr(), None if live is None else live.data_ptr(),
                        out.data_ptr(), B, T, H, code, stream)
    SUM_LAUNCHES[name] += 1
    return out


class _SublayerSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s, bo, compute_dtype, rows_live, op):
        ctx.save_for_backward(rows_live)
        return _sublayer_sum(s, bo, compute_dtype, rows_live, op)

    @staticmethod
    def backward(ctx, g):
        (rows_live,) = ctx.saved_tensors
        ds = _zero_dead_rows(g.to(torch.float32), rows_live)
        return ds, ds.sum(dim=(0, 1)), None, None, None


def sublayer_sum(s, bo, *, compute_dtype: torch.dtype, rows_live: Optional[torch.Tensor] = None,
                 op: str = "fused_proj_attention") -> torch.Tensor:
    """The sum epilogue of rows 1 and 5 (``op``): a = round(s + bo) in the
    compute dtype from the model ranks' summed f32 partials s [B, T, H]
    (bo [H] rounded to the compute dtype first, as the one-process out GEMM
    takes it); rows whose ``rows_live`` flag is 0 are exact zeros. A CUDA
    tensor launches the row's ``*_sum`` kernel (``csrc/<op>.cu``). Its
    gradient (training, row 3's partial mode) passes straight through the
    rounding: ds = g and dbo = sum g over the live rows, both f32; dead rows
    get zeros."""
    return _SublayerSum.apply(s, bo, compute_dtype, rows_live, op)


def fused_cross_attention_partial_plain(x, ctx, wq, bq, wkv, bkv, wo, bias, *, num_heads: int,
                                        compute_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_cross_attention_partial`."""
    return _cross_attention_plain(x, ctx, wq, bq, wkv, bkv, wo, None, bias, num_heads, compute_dtype)


def fused_cross_attention_partial(x, ctx, wq, bq, wkv, bkv, wo, bias, *, num_heads: int,
                                  compute_dtype: torch.dtype) -> torch.Tensor:
    """Row 5's partial mode: a model rank's cross-attention up to its
    out-projection's partial. wq [H, Hq], bq [Hq], wkv [H, 2Hq] (the rank's
    k and v columns), bkv [2Hq], wo [Hq, H] input-major; num_heads the
    rank's N / M. Returns the f32 partial [B, T, H] for
    :func:`sublayer_sum` (``op="fused_cross_attention"``). A CUDA tensor
    launches csrc/fused_cross_attention.cu's partial mode or raises."""
    args = (x, ctx, wq, bq, wkv, bkv, wo, bias)
    kw = dict(num_heads=num_heads, compute_dtype=compute_dtype)
    if _on_cpu(x, "fused_cross_attention"):
        return fused_cross_attention_partial_plain(*args, **kw)
    return _launch_cross_partial(*args, **kw)


def _launch_cross_partial(x, ctx, wq, bq, wkv, bkv, wo, bias, *, num_heads, compute_dtype,
                          scratch=None) -> torch.Tensor:
    op = "fused_cross_attention"
    B, T, H = x.shape
    S = ctx.shape[1]
    Hq = wq.shape[1]
    code = _check_kernel_dtypes(op, compute_dtype, x, ctx)
    _check_partial_widths(op, H, Hq, num_heads)
    if ctx.dim() != 3 or ctx.shape[0] != B or ctx.shape[2] != H:
        raise ValueError(f"{op}: ctx [B={B}, S, H={H}] expected, got {tuple(ctx.shape)}")
    if not (1 <= T <= _KERNEL_MAX_SEQ and 1 <= S <= _KERNEL_MAX_SEQ):
        raise ValueError(f"{op}: the CUDA kernel takes T, S <= {_KERNEL_MAX_SEQ}, got T={T}, S={S}")
    if (wq.shape != (H, Hq) or bq.shape != (Hq,) or wkv.shape != (H, 2 * Hq)
            or bkv.shape != (2 * Hq,) or wo.shape != (Hq, H)):
        raise ValueError(f"{op}: partial weight shapes do not match H={H}, Hq={Hq}")
    cd = compute_dtype
    if code == _DTYPE_CODES[torch.bfloat16]:
        x, ctx = aligned16(x), aligned16(ctx)
        wq, wkv, wo = (weight_storage(w, cd) for w in (wq, wkv, wo))  # [Hq, H], [2Hq, H], [H, Hq]
        bq, bkv = (aligned16(b.to(cd)) for b in (bq, bkv))
    else:
        x, ctx = x.contiguous(), ctx.contiguous()
        wq, bq, wkv, bkv, wo = (t.to(cd).contiguous() for t in (wq, bq, wkv, bkv, wo))
    scratch = cross_scratch(B, T, S, Hq, x) if scratch is None else scratch
    b3, row_stride, q_stride = _bias_operand(bias, B, T, x.device, S)
    out = torch.empty((B, T, H), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _kernels.launch(
            "fused_cross_attention_partial", x.data_ptr(), ctx.data_ptr(), wq.data_ptr(),
            bq.data_ptr(), wkv.data_ptr(), bkv.data_ptr(), wo.data_ptr(), b3.data_ptr(),
            row_stride, q_stride, scratch.data_ptr(), out.data_ptr(), B, T, S, H, Hq, num_heads,
            float(1.0 / (Hq // num_heads) ** 0.5), code, stream,
        )
    LAUNCHES[op] += 1
    return out


def fused_layer_tail_partial_plain(x, attn_out, n1_scale, n1_bias, w1, b1, w2, *, eps: float,
                                   compute_dtype: torch.dtype, activation: str = "gelu",
                                   gelu_approximate: bool = False):
    """Plain PyTorch version of :func:`fused_layer_tail_partial`: (the f32
    partial [B, T, H], u [B, T, H] in the compute dtype)."""
    cd = compute_dtype
    f32 = torch.float32
    u = _layer_norm((x.to(cd) + attn_out.to(cd)).to(f32), n1_scale, n1_bias, eps).to(cd)
    h1 = activation_fn((u.to(f32) @ w1.to(cd).to(f32) + b1.to(f32)).to(cd), activation,
                       gelu_approximate)
    return h1.to(f32) @ w2.to(cd).to(f32), u


def fused_layer_tail_partial(x, attn_out, n1_scale, n1_bias, w1, b1, w2, *, eps: float,
                             compute_dtype: torch.dtype, activation: str = "gelu",
                             gelu_approximate: bool = False, rows_live=None, tokens_live=None):
    """Row 2's partial mode: a model rank's layer tail up to linear2's
    partial. w1 [H, FF/M] and b1 [FF/M] (the rank's hidden units), w2
    [FF/M, H] input-major. u = LN1(x + attn_out) and h1 = act(round(u W1 +
    b1)) are one process's bits for these units (K = H). Returns (the f32
    partial h1 W2 [B, T, H], no b2; u, what :func:`fused_layer_tail_sum`
    reads: u itself on the CPU, on the card the kernels' scratch, which
    holds it). Every token is computed, dead ones too (the epilogue zeroes
    them). A CUDA tensor launches csrc/fused_layer_tail.cu's partial mode
    or raises."""
    kw = dict(eps=eps, compute_dtype=compute_dtype, activation=activation,
              gelu_approximate=gelu_approximate)
    args = (x, attn_out, n1_scale, n1_bias, w1, b1, w2)
    if _on_cpu(x, "fused_layer_tail"):
        return fused_layer_tail_partial_plain(*args, **kw)
    op = "fused_layer_tail"
    B, T, H = x.shape
    FF = w1.shape[1]
    code = _check_tail_kernel(op, compute_dtype, H, w1, w2, x, attn_out)
    act = _act_code(activation, gelu_approximate)
    cd = compute_dtype
    f32 = torch.float32
    x, attn_out = aligned16(x), aligned16(attn_out)
    w1, w2 = weight_storage(w1, cd), weight_storage(w2, cd)  # [FF/M, H], [H, FF/M]
    n1s, n1b, b1v = (v.reshape(-1).to(f32).contiguous() for v in (n1_scale, n1_bias, b1))
    live = tail_live_bytes(_live_tokens(rows_live, tokens_live, B, T))
    out = torch.empty((B, T, H), dtype=f32, device=x.device)
    # bf16: u and h1 in the scratch (u at its head); f32: u alone, in f32.
    scratch = tail_scratch(B * T, H, FF, x)
    if scratch is None:
        scratch = torch.empty((B * T, H), dtype=f32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _kernels.launch(
            "fused_layer_tail_partial", x.data_ptr(), attn_out.data_ptr(), n1s.data_ptr(),
            n1b.data_ptr(), w1.data_ptr(), b1v.data_ptr(), w2.data_ptr(),
            None if live is None else live.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            B * T, H, FF, float(eps), act, code, stream,
        )
    LAUNCHES[op] += 1
    return out, scratch


def fused_layer_tail_sum_plain(s, u, b2, n2_scale, n2_bias, *, eps: float, compute_dtype: torch.dtype,
                               rows_live=None, tokens_live=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_layer_tail_sum`."""
    B, T, H = s.shape
    cd = compute_dtype
    f32 = torch.float32
    h2 = (s.to(f32) + b2.to(f32)).to(cd)
    y = _layer_norm((u.to(cd) + h2).to(f32), n2_scale, n2_bias, eps)
    live = _live_tokens(rows_live, tokens_live, B, T)
    if live is not None:
        y = torch.where(live.reshape(B, T, 1), y, torch.zeros((), dtype=f32, device=y.device))
    return y.to(cd)


def fused_layer_tail_sum(s, u, b2, n2_scale, n2_bias, *, eps: float, compute_dtype: torch.dtype,
                         rows_live=None, tokens_live=None) -> torch.Tensor:
    """Row 2's sum epilogue: from the model ranks' summed f32 partials s
    [B, T, H] and the u of :func:`fused_layer_tail_partial`, h2 = round(s +
    b2), r2 = round(u + h2), y = LN2(r2) in the compute dtype; dead tokens
    exact zeros. A CUDA tensor launches ``fused_layer_tail_sum``
    (csrc/fused_layer_tail.cu), a row kernel."""
    kw = dict(eps=eps, compute_dtype=compute_dtype, rows_live=rows_live, tokens_live=tokens_live)
    if _on_cpu(s, "fused_layer_tail_sum"):
        return fused_layer_tail_sum_plain(s, u, b2, n2_scale, n2_bias, **kw)
    name = "fused_layer_tail_sum"
    B, T, H = s.shape
    code = _check_kernel_dtypes(name, compute_dtype)
    _check_kernel_width(name, H)
    f32 = torch.float32
    if s.dtype != f32:
        raise ValueError(f"{name}: f32 sums expected, got {s.dtype}")
    s = s.contiguous()
    b2v, n2s, n2b = (v.reshape(-1).to(f32).contiguous() for v in (b2, n2_scale, n2_bias))
    live = tail_live_bytes(_live_tokens(rows_live, tokens_live, B, T))
    out = torch.empty((B, T, H), dtype=compute_dtype, device=s.device)
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        _kernels.launch(name, s.data_ptr(), u.data_ptr(), b2v.data_ptr(), n2s.data_ptr(),
                        n2b.data_ptr(), None if live is None else live.data_ptr(), out.data_ptr(),
                        B * T, H, float(eps), code, stream)
    SUM_LAUNCHES[name] += 1
    return out
