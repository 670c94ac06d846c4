"""Attention core on projected q, k, v: the eval half of ``stlt_tpu/ops/flash.py``.

Port of ``flash_attention`` (:1030), ``_lengths_dense_bias`` (:1094),
``_broadcast_bias`` (:1112) and the dispatch of ``_flash_forward``
(:1122-1148): ``max(T, S) >= _BLOCKWISE_MIN_SEQ = 513`` takes the blockwise
kernel (``_blockwise_attn_kernel`` :397, here in its lengths mode), anything
shorter the short kernel (``_fused_attn_kernel`` :119). Layout ``[B, T, N,
D]`` as in JAX.

Each kernel has three parts, as in ``ops/fused_encoder.py``:

- the wrapper (:func:`fused_attention`, :func:`blockwise_attention`): a CUDA
  tensor launches the hand-written kernel (``csrc/flash_attention.cu``,
  ``csrc/blockwise_attention.cu``) or raises; a CPU tensor takes the plain
  version. The device alone decides; there is no fallback;
- the plain PyTorch version (``*_plain``) of the same function;
- a launch count in :data:`LAUNCHES`, raised by one where the wrapper
  launches its kernel and nowhere else.

Numerics, the JAX kernels' contract: q, k and v are promoted to f32; logits
(``q k^T * 1/sqrt(D) + bias``), softmax and the PV product are f32; the
output is rounded to v's dtype. Biases are finite: -1e9 from the masks,
``_NEG_INF = -1e30`` from the lengths mode. The kernels take the softmax
online over key chunks, which differs from normalising first only in
rounding.

Lengths mode (``kv_lengths`` [B] int, optional ``causal``): key s of clip b
is live iff ``s < kv_lengths[b]`` (and ``s <= t``). On the blockwise path the
bias is generated in the kernel, no [B, 1, T, S] array exists, and query rows
``t >= kv_lengths[b]`` (pad frames) come out as exact zeros with lse 0. That
is stricter than JAX's block-granular "unspecified but finite" rows
(:1070-1077) and exact for the model: the temporal tail zeroes dead tokens
and the logits read only the extract row. Below 513 tokens the lengths become
the dense bias (``_lengths_dense_bias``) and every row is computed, as in
JAX.

Not ported yet, and refused on a CUDA tensor with the ``ROADMAP.md`` item
each waits for: probability dropout (hashed seed or mask operand) and the
dense-bias mode of the blockwise kernel (B4/B5, the long-context train
slice). The ring ``offsets`` mode (A9) is refused on every device. The plain
versions compute dropout and the dense-bias blockwise function, so the CPU
path stays whole.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from stlt_tpu_torch.ops import _kernels
from stlt_tpu_torch.ops.dropout import hash_keep_mask

LAUNCHES = {"flash_attention": 0, "blockwise_attention": 0}

_BLOCKWISE_MIN_SEQ = 513
_NEG_INF = -1e30  # finite: exp(-1e30 - m) == 0 without inf - inf NaNs
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIM = 64

_LATER = {
    "dropout": "attention-probability dropout is not ported to the CUDA kernels yet: "
               "it waits for ROADMAP.md item {item} (the long-context train slice)",
    "dense": "the dense-bias mode of the blockwise kernel is not ported yet: it waits for "
             "ROADMAP.md item B5 (rest); pass kv_lengths (+ causal)",
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cpu(x: torch.Tensor, op: str) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise RuntimeError(f"{op}: no kernel for device {x.device}")


def _lengths_dense_bias(kv_lengths, T: int, S: int, causal: bool) -> torch.Tensor:
    """Dense [B, 1, T, S] (causal) or [B, 1, 1, S] f32 bias equal to the
    lengths mode: 0 where key s is live, ``_NEG_INF`` elsewhere."""
    lengths = torch.as_tensor(kv_lengths).to(torch.int64)
    cols = torch.arange(S, device=lengths.device)
    valid = cols[None, :] < lengths[:, None]  # [B, S]
    zero = torch.zeros((), dtype=torch.float32, device=lengths.device)
    if causal:
        rows = torch.arange(T, device=lengths.device)
        valid = valid[:, None, :] & (cols[None, None, :] <= rows[None, :, None])
        return torch.where(valid, zero, zero + _NEG_INF)[:, None]
    return torch.where(valid, zero, zero + _NEG_INF)[:, None, None, :]


def _broadcast_bias(bias, B: int, T: int, S: int) -> torch.Tensor:
    """The additive bias as an f32 [B, bn, T, S] view (bn = 1 when it is
    head-invariant); broadcast dims are expanded with stride 0, not copied."""
    if bias is None:
        return torch.zeros((), dtype=torch.float32).expand(B, 1, T, S)
    b = bias.to(torch.float32)
    while b.dim() < 4:
        b = b[None]
    return b.expand(B, b.shape[1], T, S)


def _check_dropout(dropout_mask, dropout_rate: float, dropout_seed) -> bool:
    """Whether probability dropout is on; a mask and a seed together raise."""
    if dropout_mask is not None and dropout_seed is not None:
        raise ValueError("pass a dropout mask OR a dropout seed, not both")
    return dropout_mask is not None or (dropout_seed is not None and dropout_rate > 0.0)


def _check_bias(bias, kv_lengths) -> None:
    if bias is not None and kv_lengths is not None:
        raise ValueError("pass a dense bias OR kv_lengths (+ causal), not both")


def _softmax_parts(q, k, v, bias, dropout_mask, dropout_rate, dropout_seed):
    """f32 (probabilities [B, N, T, S], after dropout; values [B, N, S, D];
    the row max and the row sum of exp, each [B, N, T])."""
    B, T, N, D = q.shape
    S = k.shape[1]
    f32 = torch.float32
    qt, kt, vt = (x.to(f32).transpose(1, 2) for x in (q, k, v))
    logits = (qt @ kt.transpose(-1, -2)) * (1.0 / D ** 0.5)
    logits = logits + _broadcast_bias(bias, B, T, S).to(q.device)
    m = logits.amax(dim=-1, keepdim=True)
    probs = torch.exp(logits - m)
    l = probs.sum(dim=-1, keepdim=True)
    probs = probs / l
    if dropout_mask is not None:
        probs = probs * (dropout_mask.to(f32) * (1.0 / (1.0 - dropout_rate)))
    elif dropout_seed is not None and dropout_rate > 0.0:
        keep = hash_keep_mask(dropout_seed, B, N, T, S, dropout_rate, q.device).to(f32)
        probs = probs * (keep * (1.0 / (1.0 - dropout_rate)))
    return probs, vt, m[..., 0], l[..., 0]


def fused_attention_plain(q, k, v, bias=None, *, dropout_mask=None, dropout_rate: float = 0.0,
                          dropout_seed=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_attention`."""
    _check_dropout(dropout_mask, dropout_rate, dropout_seed)
    probs, vt, _, _ = _softmax_parts(q, k, v, bias, dropout_mask, dropout_rate, dropout_seed)
    return (probs @ vt).transpose(1, 2).to(v.dtype)


def blockwise_attention_plain(q, k, v, *, bias=None, kv_lengths=None, causal: bool = False,
                              dropout_mask=None, dropout_rate: float = 0.0, dropout_seed=None,
                              offsets=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`blockwise_attention`: (out [B, T, N, D]
    in v's dtype, lse [B, N, T] f32). In lengths mode the dead query rows
    ``t >= kv_lengths[b]`` are zeros with lse 0."""
    _check_dropout(dropout_mask, dropout_rate, dropout_seed)
    _refuse_offsets(offsets)
    _check_bias(bias, kv_lengths)
    T, S = q.shape[1], k.shape[1]
    if kv_lengths is not None:
        bias = _lengths_dense_bias(kv_lengths.to(q.device), T, S, causal)
    probs, vt, m, l = _softmax_parts(q, k, v, bias, dropout_mask, dropout_rate, dropout_seed)
    out = (probs @ vt).transpose(1, 2)
    lse = m + torch.log(l)
    if kv_lengths is not None:
        live = torch.arange(T, device=q.device)[None, :] < kv_lengths.to(q.device)[:, None]  # [B, T]
        zero = torch.zeros((), dtype=torch.float32, device=q.device)
        out = torch.where(live[:, :, None, None], out, zero)
        lse = torch.where(live[:, None, :], lse, zero)
    return out.to(v.dtype), lse


def _refuse_offsets(offsets) -> None:
    if offsets is not None:
        raise NotImplementedError(
            "the ring (sequence-parallel) offsets mode is not ported yet: it waits for "
            "ROADMAP.md item A9"
        )


# --- the kernels' wrappers ------------------------------------------------------


def _check_qkv(op: str, q, k, v) -> int:
    """Dtype, shape and layout checks of both kernels; returns the dtype
    code. q/k/v are read through their strides: the last dim contiguous,
    every stride and the base 16-byte aligned (one cp.async per 16 bytes)."""
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{op}: the CUDA kernel takes q, k, v all float32 or all bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or (
            k.shape[0], k.shape[2], k.shape[3]) != (q.shape[0], q.shape[2], q.shape[3]):
        raise ValueError(f"{op}: q [B, T, N, D] and k, v [B, S, N, D] expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, N, D = q.shape
    if D != _KERNEL_HEAD_DIM:
        raise ValueError(f"{op}: the CUDA kernel takes head dim {_KERNEL_HEAD_DIM}, got D={D}")
    if min(B, T, N, k.shape[1]) < 1:
        raise ValueError(f"{op}: empty input {tuple(q.shape)}, {tuple(k.shape)}")
    align = 16 // q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{op}: q, k, v must be on one device")
        if x.stride(3) != 1 or any(s % align for s in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(f"{op}: {name} must have a contiguous head dim and 16-byte "
                             f"aligned strides, got strides {x.stride()}")
    return _DTYPE_CODES[q.dtype]


def _strides(x):
    return x.stride(0), x.stride(1), x.stride(2)


def fused_attention(q, k, v, bias=None, *, dropout_mask=None, dropout_rate: float = 0.0,
                    dropout_seed=None) -> torch.Tensor:
    """``softmax(q k^T / sqrt(D) + bias) v`` over whole rows (the short
    kernel, 65-512 tokens in the models). q: [B, T, N, D]; k, v: [B, S, N,
    D], read through their strides; bias: f32, broadcastable to [B, N, T,
    S]. Returns [B, T, N, D] contiguous in v's dtype."""
    if _on_cpu(q, "flash_attention"):
        return fused_attention_plain(q, k, v, bias, dropout_mask=dropout_mask,
                                     dropout_rate=dropout_rate, dropout_seed=dropout_seed)
    op = "flash_attention"
    if _check_dropout(dropout_mask, dropout_rate, dropout_seed):
        raise NotImplementedError(f"{op}: " + _LATER["dropout"].format(item="B4 (rest)"))
    code = _check_qkv(op, q, k, v)
    B, T, N, D = q.shape
    S = k.shape[1]
    b4 = None
    strides = (0, 0, 0)
    if bias is not None:
        b4 = _broadcast_bias(bias.to(q.device), B, T, S)
        if b4.shape[1] not in (1, N):
            raise ValueError(f"{op}: bias {tuple(bias.shape)} does not broadcast to [{B}, {N}, {T}, {S}]")
        if b4.stride(3) != 1:
            b4 = b4.contiguous()
        strides = tuple(0 if b4.shape[i] == 1 else b4.stride(i) for i in range(3))
    out = torch.empty((B, T, N, D), dtype=v.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _kernels.launch(
            "flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *_strides(q), *_strides(k), *_strides(v),
            None if b4 is None else b4.data_ptr(), *strides, out.data_ptr(),
            B, T, S, N, D, float(1.0 / D ** 0.5), code, stream,
        )
    LAUNCHES[op] += 1
    return out


def blockwise_attention(q, k, v, *, bias=None, kv_lengths=None, causal: bool = False,
                        dropout_mask=None, dropout_rate: float = 0.0, dropout_seed=None,
                        offsets=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The blockwise kernel (``_blockwise_forward``): online softmax over key
    chunks, in lengths mode on the card. q: [B, T, N, D]; k, v: [B, S, N,
    D]; kv_lengths: [B] int. Key chunks above the diagonal (``causal``) or at
    and past the clip's length are skipped, dead query rows are zeros with
    lse 0 and whole dead query tiles skip all compute. Returns (out [B, T,
    N, D] in v's dtype, lse [B, N, T] f32)."""
    _refuse_offsets(offsets)
    kw = dict(bias=bias, kv_lengths=kv_lengths, causal=causal, dropout_mask=dropout_mask,
              dropout_rate=dropout_rate, dropout_seed=dropout_seed)
    if _on_cpu(q, "blockwise_attention"):
        return blockwise_attention_plain(q, k, v, **kw)
    op = "blockwise_attention"
    if _check_dropout(dropout_mask, dropout_rate, dropout_seed):
        raise NotImplementedError(f"{op}: " + _LATER["dropout"].format(item="B5 (rest)"))
    if kv_lengths is None:
        raise NotImplementedError(f"{op}: " + _LATER["dense"])
    code = _check_qkv(op, q, k, v)
    B, T, N, D = q.shape
    S = k.shape[1]
    if tuple(kv_lengths.shape) != (B,):
        raise ValueError(f"{op}: kv_lengths of shape [{B}] expected, got {tuple(kv_lengths.shape)}")
    lengths = kv_lengths.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, T, N, D), dtype=v.dtype, device=q.device)
    lse = torch.empty((B, N, T), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _kernels.launch(
            "blockwise_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *_strides(q), *_strides(k), *_strides(v), lengths.data_ptr(), int(bool(causal)),
            out.data_ptr(), lse.data_ptr(), B, T, S, N, D, float(1.0 / D ** 0.5), code, stream,
        )
    LAUNCHES[op] += 1
    return out, lse


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    dropout_mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    causal: bool = False,
    kv_lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """q: [B, T, N, D]; k, v: [B, S, N, D]; bias broadcastable to [B, N, T,
    S], or ``kv_lengths`` [B] int (+ ``causal``) for the key-padding+causal
    form. ``causal`` declares that the bias is causal; in lengths mode it
    also masks keys above the diagonal. Returns [B, T, N, D] in v's dtype.
    From 513 tokens on the blockwise kernel runs (in lengths mode on the
    card), below it the short kernel; see the module docstring for the dead
    rows of the lengths mode."""
    _check_dropout(dropout_mask, dropout_rate, dropout_seed)
    _check_bias(bias, kv_lengths)
    kw = dict(dropout_mask=dropout_mask, dropout_rate=dropout_rate, dropout_seed=dropout_seed)
    T, S = q.shape[1], k.shape[1]
    if max(T, S) >= _BLOCKWISE_MIN_SEQ:
        return blockwise_attention(q, k, v, bias=bias, kv_lengths=kv_lengths, causal=causal, **kw)[0]
    if kv_lengths is not None:
        bias = _lengths_dense_bias(kv_lengths.to(q.device), T, S, causal)
    return fused_attention(q, k, v, bias, **kw)
