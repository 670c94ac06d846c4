"""Attention core on projected q, k, v: ``stlt_tpu/ops/flash.py``, forward and
backward.

Port of ``flash_attention`` (:1030), ``_lengths_dense_bias`` (:1094),
``_broadcast_bias`` (:1112), the dispatch of ``_flash_forward`` (:1122-1148)
and the custom VJP ``_flash_custom`` / ``_flash_fwd`` / ``_flash_bwd``
(:1105-1110, :1288-1337): ``max(T, S) >= _BLOCKWISE_MIN_SEQ = 513`` takes the
blockwise kernels (``_blockwise_attn_kernel`` :397 forward, in its lengths
and its dense-bias mode; ``_blockwise_dq_kernel`` :655 and
``_blockwise_dkdv_kernel`` :745 backward, in the same two modes; both also
in the ring-offset mode of ``ops/ring.py``), anything
shorter the short kernels (``_fused_attn_kernel`` :119 and
``_fused_bwd_kernel`` :166). Layout ``[B, T, N, D]`` as in JAX.

Each kernel has three parts, as in ``ops/fused_encoder.py``:

- the wrapper (:func:`fused_attention`, :func:`blockwise_attention`,
  :func:`fused_attention_bwd`, :func:`blockwise_attention_bwd`): a CUDA
  tensor launches the hand-written kernel (``csrc/flash_attention.cu``,
  ``csrc/blockwise_attention.cu`` and their ``*_bwd.cu``) or raises; a CPU
  tensor takes the plain version. The device alone decides; there is no
  fallback;
- the plain PyTorch version (``*_plain``, :func:`attention_bwd_plain`) of
  the same function;
- a launch count in :data:`LAUNCHES`, raised by one where the wrapper
  launches its kernel (a backward call launches its dq and dk/dv kernels
  and counts once) and nowhere else; the blockwise forward and backward
  count their lengths modes as ``blockwise_attention`` and
  ``blockwise_attention_bwd``, their dense-bias modes as
  ``blockwise_attention_dense`` and ``blockwise_attention_bwd_dense``, and
  their ring-offset modes as ``blockwise_attention_offsets`` and
  ``blockwise_attention_bwd_offsets``; a launch with a dropout mask counts
  as ``<kernel>_mask`` instead (``flash_attention_mask``,
  ``blockwise_attention_mask``, ``flash_attention_bwd_mask``,
  ``blockwise_attention_bwd_mask``), in whatever mode it runs.

Gradients. When q, k or v needs a gradient, :func:`flash_attention` runs the
``torch.autograd.Function`` ``_Attention`` over the short or the blockwise
kernels. The forward saves
``(q, k, v, lse, out)`` and the seed; the backward computes ``dsum =
rowsum(dO o out)`` in f32 from the stored output (rounded to bf16 in bf16
runs, as JAX's blockwise path takes it; JAX's short path takes ``rowsum(p o
dp)`` instead, the same value up to rounding) and calls the backward
wrapper: ``p = exp(z - lse)``, ``dp = (dO v^T) o keepc``, ``dz = p o (dp -
dsum)``, ``dq = dz k * scale``, ``dk = dz^T q * scale``, ``dv = (p o
keepc)^T dO``, all in f32, rounded to the input dtype. On the CPU the same
Function runs the plain forward and :func:`attention_bwd_plain`, so the CPU
path takes the same decomposition (saved lse, dsum, dead-row masking), not
autograd through the plain forward. Bias and lengths get no gradient, as
in JAX.

Numerics, the JAX kernels' contract: q, k and v are promoted to f32; logits
(``q k^T * 1/sqrt(D) + bias``), softmax and the PV product are f32; the
output is rounded to v's dtype. Biases are finite: -1e9 from the masks,
``_NEG_INF = -1e30`` from the lengths mode. The kernels take the softmax
online over key chunks, which differs from normalising first only in
rounding. Probability dropout hashes its keep bits from a seed
(``ops/dropout.py``, in the kernels ``common.cuh``): the normalised
probabilities are dropped and survivors scaled by ``1/(1 - rate)``; lse is
dropout-free.

Lengths mode (``kv_lengths`` [B] int, optional ``causal``): key s of clip b
is live iff ``s < kv_lengths[b]`` (and ``s <= t``). On the blockwise path the
bias is generated in the kernel, no [B, 1, T, S] array exists, and query rows
``t >= kv_lengths[b]`` (pad frames) come out as exact zeros with lse 0. That
is stricter than JAX's block-granular "unspecified but finite" rows
(:1070-1077) and exact for the model: the temporal tail zeroes dead tokens
and the logits read only the extract row. Those rows are constants of the
forward, so the backward treats their p and dO as 0: their dq is exactly
zero and they add nothing to dk and dv, whatever the cotangent sent into
them (JAX's rule that dead rows' cotangents count as zero). Below 513 tokens
the lengths become the dense bias (``_lengths_dense_bias``) and every row is
computed, as in JAX.

Dense-bias mode of the blockwise kernels (``bias``, no ``kv_lengths``; the
fusion models at 512 layout frames, served and trained): an f32 bias
broadcastable to [B, N, T, S] read through its strides, every query row
computed, lse written, T and S free (33 against 513 and back); with
``causal`` the caller declares the bias causal and key chunks above the
diagonal are skipped (forward and dq), and query tiles above it (dk, dv),
as JAX's ``_causal_live`` skips them.

Ring-offset mode of the blockwise kernels (``offsets`` = (row0, col0) with
``kv_lengths``; one call per step of ``ops/ring.py``'s forward and of its
backward, JAX's ``off_base``):
local query t and key s are the global row0 + t and col0 + s, so key s is
live iff col0 + s < kv_lengths[b] (and col0 + s <= row0 + t with
``causal``), and the dead rows are those with row0 + t >= kv_lengths[b]
(zeros, lse 0). A live row with no live key in the held chunk is zeros with
lse ``_NEG_INF``: JAX forces its first key block live, so such a row gets a
finite output and an lse near -1e30, and the ring's cross-chunk merge wipes
both out. The dropout bits hash the local (t, s). The backward reads the
ring's global lse, finite on every live row, so such a row gets p = 0 in
the chunk; JAX's ring steps compute the dead rows in full where the port
takes their p and dO as 0, which agree for a cotangent that is zero on them
(the model's is).

Dropout-mask operand (``dropout_mask``, JAX's :1055-1057; no model passes
one, the models hash their bits from a seed): the caller's keep bits
[B, 1|N, T, S] (0/1, any dtype; a [B, 1, T, S] mask is shared by the heads),
scaled by ``1/(1 - dropout_rate)`` wherever they keep, as JAX scales them
(:1130-1131). Every kernel takes it in every mode (the short kernels, the
blockwise lengths, dense-bias and ring-offset modes, forward and backward):
the wrapper hands the kernel a uint8 view with a contiguous last dim and its
(b, n, t) strides (n's 0 when the heads share it), reading a bool or uint8
mask in place, so a ring step's column view ``dropout_mask[..., cols]`` is
passed as it is, its s the chunk-local key. A mask equal to
``hash_keep_mask(seed, ...)`` gives the seed's output and gradients: the
same keep bits through the same arithmetic. A mask whose shape is not [B,
1 or N, T, S] raises, on the CPU as on the card.

The head dim D is 32, 64 or 128 on a CUDA tensor (``_KERNEL_HEAD_DIMS``);
the CPU path takes any.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from stlt_tpu_torch.ops import _kernels
from stlt_tpu_torch.ops.dropout import MASK32, RowMap, dropout_thresh, hash_keep_mask

LAUNCHES = {"flash_attention": 0, "blockwise_attention": 0, "blockwise_attention_dense": 0,
            "blockwise_attention_offsets": 0, "flash_attention_bwd": 0,
            "blockwise_attention_bwd": 0, "blockwise_attention_bwd_dense": 0,
            "blockwise_attention_bwd_offsets": 0, "flash_attention_mask": 0,
            "blockwise_attention_mask": 0, "flash_attention_bwd_mask": 0,
            "blockwise_attention_bwd_mask": 0}

_BLOCKWISE_MIN_SEQ = 513
_NEG_INF = -1e30  # finite: exp(-1e30 - m) == 0 without inf - inf NaNs
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (32, 64, 128)


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


def _offsets_bias(kv_lengths, T: int, S: int, causal: bool, offsets) -> torch.Tensor:
    """The ring-offset mode's dense [B, 1, T, S] f32 bias: 0 where local key
    s is live for local query t at global (row0 + t, col0 + s), ``_NEG_INF``
    elsewhere."""
    row0, col0 = offsets
    lengths = torch.as_tensor(kv_lengths).to(torch.int64)
    cols = torch.arange(S, device=lengths.device) + col0
    valid = (cols[None, :] < lengths[:, None])[:, None, :].expand(-1, T, -1)  # [B, T, S]
    if causal:
        rows = torch.arange(T, device=lengths.device) + row0
        valid = valid & (cols[None, None, :] <= rows[None, :, None])
    zero = torch.zeros((), dtype=torch.float32, device=lengths.device)
    return torch.where(valid, zero, zero + _NEG_INF)[:, None]


def _ring_offsets(offsets) -> Tuple[int, int]:
    """(row0, col0) as Python ints from a pair or a [2] tensor."""
    row0, col0 = (int(v) for v in (offsets.tolist() if torch.is_tensor(offsets) else offsets))
    if row0 < 0 or col0 < 0:
        raise ValueError(f"ring offsets must be >= 0, got {(row0, col0)}")
    return row0, col0


def _live_rows(kv_lengths, T: int, device, row0: int = 0) -> torch.Tensor:
    """[B, T] bool: query row t of clip b is live iff row0 + t < kv_lengths[b]."""
    return torch.arange(T, device=device)[None, :] + row0 < kv_lengths.to(device)[:, None]


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


def check_mask(op: str, dropout_mask, B: int, N: int, T: int, S: int) -> None:
    """Raise unless the dropout mask is [B, 1 or N, T, S]."""
    shape = tuple(dropout_mask.shape)
    if len(shape) != 4 or shape[0] != B or shape[1] not in (1, N) or shape[2:] != (T, S):
        raise ValueError(f"{op}: dropout_mask must be [B, 1 or N, T, S] = [{B}, 1 or {N}, {T}, "
                         f"{S}], got {list(shape)}")


def _keepc(B, N, T, S, device, dropout_mask, dropout_rate, dropout_seed, dropout_row0: int = 0,
           dropout_head0: int = 0, dropout_heads: Optional[int] = None):
    """The scaled keep mask [B, N, T, S] f32 (keep * 1/(1 - rate)), or None
    without dropout; a seed's bits hashed at the global rows from
    ``dropout_row0`` and the global heads from ``dropout_head0`` of
    ``dropout_heads`` (default N)."""
    if dropout_mask is not None:
        check_mask("attention", dropout_mask, B, N, T, S)
        keep = dropout_mask.to(device=device, dtype=torch.float32)
    elif dropout_seed is not None and dropout_rate > 0.0:
        keep = hash_keep_mask(int(dropout_seed), B, N, T, S, dropout_rate, device,
                              dropout_row0, dropout_head0, dropout_heads).to(torch.float32)
    else:
        return None
    return keep * (1.0 / (1.0 - dropout_rate))


def _softmax_parts(q, k, v, bias, dropout_mask, dropout_rate, dropout_seed, dropout_row0=0,
                   dropout_head0=0, dropout_heads=None):
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
    keepc = _keepc(B, N, T, S, q.device, dropout_mask, dropout_rate, dropout_seed, dropout_row0,
                   dropout_head0, dropout_heads)
    if keepc is not None:
        probs = probs * keepc
    return probs, vt, m[..., 0], l[..., 0]


def fused_attention_plain(q, k, v, bias=None, *, dropout_mask=None, dropout_rate: float = 0.0,
                          dropout_seed=None, with_lse: bool = False, dropout_row0: int = 0,
                          dropout_head0: int = 0, dropout_heads: Optional[int] = None):
    """Plain PyTorch version of :func:`fused_attention`."""
    _check_dropout(dropout_mask, dropout_rate, dropout_seed)
    probs, vt, m, l = _softmax_parts(q, k, v, bias, dropout_mask, dropout_rate, dropout_seed,
                                     dropout_row0, dropout_head0, dropout_heads)
    out = (probs @ vt).transpose(1, 2).to(v.dtype)
    return (out, m + torch.log(l)) if with_lse else out


def blockwise_attention_plain(q, k, v, *, bias=None, kv_lengths=None, causal: bool = False,
                              dropout_mask=None, dropout_rate: float = 0.0, dropout_seed=None,
                              offsets=None, dropout_row0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`blockwise_attention`: (out [B, T, N, D]
    in v's dtype, lse [B, N, T] f32). In lengths mode the dead query rows
    ``row0 + t >= kv_lengths[b]`` are zeros with lse 0; with ring offsets a
    live row with no live key is zeros with lse ``_NEG_INF``."""
    _check_dropout(dropout_mask, dropout_rate, dropout_seed)
    _check_bias(bias, kv_lengths)
    if offsets is not None and kv_lengths is None:
        raise ValueError("ring offsets require kv_lengths")
    T, S = q.shape[1], k.shape[1]
    row0 = 0
    if offsets is not None:
        row0, col0 = _ring_offsets(offsets)
        bias = _offsets_bias(kv_lengths.to(q.device), T, S, causal, (row0, col0))
    elif kv_lengths is not None:
        bias = _lengths_dense_bias(kv_lengths.to(q.device), T, S, causal)
    probs, vt, m, l = _softmax_parts(q, k, v, bias, dropout_mask, dropout_rate, dropout_seed,
                                     dropout_row0)
    out = (probs @ vt).transpose(1, 2)
    lse = m + torch.log(l)
    if kv_lengths is not None:
        zero = torch.zeros((), dtype=torch.float32, device=q.device)
        if offsets is not None:  # live rows with no live key in this chunk
            none = (bias[:, 0] == _NEG_INF).all(-1)  # [B, T]
            out = torch.where(none[:, :, None, None], zero, out)
            lse = torch.where(none[:, None, :], zero + _NEG_INF, lse)
        live = _live_rows(kv_lengths, T, q.device, row0)
        out = torch.where(live[:, :, None, None], out, zero)
        lse = torch.where(live[:, None, :], lse, zero)
    return out.to(v.dtype), lse


def attention_bwd_plain(q, k, v, dout, lse, dsum, *, bias=None, kv_lengths=None,
                        causal: bool = False, dropout_mask=None, dropout_rate: float = 0.0,
                        dropout_seed=None, offsets=None, dropout_row0: int = 0, dropout_head0: int = 0,
                        dropout_heads: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of both backward kernels: (dq, dk, dv) in q's,
    k's and v's dtypes, from the forward's lse [B, N, T] and dsum =
    rowsum(dO o out) [B, N, T] (see the module docstring). In lengths mode
    the dead query rows' p and dO are taken as 0; ``offsets`` (row0, col0)
    take the mask and the dead rows at global indices (one ring step, whose
    lse is the ring's global one)."""
    _check_bias(bias, kv_lengths)
    if offsets is not None and kv_lengths is None:
        raise ValueError("ring offsets require kv_lengths")
    B, T, N, D = q.shape
    S = k.shape[1]
    f32 = torch.float32
    scale = 1.0 / D ** 0.5
    qt, kt, vt, dot = (x.to(f32).transpose(1, 2) for x in (q, k, v, dout))
    zero = torch.zeros((), dtype=f32, device=q.device)
    row0 = 0
    if offsets is not None:
        row0, col0 = _ring_offsets(offsets)
        bias = _offsets_bias(kv_lengths.to(q.device), T, S, causal, (row0, col0))
    elif kv_lengths is not None:
        bias = _lengths_dense_bias(kv_lengths.to(q.device), T, S, causal)
    z = (qt @ kt.transpose(-1, -2)) * scale + _broadcast_bias(bias, B, T, S).to(q.device)
    p = torch.exp(z - lse[..., None])
    ds = dsum[..., None]
    if kv_lengths is not None:
        live = _live_rows(kv_lengths, T, q.device, row0)[:, None, :, None]  # [B, 1, T, 1]
        p = torch.where(live, p, zero)
        dot = torch.where(live, dot, zero)
        ds = torch.where(live, ds, zero)
    dp = dot @ vt.transpose(-1, -2)
    pk = p
    keepc = _keepc(B, N, T, S, q.device, dropout_mask, dropout_rate, dropout_seed, dropout_row0,
                   dropout_head0, dropout_heads)
    if keepc is not None:
        pk = p * keepc
        dp = dp * keepc
    dz = p * (dp - ds)
    dq = (dz @ kt) * scale
    dk = (dz.transpose(-1, -2) @ qt) * scale
    dv = pk.transpose(-1, -2) @ dot
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def _dsum(dout, out, kv_lengths, row0: int = 0) -> torch.Tensor:
    """rowsum(dO o out) [B, N, T] in f32 from the stored output; 0 on the
    lengths mode's dead rows ``row0 + t >= kv_lengths[b]`` (whatever dO
    holds there)."""
    dsum = (dout.to(torch.float32) * out.to(torch.float32)).sum(-1).transpose(1, 2)
    if kv_lengths is None:
        return dsum.contiguous()
    live = _live_rows(kv_lengths, out.shape[1], out.device, row0)[:, None, :]
    return torch.where(live, dsum, torch.zeros((), dtype=torch.float32, device=out.device))


# --- the kernels' wrappers ------------------------------------------------------


def _check_heads(op: str, q, k, v, dout=None) -> int:
    """Dtype, shape and layout checks of the kernels; returns the dtype
    code. q/k/v (and dO) are read through their strides: the last dim
    contiguous, every stride and the base 16-byte aligned (one cp.async per
    16 bytes)."""
    named = [("q", q), ("k", k), ("v", v)] + ([("dO", dout)] if dout is not None else [])
    if len({x.dtype for _, x in named}) != 1 or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{op}: the CUDA kernel takes {', '.join(n for n, _ in named)} all float32 "
                        f"or all bfloat16, got {', '.join(str(x.dtype) for _, x in named)}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or (
            k.shape[0], k.shape[2], k.shape[3]) != (q.shape[0], q.shape[2], q.shape[3]) or (
            dout is not None and dout.shape != q.shape):
        raise ValueError(f"{op}: q [B, T, N, D] and k, v [B, S, N, D] expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, N, D = q.shape
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"{op}: the CUDA kernel takes head dim in {_KERNEL_HEAD_DIMS}, got D={D}")
    if min(B, T, N, k.shape[1]) < 1:
        raise ValueError(f"{op}: empty input {tuple(q.shape)}, {tuple(k.shape)}")
    align = 16 // q.element_size()
    for name, x in named:
        if x.device != q.device:
            raise ValueError(f"{op}: {', '.join(n for n, _ in named)} must be on one device")
        if x.stride(3) != 1 or any(s % align for s in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(f"{op}: {name} must have a contiguous head dim and 16-byte "
                             f"aligned strides, got strides {x.stride()}")
    return _DTYPE_CODES[q.dtype]


def _strides(x):
    return x.stride(0), x.stride(1), x.stride(2)


def mask_bytes(dropout_mask) -> torch.Tensor:
    """The keep bits as a uint8 tensor, read in place where the mask is bool
    or uint8 (a view, no copy), else converted once."""
    if dropout_mask.dtype == torch.bool:
        return dropout_mask.view(torch.uint8)
    if dropout_mask.dtype == torch.uint8:
        return dropout_mask
    return (dropout_mask != 0).to(torch.uint8)


def _dropout_args(op: str, dropout_mask, dropout_rate: float, dropout_seed, q, S: int,
                  dropout_row0: int = 0):
    """(the kernels' dropout arguments: on, seed, thresh, scale, the row
    base (the global index of q's first row, mod 2**32; 0 in mask mode,
    whose mask holds the rows' own bits), then the mask's pointer (or None)
    and its (b, n, t) element strides, n's 0 when the heads share it; the
    uint8 mask the pointer reads, kept alive by the caller until the launch,
    or None)."""
    if dropout_mask is None:
        if dropout_seed is None or dropout_rate <= 0.0:
            return (0, 0, 0, 0.0, 0, None, 0, 0, 0), None
        base = RowMap.of(dropout_row0)
        if not base.affine:
            raise ValueError(f"{op}: the long-clip attention kernels hash at contiguous rows "
                             f"(an affine row map), got {base}")
        return (1, int(dropout_seed) & MASK32, dropout_thresh(dropout_rate),
                1.0 / (1.0 - dropout_rate), base.offset & MASK32, None, 0, 0, 0), None
    B, T, N, _ = q.shape
    check_mask(op, dropout_mask, B, N, T, S)
    if dropout_mask.device != q.device:
        raise ValueError(f"{op}: dropout_mask must be on {q.device}, got {dropout_mask.device}")
    m = mask_bytes(dropout_mask)
    if m.stride(3) != 1:
        m = m.contiguous()
    mn = 0 if m.shape[1] == 1 else m.stride(1)
    return (1, 0, 0, 1.0 / (1.0 - dropout_rate), 0, m.data_ptr(), m.stride(0), mn, m.stride(2)), m


def _with_heads(drop, N: int, head0: int, heads: Optional[int]):
    """The short kernels' dropout words: :func:`_dropout_args`' with the
    head base and the whole head count after the row base (the launch's
    heads are [head0, head0 + N) of ``heads``, default N)."""
    heads = N if heads is None else heads
    if not 0 <= head0 <= heads - N:
        raise ValueError(f"dropout heads [{head0}, {head0 + N}) do not lie in the {heads}")
    return (*drop[:5], head0, heads, *drop[5:])


def _bias_view(op, bias, B, N, T, S, device):
    """(the f32 bias as a [B, bn, T, S] view with a contiguous last dim or
    None, its (b, n, t) strides with 0 for broadcast dims)."""
    if bias is None:
        return None, (0, 0, 0)
    b4 = _broadcast_bias(bias.to(device), B, T, S)
    if b4.shape[1] not in (1, N):
        raise ValueError(f"{op}: bias {tuple(bias.shape)} does not broadcast to [{B}, {N}, {T}, {S}]")
    if b4.stride(3) != 1:
        b4 = b4.contiguous()
    return b4, tuple(0 if b4.shape[i] == 1 else b4.stride(i) for i in range(3))


def _lengths_arg(op, kv_lengths, B, device):
    if tuple(kv_lengths.shape) != (B,):
        raise ValueError(f"{op}: kv_lengths of shape [{B}] expected, got {tuple(kv_lengths.shape)}")
    return kv_lengths.to(device=device, dtype=torch.int32).contiguous()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def fused_attention(q, k, v, bias=None, *, dropout_mask=None, dropout_rate: float = 0.0,
                    dropout_seed=None, with_lse: bool = False, dropout_row0: int = 0,
                    dropout_head0: int = 0, dropout_heads: Optional[int] = None):
    """``drop(softmax(q k^T / sqrt(D) + bias)) v`` over whole rows (the short
    kernel, 65-512 tokens in the models). q: [B, T, N, D]; k, v: [B, S, N,
    D], read through their strides; bias: f32, broadcastable to [B, N, T,
    S]. A seed's keep bits are hashed at the global rows from
    ``dropout_row0`` and the global heads [dropout_head0, dropout_head0 +
    N) of ``dropout_heads`` (default N: a model rank's heads of the
    model's). Returns [B, T, N, D] contiguous in v's dtype, and with
    ``with_lse`` also lse [B, N, T] f32 (for the backward)."""
    if _on_cpu(q, "flash_attention"):
        return fused_attention_plain(q, k, v, bias, dropout_mask=dropout_mask,
                                     dropout_rate=dropout_rate, dropout_seed=dropout_seed,
                                     with_lse=with_lse, dropout_row0=dropout_row0,
                                     dropout_head0=dropout_head0, dropout_heads=dropout_heads)
    op = "flash_attention"
    code = _check_heads(op, q, k, v)
    B, T, N, D = q.shape
    S = k.shape[1]
    drop, mask = _dropout_args(op, dropout_mask, dropout_rate, dropout_seed, q, S, dropout_row0)
    drop = _with_heads(drop, N, dropout_head0, dropout_heads)
    b4, strides = _bias_view(op, bias, B, N, T, S, q.device)
    out = torch.empty((B, T, N, D), dtype=v.dtype, device=q.device)
    lse = torch.empty((B, N, T), dtype=torch.float32, device=q.device) if with_lse else None
    with torch.cuda.device(q.device):
        _kernels.launch(
            op, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *_strides(q), *_strides(k), *_strides(v),
            None if b4 is None else b4.data_ptr(), *strides, out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, T, S, N, D, float(1.0 / D ** 0.5), *drop, code, _stream(q.device),
        )
    LAUNCHES[op if mask is None else op + "_mask"] += 1
    return (out, lse) if with_lse else out


def blockwise_attention(q, k, v, *, bias=None, kv_lengths=None, causal: bool = False,
                        dropout_mask=None, dropout_rate: float = 0.0, dropout_seed=None,
                        offsets=None, dropout_row0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The blockwise kernel (``_blockwise_forward``): online softmax over key
    chunks. q: [B, T, N, D]; k, v: [B, S, N, D]. Lengths mode (kv_lengths:
    [B] int): key chunks above the diagonal (``causal``) or at and past the
    clip's length are skipped, dead query rows are zeros with lse 0 and whole
    dead query tiles skip all compute; ``offsets`` (row0, col0) place the
    block in the whole sequence (one ring step; see the module docstring).
    Dense-bias mode (``bias`` f32, broadcastable to [B, N, T, S], or None for
    no bias): every row computed, key chunks above the diagonal skipped with
    ``causal``. Returns (out [B, T, N, D] in v's dtype, lse [B, N, T] f32)."""
    kw = dict(bias=bias, kv_lengths=kv_lengths, causal=causal, dropout_mask=dropout_mask,
              dropout_rate=dropout_rate, dropout_seed=dropout_seed, offsets=offsets,
              dropout_row0=dropout_row0)
    if _on_cpu(q, "blockwise_attention"):
        return blockwise_attention_plain(q, k, v, **kw)
    op = "blockwise_attention"
    _check_bias(bias, kv_lengths)
    if offsets is not None and kv_lengths is None:
        raise ValueError(f"{op}: ring offsets require kv_lengths")
    row0, col0 = (0, 0) if offsets is None else _ring_offsets(offsets)
    code = _check_heads(op, q, k, v)
    B, T, N, D = q.shape
    S = k.shape[1]
    drop, mask = _dropout_args(op, dropout_mask, dropout_rate, dropout_seed, q, S, dropout_row0)
    lengths = None if kv_lengths is None else _lengths_arg(op, kv_lengths, B, q.device)
    b4, strides = _bias_view(op, bias, B, N, T, S, q.device)
    out = torch.empty((B, T, N, D), dtype=v.dtype, device=q.device)
    lse = torch.empty((B, N, T), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _kernels.launch(
            op, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *_strides(q), *_strides(k), *_strides(v),
            None if b4 is None else b4.data_ptr(), *strides,
            None if lengths is None else lengths.data_ptr(), int(bool(causal)), row0, col0,
            out.data_ptr(), lse.data_ptr(), B, T, S, N, D, float(1.0 / D ** 0.5), *drop, code,
            _stream(q.device),
        )
    if mask is not None:
        LAUNCHES[op + "_mask"] += 1
    elif offsets is not None:
        LAUNCHES["blockwise_attention_offsets"] += 1
    else:
        LAUNCHES[op if lengths is not None else "blockwise_attention_dense"] += 1
    return out, lse


def _aligned(x: torch.Tensor) -> torch.Tensor:
    align = 16 // x.element_size()
    if x.stride(3) == 1 and not any(s % align for s in x.stride()[:3]) and x.data_ptr() % 16 == 0:
        return x
    return x.contiguous()


def _bwd_operands(op, q, k, v, dout, lse, dsum):
    """The backward kernels' shared checks and buffers: (dO aligned in q's
    dtype, the dtype code, lse and dsum as contiguous f32 [B, N, T], and the
    empty dq, dk, dv in q's dtype)."""
    dout = _aligned(dout.to(q.dtype))
    code = _check_heads(op, q, k, v, dout)
    B, T, N, _ = q.shape
    for name, x in (("lse", lse), ("dsum", dsum)):
        if x.dtype != torch.float32 or tuple(x.shape) != (B, N, T) or x.device != q.device:
            raise ValueError(f"{op}: {name} must be f32 [{B}, {N}, {T}] on {q.device}")
    grads = tuple(torch.empty(x.shape, dtype=q.dtype, device=q.device) for x in (q, k, k))
    return dout, code, lse.contiguous(), dsum.contiguous(), grads


def fused_attention_bwd(q, k, v, dout, lse, dsum, bias=None, *, dropout_mask=None,
                        dropout_rate: float = 0.0, dropout_seed=None, dropout_row0: int = 0,
                        dropout_head0: int = 0, dropout_heads: Optional[int] = None):
    """The short kernel's backward (``_fused_backward``): (dq, dk, dv) of
    :func:`fused_attention` for the cotangent ``dout`` [B, T, N, D], from its
    lse and ``dsum = rowsum(dout o out)`` (both [B, N, T] f32), the keep
    bits at the forward's global rows and heads. Returns contiguous tensors
    in q's dtype."""
    if _on_cpu(q, "flash_attention_bwd"):
        return attention_bwd_plain(q, k, v, dout, lse, dsum, bias=bias, dropout_mask=dropout_mask,
                                   dropout_rate=dropout_rate, dropout_seed=dropout_seed,
                                   dropout_row0=dropout_row0, dropout_head0=dropout_head0,
                                   dropout_heads=dropout_heads)
    op = "flash_attention_bwd"
    dout, code, lse, dsum, (dq, dk, dv) = _bwd_operands(op, q, k, v, dout, lse, dsum)
    B, T, N, D = q.shape
    S = k.shape[1]
    drop, mask = _dropout_args(op, dropout_mask, dropout_rate, dropout_seed, q, S, dropout_row0)
    drop = _with_heads(drop, N, dropout_head0, dropout_heads)
    b4, strides = _bias_view(op, bias, B, N, T, S, q.device)
    with torch.cuda.device(q.device):
        _kernels.launch(
            op, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            *_strides(q), *_strides(k), *_strides(v), *_strides(dout),
            None if b4 is None else b4.data_ptr(), *strides, lse.data_ptr(), dsum.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, T, S, N, D, float(1.0 / D ** 0.5), *drop, code, _stream(q.device),
        )
    LAUNCHES[op if mask is None else op + "_mask"] += 1
    return dq, dk, dv


def blockwise_attention_bwd(q, k, v, dout, lse, dsum, *, bias=None, kv_lengths=None,
                            causal: bool = False, dropout_mask=None, dropout_rate: float = 0.0,
                            dropout_seed=None, offsets=None, dropout_row0: int = 0):
    """The blockwise kernels' backward (``_blockwise_backward``): (dq, dk,
    dv) of :func:`blockwise_attention` for the cotangent ``dout``, from its
    lse and ``dsum`` (0 on dead rows), in the forward's modes. Chunks and
    tiles the forward skipped are skipped; in lengths mode dead query rows
    get dq = 0 and add nothing to dk, dv. ``offsets`` (row0, col0, with
    ``kv_lengths``): one step of the ring's backward, the mask and the dead
    rows at global indices, ``lse`` the ring's global one. Returns
    contiguous tensors in q's dtype."""
    if _on_cpu(q, "blockwise_attention_bwd"):
        return attention_bwd_plain(q, k, v, dout, lse, dsum, bias=bias, kv_lengths=kv_lengths,
                                   causal=causal, dropout_mask=dropout_mask,
                                   dropout_rate=dropout_rate, dropout_seed=dropout_seed,
                                   offsets=offsets, dropout_row0=dropout_row0)
    op = "blockwise_attention_bwd"
    _check_bias(bias, kv_lengths)
    if offsets is not None and kv_lengths is None:
        raise ValueError(f"{op}: ring offsets require kv_lengths")
    row0, col0 = (0, 0) if offsets is None else _ring_offsets(offsets)
    dout, code, lse, dsum, (dq, dk, dv) = _bwd_operands(op, q, k, v, dout, lse, dsum)
    B, T, N, D = q.shape
    S = k.shape[1]
    drop, mask = _dropout_args(op, dropout_mask, dropout_rate, dropout_seed, q, S, dropout_row0)
    lengths = None if kv_lengths is None else _lengths_arg(op, kv_lengths, B, q.device)
    b4, strides = _bias_view(op, bias, B, N, T, S, q.device)
    with torch.cuda.device(q.device):
        _kernels.launch(
            op, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            *_strides(q), *_strides(k), *_strides(v), *_strides(dout),
            None if b4 is None else b4.data_ptr(), *strides,
            None if lengths is None else lengths.data_ptr(), int(bool(causal)), row0, col0,
            lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, T, S, N, D, float(1.0 / D ** 0.5), *drop, code, _stream(q.device),
        )
    if mask is not None:
        LAUNCHES[op + "_mask"] += 1
    elif offsets is not None:
        LAUNCHES["blockwise_attention_bwd_offsets"] += 1
    else:
        LAUNCHES[op if lengths is not None else "blockwise_attention_bwd_dense"] += 1
    return dq, dk, dv


# --- the gradients: _flash_custom's VJP -----------------------------------------


class _Attention(torch.autograd.Function):
    """``_flash_custom``'s VJP (``_flash_fwd`` / ``_flash_bwd``): the short or
    the blockwise kernel with lse, then its backward. ``kw`` holds the
    wrappers' keyword arguments (bias or kv_lengths + causal, dropout)."""

    @staticmethod
    def forward(ctx, q, k, v, blockwise: bool, kw: dict):
        if blockwise:
            out, lse = blockwise_attention(q, k, v, **kw)
        else:
            out, lse = fused_attention(q, k, v, with_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.blockwise, ctx.kw = blockwise, kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = blockwise_attention_bwd if ctx.blockwise else fused_attention_bwd
        dsum = _dsum(dout, out, ctx.kw.get("kv_lengths"))
        dq, dk, dv = bwd(q, k, v, dout, lse, dsum, **ctx.kw)
        return dq, dk, dv, None, None


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
    dropout_row0: int = 0,
    dropout_head0: int = 0,
    dropout_heads: Optional[int] = None,
) -> torch.Tensor:
    """q: [B, T, N, D]; k, v: [B, S, N, D]; bias broadcastable to [B, N, T,
    S], or ``kv_lengths`` [B] int (+ ``causal``) for the key-padding+causal
    form. ``causal`` declares that the bias is causal; in lengths mode it
    also masks keys above the diagonal. ``dropout_seed`` (a uint32) with
    ``dropout_rate`` drops probabilities with hashed keep bits (at the
    global rows from ``dropout_row0``: a slice of a batch), a
    ``dropout_mask`` [B, 1|N, T, S] with the caller's (see the module
    docstring); below 513 tokens ``dropout_head0`` and ``dropout_heads``
    place q's N heads among the model's (a model rank's: the keep bits of
    those heads; the blockwise kernels hash at their own heads, and refuse
    a head base with a seed and a rate above 0). Returns [B,
    T, N, D] in v's dtype. From 513 tokens on the blockwise kernel runs (in
    lengths mode with ``kv_lengths``, else in dense-bias mode), below it the
    short kernel; when q, k or v
    needs a gradient, through ``_Attention`` above. See the module
    docstring for the dead rows of the lengths mode."""
    _check_dropout(dropout_mask, dropout_rate, dropout_seed)
    _check_bias(bias, kv_lengths)
    T, S = q.shape[1], k.shape[1]
    if dropout_mask is not None:
        check_mask("flash_attention", dropout_mask, q.shape[0], q.shape[2], T, S)
    blockwise = max(T, S) >= _BLOCKWISE_MIN_SEQ
    kw = dict(dropout_mask=dropout_mask, dropout_rate=dropout_rate, dropout_seed=dropout_seed,
              dropout_row0=dropout_row0)
    if blockwise:
        hashed = dropout_seed is not None and dropout_rate > 0.0
        if hashed and (dropout_head0 or dropout_heads not in (None, q.shape[2])):
            raise NotImplementedError("the blockwise attention kernels hash their dropout at the "
                                      "launch's own heads: a head base waits for ROADMAP.md item "
                                      "A9 (model axis, long-clip training)")
        kw.update(bias=bias, kv_lengths=kv_lengths, causal=causal)
    else:
        kw.update(dropout_head0=dropout_head0, dropout_heads=dropout_heads,
                  bias=bias if kv_lengths is None else _lengths_dense_bias(kv_lengths.to(q.device), T, S,
                                                                           causal))
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _Attention.apply(q, k, v, blockwise, kw)
    return blockwise_attention(q, k, v, **kw)[0] if blockwise else fused_attention(q, k, v, **kw)
