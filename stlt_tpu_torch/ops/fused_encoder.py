"""Fused encoder-layer ops of the eval path: projection+attention and the
layer tail. Port of the eval halves of ``stlt_tpu/ops/fused_encoder.py``.

Each op has three parts:

- the wrapper (``fused_proj_attention``, ``fused_layer_tail``): a CUDA tensor
  launches the hand-written kernel (``csrc/<op>.cu``) or raises; a CPU tensor
  takes the plain version. The device alone decides; there is no fallback;
- the plain PyTorch version (``*_plain``) of the same function, with the same
  rounding points;
- a launch count in :data:`LAUNCHES`, raised by one where the wrapper
  launches its kernel and nowhere else.

Numerics are the kernel contract of the JAX package's ``use_pallas=True``
path, not its TPU blocking:

- ``fused_proj_attention`` rounds ``wqkv``/``bqkv``/``wo``/``bo`` and ``qkv``
  (after the f32 bias add) to the compute dtype; logits and softmax are f32
  with scale ``1/sqrt(D)``; the attention output is rounded to the compute
  dtype before the out-projection, which accumulates in f32.
- ``fused_layer_tail`` does the residual adds in the compute dtype, adds
  ``b1``, ``b2`` and the LayerNorm parameters in f32, and applies the
  activation to the compute-dtype hidden op for op in that dtype, as JAX
  does (:func:`gelu`).
- Dead rows (``rows_live``) and dead tokens (``tokens_live``) come out as
  exact zeros. The JAX kernels zero whole dead row blocks only; either way
  dead rows reach later attention only as -1e9-masked keys.

The TPU artefacts (T padded to a multiple of 8, tokens flattened into rows of
8, row-block pickers, VMEM budgets) do not carry over.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from stlt_tpu_torch.ops import _kernels

LAUNCHES = {"fused_proj_attention": 0, "fused_layer_tail": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Hidden sizes the CUDA kernels are instantiated for (64 x these).
_KERNEL_WIDTHS = (1, 2, 4, 8, 12, 16)
_KERNEL_HEAD_DIM = 64
_KERNEL_MAX_SEQ = 32
_KERNEL_FF_CHUNK = 128


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
            f"{op}: the CUDA kernel takes H in 64 x {_KERNEL_WIDTHS}, got H={hidden}"
        )


def _bias3(bias: Optional[torch.Tensor], rows: int, seq: int, device) -> torch.Tensor:
    """A head-invariant additive bias broadcastable to [rows, 1, T, T], as
    f32 [rows or 1, T or 1, T]. The broadcast dims stay size 1: the spatial
    key-padding bias is read per row as [1, T], never materialised as
    [rows, 1, T, T]."""
    if bias is None:
        return torch.zeros(1, 1, seq, dtype=torch.float32, device=device)
    b = bias.to(torch.float32)
    while b.dim() < 4:
        b = b[None]
    if b.dim() != 4 or b.shape[1] != 1:
        raise ValueError(f"head-invariant bias [rows, 1, T, T] expected, got {tuple(bias.shape)}")
    b0, tq, s = b.shape[0], b.shape[2], b.shape[3]
    if b0 not in (1, rows) or tq not in (1, seq) or s not in (1, seq):
        raise ValueError(f"bias {tuple(bias.shape)} does not broadcast to [{rows}, 1, {seq}, {seq}]")
    return b.expand(b0, 1, tq, seq).reshape(b0, tq, seq)


# --- projection + attention ---------------------------------------------------


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
    B, T, H = x.shape
    N = num_heads
    D = H // N
    cd = compute_dtype
    f32 = torch.float32
    qkv = x.to(cd).to(f32) @ wqkv.to(cd).to(f32) + bqkv.to(cd).to(f32)
    qkv = qkv.to(cd).to(f32).reshape(B, T, 3, N, D).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # [B, N, T, D]
    logits = (q @ k.transpose(-1, -2)) * (1.0 / D ** 0.5)
    logits = logits + _bias3(bias, B, T, x.device)[:, None]
    logits = logits - logits.amax(dim=-1, keepdim=True)
    probs = torch.exp(logits)
    probs = probs / probs.sum(dim=-1, keepdim=True)
    attn = (probs @ v).transpose(1, 2).reshape(B, T, H)
    y = attn.to(cd).to(f32) @ wo.to(cd).to(f32) + bo.to(cd).to(f32)
    if rows_live is not None:
        y = torch.where(rows_live.reshape(B, 1, 1).to(torch.bool), y, torch.zeros((), dtype=f32, device=y.device))
    return y.to(x.dtype)


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
    if _on_cpu(x, "fused_proj_attention"):
        return fused_proj_attention_plain(
            x, wqkv, bqkv, wo, bo, bias, num_heads=num_heads,
            compute_dtype=compute_dtype, rows_live=rows_live,
        )
    op = "fused_proj_attention"
    B, T, H = x.shape
    code = _check_kernel_dtypes(op, compute_dtype, x)
    _check_kernel_width(op, H)
    if H // num_heads != _KERNEL_HEAD_DIM or H % num_heads:
        raise ValueError(f"{op}: the CUDA kernel takes head dim {_KERNEL_HEAD_DIM}, got H/N={H / num_heads}")
    if not 1 <= T <= _KERNEL_MAX_SEQ:
        raise ValueError(f"{op}: the CUDA kernel takes T <= {_KERNEL_MAX_SEQ}, got T={T}")
    if wqkv.shape != (H, 3 * H) or bqkv.shape != (3 * H,) or wo.shape != (H, H) or bo.shape != (H,):
        raise ValueError(f"{op}: weight shapes do not match H={H}")
    cd = compute_dtype
    x = x.contiguous()
    wqkv = wqkv.to(cd).contiguous()
    bqkv = bqkv.to(cd).contiguous()
    wo = wo.to(cd).contiguous()
    bo = bo.to(cd).contiguous()
    b3 = _bias3(bias, B, T, x.device).contiguous()
    # Size-1 dims of b3 [rows or 1, T or 1, T] are read with stride 0.
    row_stride = b3.shape[1] * T if b3.shape[0] > 1 else 0
    q_stride = T if b3.shape[1] > 1 else 0
    live = None if rows_live is None else rows_live.reshape(B).to(torch.uint8).contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _kernels.launch(
            op, x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wo.data_ptr(),
            bo.data_ptr(), b3.data_ptr(), row_stride, q_stride,
            None if live is None else live.data_ptr(), out.data_ptr(),
            B, T, H, num_heads, float(1.0 / (H // num_heads) ** 0.5), code, stream,
        )
    LAUNCHES[op] += 1
    return out


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
    code = _check_kernel_dtypes(op, compute_dtype, x, attn_out)
    _check_kernel_width(op, H)
    if FF % _KERNEL_FF_CHUNK or w1.shape != (H, FF) or w2.shape != (FF, H):
        raise ValueError(f"{op}: the CUDA kernel takes W1 [H, FF], W2 [FF, H] with FF % {_KERNEL_FF_CHUNK} == 0")
    if activation == "gelu":
        act = 2 if gelu_approximate else 1
    elif activation == "relu":
        act = 0
    else:
        raise ValueError(f"unknown activation {activation}")
    cd = compute_dtype
    f32 = torch.float32
    x = x.contiguous()
    attn_out = attn_out.contiguous()
    w1 = w1.to(cd).contiguous()
    w2 = w2.to(cd).contiguous()
    vecs = [v.reshape(-1).to(f32).contiguous() for v in (n1_scale, n1_bias, b1, b2, n2_scale, n2_bias)]
    n1s, n1b, b1v, b2v, n2s, n2b = vecs
    live = _live_tokens(rows_live, tokens_live, B, T)
    if live is not None:
        live = live.to(torch.uint8).contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _kernels.launch(
            op, x.data_ptr(), attn_out.data_ptr(), n1s.data_ptr(), n1b.data_ptr(),
            w1.data_ptr(), b1v.data_ptr(), w2.data_ptr(), b2v.data_ptr(),
            n2s.data_ptr(), n2b.data_ptr(), None if live is None else live.data_ptr(),
            out.data_ptr(), B * T, H, FF, float(eps), act, code, stream,
        )
    LAUNCHES[op] += 1
    return out
