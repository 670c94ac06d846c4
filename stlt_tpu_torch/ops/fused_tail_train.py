"""Fused train layer tail: dropout -> residual + norm1 -> FFN with dropout ->
dropout -> residual + norm2, forward and backward.

Port of ``stlt_tpu/ops/fused_tail_train.py``: ``fused_layer_tail_train``
(:1073) with its custom VJP ``_tail_train`` (:778), forward
``_tail_train_fwd`` (:800) and backward ``_tail_train_bwd`` (:885), and the
dispatch gate ``TAIL_TRAIN_MIN_FRAMES`` / ``tail_train_wants`` (:701-733).

For ``u = norm1(x + drop(attn_out))`` the op computes ``y = norm2(u +
drop(linear2(drop(act(linear1(u))))))``, its three dropout sites hashed from
one seed (``ops/dropout.py::keep_rows``, tags ``TAG_ATTN_DROP``,
``TAG_MID_DROP``, ``TAG_OUT_DROP``). It is the plain train tail of
``models/layers.py`` with the kernels' rounding points: ``b1`` and ``b2`` are
added in f32 onto the f32 products before the rounding to the compute dtype,
and dead tokens (``rows_live`` / ``tokens_live``) come out as exact zeros
with zero gradients (JAX masks them at the seam of its block-granular
kernels). Four kernels, one for each TPU kernel, each with its launch count
in :data:`LAUNCHES`:

- ``fused_layer_tail_train`` (``_tail_train_fwd_kernel`` :191): the train
  variant of ``csrc/fused_layer_tail.cu``; outputs y and the residual
  ``r2 = u + h2``, the backward's only saved activation besides the inputs;
- ``fused_tail_train_bwd_row`` (``_tail_train_bwd_row_kernel`` :284): LN2
  backward, ``dr2`` and the f32 sums ``dn2s``, ``dn2b``, ``db2``;
- ``fused_tail_train_bwd_input`` (``_tail_train_bwd_input_kernel`` :350):
  the FFN's input side and the LN1 backward, ``dx``, ``dattn``, ``dn1s``,
  ``dn1b``;
- ``fused_tail_train_bwd_weight`` (``_tail_train_bwd_weight_kernel`` :459):
  ``dW1``, ``db1``, ``dW2``, from scratch the input kernel writes (u, dh2,
  the hidden-side cotangent and the dropped hidden, in bf16 with the live
  tokens packed; ``csrc/fused_tail_train_bwd.cu``).

A CUDA tensor launches the kernels or raises; a CPU tensor takes the plain
versions, which follow the JAX kernels step for step (the same rounding
points and keep bits, f32 sums). The backward is the decomposition the
kernels compute, not autograd through the plain forward: act' is taken on
the f32 pre-activation, ``du`` starts from the rounded ``dr2``, ``dh2`` is
rounded before both of its products, ``dW1`` multiplies the rounded ``dh1``
while ``db1`` sums the f32 one, and ``dW2`` the rounded dropped hidden.

The gate is JAX's without its environment switches: a train tail runs this
op when the model's clip length reaches :data:`TAIL_TRAIN_MIN_FRAMES`. JAX
also asks whether its blocks fit the TPU's VMEM (``tail_train_fits``); that
holds at every width the port's kernels take, so it does not carry over.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from stlt_tpu_torch.ops import _kernels
from stlt_tpu_torch.ops import fused_encoder as fe
from stlt_tpu_torch.ops.dropout import (MASK32, TAG_ATTN_DROP, TAG_MID_DROP, TAG_OUT_DROP, RowMap,
                                        Rows, dropout_thresh, keep_rows)

TAIL_TRAIN_MIN_FRAMES = 256

LAUNCHES = {
    "fused_layer_tail_train": 0,
    "fused_tail_train_bwd_row": 0,
    "fused_tail_train_bwd_input": 0,
    "fused_tail_train_bwd_weight": 0,
}

# csrc/fused_tail_train_bwd.cu: tokens of one f32 input block (kTMF) and of
# one bf16 GEMM tile (kBM, the db1 partials' count); the weight products' k
# step (f32 kKW, bf16 kBK), whose splits take about _WEIGHT_SPLIT_TOKENS
# tokens each, at most _WEIGHT_MAX_SPLITS of them.
_F32_INPUT_BLOCK_TOKENS = 16
_GEMM_TILE_TOKENS = 128
_WEIGHT_STEP_TOKENS = {torch.float32: 32, torch.bfloat16: 64}
_WEIGHT_SPLIT_TOKENS = 8192
_WEIGHT_MAX_SPLITS = 8
_ROW_BLOCKS = 264  # two blocks per SM of the H100 for the row kernels

f32 = torch.float32


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def tail_train_wants(clip_frames: int) -> bool:
    """True when a train tail of a model of ``clip_frames`` frames runs
    :func:`fused_layer_tail_train` (JAX's ``tail_train_wants`` under
    ``use_pallas=True``)."""
    return clip_frames >= TAIL_TRAIN_MIN_FRAMES


@dataclass(frozen=True)
class TailConfig:
    """The op's static arguments. ``seed`` is a uint32 or None; dropout is on
    when there is a seed and a positive rate, as in ``_prep`` (:791).
    ``token0``: the global index of the op's first token, or the tokens'
    map, at which its keep bits are hashed (``ops/dropout.py::keep_rows``'
    ``r0``)."""

    eps: float
    activation: str = "gelu"
    gelu_approximate: bool = False
    dropout_rate: float = 0.0
    seed: Optional[int] = None
    token0: RowMap = RowMap()

    @property
    def drop(self) -> bool:
        return self.seed is not None and self.dropout_rate > 0.0

    def keep(self, tag: int, like: torch.Tensor):
        """keep * 1/(1-rate) f32 of one site over ``like``'s [tokens, width],
        or None when dropout is off."""
        if not self.drop:
            return None
        keep = keep_rows(self.seed, tag, self.token0, 0, tuple(like.shape), like.shape[1],
                         dropout_thresh(self.dropout_rate), like.device)
        return keep.to(f32) * (1.0 / (1.0 - self.dropout_rate))


# --- plain versions -------------------------------------------------------------


def _ln32(r32: torch.Tensor, eps: float):
    """flax LayerNorm statistics in f32: (xhat, rstd) (``_ln_fwd32``)."""
    mu = r32.mean(dim=-1, keepdim=True)
    var = torch.clamp((r32 * r32).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    rstd = torch.rsqrt(var + eps)
    return (r32 - mu) * rstd, rstd


def _ln_bwd32(g32, xhat, rstd, scale) -> torch.Tensor:
    """dL/dr of ``xhat * scale + bias`` per row (``_ln_bwd32``)."""
    dxhat = g32 * scale.to(f32)
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    return rstd * (dxhat - m1 - xhat * m2)


def act_grad32(z: torch.Tensor, activation: str, approximate: bool) -> torch.Tensor:
    """d act / dz in f32 from the f32 pre-activation, term for term as
    ``_act_grad32`` (:131)."""
    if activation == "relu":
        return (z > 0.0).to(f32)
    if activation != "gelu":
        raise ValueError(f"unknown activation {activation}")
    if approximate:
        c, k = 0.7978845608028654, 0.044715
        t = torch.tanh(c * (z + k * z * z * z))
        return 0.5 * (1.0 + t) + 0.5 * z * (1.0 - t * t) * c * (1.0 + 3.0 * k * z * z)
    cdf = 0.5 * (1.0 + torch.erf(z * 0.7071067811865476))
    pdf = 0.3989422804014327 * torch.exp(-0.5 * z * z)
    return cdf + z * pdf


def _recompute_u(x, attn, n1s, n1b, cfg: TailConfig):
    """u (f32) = LN1(x + drop(attn)) and its xhat, rstd, keep1
    (``_recompute_u32``): the dropped attn and the residual round to the
    compute dtype."""
    cd = x.dtype
    keep1 = cfg.keep(TAG_ATTN_DROP, x)
    a32 = attn.to(f32)
    if keep1 is not None:
        a32 = (a32 * keep1).to(cd).to(f32)
    xhat, rstd = _ln32((x + a32.to(cd)).to(f32), cfg.eps)
    return xhat * n1s.to(f32) + n1b.to(f32), xhat, rstd, keep1


def _hidden(u, w1, b1, cfg: TailConfig):
    """z1 = u W1 + b1 (f32) and the dropped hidden h1d (cd) of the forward."""
    cd = u.dtype
    z1 = fe._mm_f32(u, w1.to(cd)) + b1.to(f32)
    h1 = fe.activation_fn(z1.to(cd), cfg.activation, cfg.gelu_approximate)
    keepm = cfg.keep(TAG_MID_DROP, z1)
    if keepm is not None:
        h1 = (h1.to(f32) * keepm).to(cd)
    return z1, h1, keepm


def fused_layer_tail_train_plain(x, attn, weights, cfg: TailConfig, live=None):
    """Plain version of the forward kernel on flattened tokens: x, attn
    [tokens, H] in the compute dtype, ``weights`` = (n1s, n1b, w1 [H, FF], b1,
    w2 [FF, H], b2, n2s, n2b), ``live`` [tokens] bool or None. Returns (y,
    r2), both [tokens, H] in the compute dtype, zeros on dead tokens."""
    n1s, n1b, w1, b1, w2, b2, n2s, n2b = weights
    cd = x.dtype
    u32, _, _, _ = _recompute_u(x, attn, n1s, n1b, cfg)
    u = u32.to(cd)
    _, h1, _ = _hidden(u, w1, b1, cfg)
    h2 = (fe._mm_f32(h1, w2.to(cd)) + b2.to(f32)).to(cd)
    keep2 = cfg.keep(TAG_OUT_DROP, h2)
    if keep2 is not None:
        h2 = (h2.to(f32) * keep2).to(cd)
    r2 = u + h2
    xhat2, _ = _ln32(r2.to(f32), cfg.eps)
    y = (xhat2 * n2s.to(f32) + n2b.to(f32)).to(cd)
    return fe._zero_dead_rows(y, live), fe._zero_dead_rows(r2, live)


def tail_train_bwd_row_plain(r2, g, n2s, cfg: TailConfig, live=None):
    """Plain version of the row kernel: (dr2 in the compute dtype, dn2s,
    dn2b, db2 f32). The cotangent of a dead token counts as zero."""
    cd = r2.dtype
    g32 = fe._zero_dead_rows(g.to(cd), live).to(f32)
    xhat2, rstd2 = _ln32(r2.to(f32), cfg.eps)
    dr2 = _ln_bwd32(g32, xhat2, rstd2, n2s)
    keep2 = cfg.keep(TAG_OUT_DROP, dr2)
    dh2 = dr2 if keep2 is None else dr2 * keep2
    return dr2.to(cd), (g32 * xhat2).sum(dim=0), g32.sum(dim=0), dh2.sum(dim=0)


def _bwd_ffn_plain(x, attn, dr2, weights, cfg: TailConfig):
    """The recompute shared by the input and the weight kernels (their
    ``_body``s): u, LN1's xhat/rstd/keep1, cd(dh2), z1, the dropped hidden
    and the f32 dh1."""
    n1s, n1b, w1, b1, w2 = weights[:5]
    cd = x.dtype
    u32, xhat1, rstd1, keep1 = _recompute_u(x, attn, n1s, n1b, cfg)
    u = u32.to(cd)
    dr2 = dr2.to(f32)
    keep2 = cfg.keep(TAG_OUT_DROP, dr2)
    dh2 = (dr2 if keep2 is None else dr2 * keep2).to(cd)
    z1, h1d, keepm = _hidden(u, w1, b1, cfg)
    dh1d = fe._mm_f32(dh2, w2.to(cd).t())
    if keepm is not None:
        dh1d = dh1d * keepm
    dh1 = dh1d * act_grad32(z1, cfg.activation, cfg.gelu_approximate)
    return dict(u=u, xhat1=xhat1, rstd1=rstd1, keep1=keep1, dr2=dr2, dh2=dh2, h1d=h1d, dh1=dh1)


def _bwd_input_from(ffn, weights, cfg: TailConfig, live):
    n1s, w1 = weights[0], weights[2]
    cd = ffn["u"].dtype
    du = ffn["dr2"] + fe._mm_f32(ffn["dh1"].to(cd), w1.to(cd).t())
    xhat1 = ffn["xhat1"]
    dr1 = _ln_bwd32(du, xhat1, ffn["rstd1"], n1s)
    dattn = dr1 if ffn["keep1"] is None else dr1 * ffn["keep1"]
    return (fe._zero_dead_rows(dr1.to(cd), live), fe._zero_dead_rows(dattn.to(cd), live),
            (du * xhat1).sum(dim=0), du.sum(dim=0))


def _bwd_weight_from(ffn):
    cd = ffn["u"].dtype
    dw1 = fe._mm_f32(ffn["u"].t(), ffn["dh1"].to(cd))
    dw2 = fe._mm_f32(ffn["h1d"].t(), ffn["dh2"])
    return dw1, ffn["dh1"].sum(dim=0), dw2


def tail_train_bwd_input_plain(x, attn, dr2, weights, cfg: TailConfig, live=None):
    """Plain version of the input kernel: (dx, dattn in the compute dtype,
    dn1s, dn1b f32), zeros for dead tokens. ``dr2`` is the row kernel's,
    zero on dead tokens."""
    return _bwd_input_from(_bwd_ffn_plain(x, attn, dr2, weights, cfg), weights, cfg, live)


def tail_train_bwd_weight_plain(x, attn, dr2, weights, cfg: TailConfig):
    """Plain version of the weight kernel: (dW1 [H, FF], db1, dW2 [FF, H]),
    f32."""
    return _bwd_weight_from(_bwd_ffn_plain(x, attn, dr2, weights, cfg))


def fused_layer_tail_train_bwd_plain(x, attn, r2, g, weights, cfg: TailConfig, live=None):
    """Plain version of the whole backward (``_tail_train_bwd``): (dx, dattn,
    dn1s, dn1b, dW1, db1, dW2, db2, dn2s, dn2b)."""
    dr2, dn2s, dn2b, db2 = tail_train_bwd_row_plain(r2, g, weights[6], cfg, live)
    ffn = _bwd_ffn_plain(x, attn, dr2, weights, cfg)
    dx, dattn, dn1s, dn1b = _bwd_input_from(ffn, weights, cfg, live)
    dw1, db1, dw2 = _bwd_weight_from(ffn)
    return dx, dattn, dn1s, dn1b, dw1, db1, dw2, db2, dn2s, dn2b


# --- kernel launchers -----------------------------------------------------------


def _vec(v) -> torch.Tensor:
    return v.reshape(-1).to(f32).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _row_blocks(tokens: int) -> int:
    """Blocks of the row kernels (LN2 and, in bf16, LN1 backward): 64
    tokens or more each, at most :data:`_ROW_BLOCKS`."""
    return max(1, min(_ROW_BLOCKS, -(-tokens // 64)))


def _weight_splits(rows: int, step: int):
    """(chunk, splits) of the weight products over ``rows`` scratch rows:
    chunks a multiple of ``step``, about :data:`_WEIGHT_SPLIT_TOKENS` tokens
    each, at most :data:`_WEIGHT_MAX_SPLITS`, covering every row with no
    empty split. From the row count alone, so the sums' order is fixed."""
    splits = max(1, min(_WEIGHT_MAX_SPLITS, -(-rows // _WEIGHT_SPLIT_TOKENS)))
    chunk = max(step, -(-rows // (splits * step)) * step)
    return chunk, max(1, -(-rows // chunk))


def _launch_tail_train(x, attn, weights, cfg: TailConfig, live=None):
    """Launch the train variant of csrc/fused_layer_tail.cu: (y, r2)."""
    op = "fused_layer_tail_train"
    n1s, n1b, w1, b1, w2, b2, n2s, n2b = weights
    tokens, H = x.shape
    FF = w1.shape[1]
    code = fe._check_tail_kernel(op, x.dtype, H, w1, w2, x, attn)
    cd = x.dtype
    x, attn = fe.aligned16(x), fe.aligned16(attn)
    w1, w2 = fe.weight_storage(w1, cd), fe.weight_storage(w2, cd)  # [FF, H], [H, FF]
    vecs = [_vec(v) for v in (n1s, n1b, b1, b2, n2s, n2b)]
    live8 = fe.tail_live_bytes(None if live is None else live.reshape(tokens))
    y, r2 = torch.empty_like(x), torch.empty_like(x)
    scratch = fe.tail_scratch(tokens, H, FF, x)
    with torch.cuda.device(x.device):
        _kernels.launch(
            "fused_layer_tail", x.data_ptr(), attn.data_ptr(), vecs[0].data_ptr(),
            vecs[1].data_ptr(), w1.data_ptr(), vecs[2].data_ptr(), w2.data_ptr(),
            vecs[3].data_ptr(), vecs[4].data_ptr(), vecs[5].data_ptr(), _ptr(live8),
            y.data_ptr(), r2.data_ptr(), _ptr(scratch), tokens, H, FF, float(cfg.eps),
            fe._act_code(cfg.activation, cfg.gelu_approximate),
            *fe._dropout_args(cfg.seed, cfg.dropout_rate, cfg.token0), code, _stream(x),
        )
    LAUNCHES[op] += 1
    return y, r2


def _launch_bwd_row(r2, g, n2s, cfg: TailConfig, live=None):
    """Launch the row kernel: (dr2, dn2s, dn2b, db2)."""
    op = "fused_tail_train_bwd_row"
    tokens, H = r2.shape
    code = fe._check_kernel_dtypes(op, r2.dtype, r2)
    fe._check_kernel_width(op, H)
    r2, g = r2.contiguous(), g.to(r2.dtype).contiguous()
    n2s = _vec(n2s)
    live8 = fe._live_flags(live, tokens)
    blocks = _row_blocks(tokens)
    chunk = -(-tokens // blocks)
    dr2 = torch.empty_like(r2)
    partial = torch.empty((blocks, 3, H), dtype=f32, device=r2.device)
    out = torch.empty((3, H), dtype=f32, device=r2.device)
    with torch.cuda.device(r2.device):
        _kernels.launch(
            op, r2.data_ptr(), g.data_ptr(), n2s.data_ptr(), _ptr(live8), dr2.data_ptr(),
            partial.data_ptr(), out.data_ptr(), tokens, H, float(cfg.eps),
            *fe._dropout_args(cfg.seed, cfg.dropout_rate, cfg.token0), blocks, chunk, code, _stream(r2),
        )
    LAUNCHES[op] += 1
    return dr2, out[0], out[1], out[2]


def _launch_bwd_input(x, attn, dr2, weights, cfg: TailConfig, live=None):
    """Launch the input kernel: (dx, dattn, dn1s, dn1b, scratch), the scratch
    being what :func:`_launch_bwd_weight` reads. The kernels read W1 and W2^T
    in the layout of ``linear1.weight`` [FF, H] and ``linear2.weight`` [H,
    FF] (``fe.weight_storage``). In bf16 the scratch rows are the live
    tokens packed in order (``count`` their number, on the device), and an
    f32 scratch of this call holds ``cd(dh1) W1^T``; in f32 they are the
    tokens' own, padded to a whole weight step with zeros."""
    op = "fused_tail_train_bwd_input"
    n1s, n1b, w1, b1, w2 = weights[:5]
    cd, dev = x.dtype, x.device
    tokens, H = x.shape
    FF = w1.shape[1]
    code = fe._check_tail_kernel(op, cd, H, w1, w2, x, attn, dr2)
    bf16 = cd == torch.bfloat16
    x, attn, dr2 = fe.aligned16(x), fe.aligned16(attn), fe.aligned16(dr2)
    w1s, w2s = fe.weight_storage(w1, cd), fe.weight_storage(w2, cd)
    n1s, n1b, b1 = _vec(n1s), _vec(n1b), _vec(b1)
    if bf16:
        live8 = fe.tail_live_bytes(None if live is None else live.reshape(tokens))
        rows, blocks, b1_parts = tokens, _row_blocks(tokens), -(-tokens // _GEMM_TILE_TOKENS)
    else:
        live8 = fe._live_flags(live, tokens)
        step = _WEIGHT_STEP_TOKENS[cd]
        rows, blocks = -(-tokens // step) * step, -(-tokens // _F32_INPUT_BLOCK_TOKENS)
        b1_parts = blocks
    scratch = {name: torch.empty((rows, width), dtype=cd, device=dev)
               for name, width in (("u", H), ("dh2", H), ("dh1", FF), ("h1d", FF))}
    if not bf16:
        for t in scratch.values():
            t[tokens:].zero_()  # the f32 weight products read whole steps of 32 tokens
    du = torch.empty((tokens, H), dtype=f32, device=dev) if bf16 else None
    packed = torch.empty(tokens + 1, dtype=torch.int32, device=dev) if bf16 and live8 is not None else None
    scratch["count"] = None if packed is None else packed[tokens:]
    scratch["partial_b1"] = torch.empty((b1_parts, FF), dtype=f32, device=dev)
    dx, dattn = torch.empty_like(x), torch.empty_like(x)
    partial_ln = torch.empty((blocks, 2, H), dtype=f32, device=dev)
    out = torch.empty((2, H), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        _kernels.launch(
            op, x.data_ptr(), attn.data_ptr(), dr2.data_ptr(), n1s.data_ptr(), n1b.data_ptr(),
            w1s.data_ptr(), b1.data_ptr(), w2s.data_ptr(), _ptr(live8), dx.data_ptr(),
            dattn.data_ptr(), scratch["u"].data_ptr(), scratch["dh2"].data_ptr(),
            scratch["dh1"].data_ptr(), scratch["h1d"].data_ptr(), _ptr(du), _ptr(packed),
            partial_ln.data_ptr(), scratch["partial_b1"].data_ptr(), out.data_ptr(), tokens, H, FF,
            float(cfg.eps), fe._act_code(cfg.activation, cfg.gelu_approximate),
            *fe._dropout_args(cfg.seed, cfg.dropout_rate, cfg.token0), blocks, code, _stream(x),
        )
    LAUNCHES[op] += 1
    return dx, dattn, out[0], out[1], scratch


def _launch_bwd_weight(scratch):
    """Launch the weight kernel on the input kernel's scratch: (dW1 [H, FF],
    db1, dW2 [FF, H])."""
    op = "fused_tail_train_bwd_weight"
    u, dh1 = scratch["u"], scratch["dh1"]
    rows, H = u.shape
    FF = dh1.shape[1]
    code = fe._check_kernel_dtypes(op, u.dtype, u, dh1, scratch["h1d"], scratch["dh2"])
    dev = u.device
    chunk, splits = _weight_splits(rows, _WEIGHT_STEP_TOKENS[u.dtype])
    partial = torch.empty((splits, 2, H * FF), dtype=f32, device=dev)
    out = torch.empty((2, H * FF), dtype=f32, device=dev)
    db1 = torch.empty((FF,), dtype=f32, device=dev)
    pb1 = scratch["partial_b1"]
    with torch.cuda.device(dev):
        _kernels.launch(
            op, u.data_ptr(), dh1.data_ptr(), scratch["h1d"].data_ptr(),
            scratch["dh2"].data_ptr(), _ptr(scratch["count"]), pb1.data_ptr(), pb1.shape[0],
            partial.data_ptr(), out.data_ptr(), db1.data_ptr(), rows, chunk, splits, H, FF, code,
            _stream(u),
        )
    LAUNCHES[op] += 1
    return out[0].view(H, FF), db1, out[1].view(FF, H)


def _launch_tail_train_bwd(x, attn, r2, g, weights, cfg: TailConfig, live=None):
    """The backward through the three kernels: (dx, dattn, dn1s, dn1b, dW1,
    db1, dW2, db2, dn2s, dn2b)."""
    dr2, dn2s, dn2b, db2 = _launch_bwd_row(r2, g, weights[6], cfg, live)
    dx, dattn, dn1s, dn1b, scratch = _launch_bwd_input(x, attn, dr2, weights, cfg, live)
    dw1, db1, dw2 = _launch_bwd_weight(scratch)
    return dx, dattn, dn1s, dn1b, dw1, db1, dw2, db2, dn2s, dn2b


class _TailTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, attn, n1s, n1b, w1, b1, w2, b2, n2s, n2b, live, cfg):
        weights = (n1s, n1b, w1, b1, w2, b2, n2s, n2b)
        if fe._on_cpu(x, "fused_layer_tail_train"):
            y, r2 = fused_layer_tail_train_plain(x, attn, weights, cfg, live)
        else:
            y, r2 = _launch_tail_train(x, attn, weights, cfg, live)
        ctx.save_for_backward(x, attn, r2, *weights, live)
        ctx.cfg = cfg
        return y

    @staticmethod
    def backward(ctx, g):
        x, attn, r2, *weights, live = ctx.saved_tensors
        if fe._on_cpu(g, "fused_layer_tail_train"):
            grads = fused_layer_tail_train_bwd_plain(x, attn, r2, g, weights, ctx.cfg, live)
        else:
            grads = _launch_tail_train_bwd(x, attn, r2, g, weights, ctx.cfg, live)
        return (*grads, None, None)


def fused_layer_tail_train(
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
    dropout_rate: float = 0.0,
    seed: Optional[int] = None,
    rows_live: Optional[torch.Tensor] = None,
    tokens_live: Optional[torch.Tensor] = None,
    token0: Rows = 0,
) -> torch.Tensor:
    """Differentiable fused train tail. x/attn_out: [B, T, H]; w1 [H, FF],
    w2 [FF, H] (input-major); ``seed``: a uint32 or None for no dropout,
    its bits hashed at the global tokens from ``token0`` (or at its map's);
    rows_live [B] or tokens_live [B, T] bool, dead tokens -> zeros with zero
    gradients. Returns [B, T, H] in the compute dtype; gradients flow to x,
    attn_out and the ten parameters (f32 sums for the parameters)."""
    B, T, H = x.shape
    cd = compute_dtype
    live = fe._live_tokens(rows_live, tokens_live, B, T)
    if live is not None:
        live = live.to(x.device)
    cfg = TailConfig(float(eps), activation, bool(gelu_approximate), float(dropout_rate),
                     None if seed is None else int(seed) & MASK32, RowMap.of(token0))
    y = _TailTrain.apply(
        x.to(cd).reshape(B * T, H), attn_out.to(cd).reshape(B * T, H), n1_scale, n1_bias,
        w1, b1, w2, b2, n2_scale, n2_bias, live, cfg,
    )
    return y.reshape(B, T, H)
