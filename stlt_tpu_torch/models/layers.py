"""Post-LN transformer encoder blocks, eval and train.

Port of ``stlt_tpu/models/layers.py``: ``apply_layer_norm`` (:106),
``MultiHeadAttention`` (:131, self- and cross-attention), ``activation_fn`` (:377),
``TransformerEncoderLayer`` (:390) and ``TransformerEncoder`` (:564).
Attribute names are the reference's torch names (the keys
``stlt_tpu.utils.convert.flax_to_torch_state_dict`` emits):
``self_attn.in_proj_weight``/``in_proj_bias``/``out_proj``, ``linear1``,
``linear2``, ``norm1``, ``norm2`` and ``layers.N``. Parameters are f32 and
are cast to the compute dtype where the JAX code casts.

``module.train()``/``module.eval()`` take the place of JAX's
``deterministic`` flag (``eval`` is ``deterministic=True``):

- eval, T <= 64 (``FUSED_PROJ_MAX_SEQ``): every encoder layer is exactly two
  fused ops (``ops/fused_encoder``), projection+attention, then the layer
  tail;
- eval, T > 64 (the temporal stage of long clips, ``layers.py:315-374``):
  q/k/v come from one plain product, the attention core from
  ``ops/attention.dot_product_attention`` (the short flash kernel below 513
  tokens with the dense bias, the blockwise kernel from 513 on with
  ``kv_lengths`` and ``causal``), then a plain out-projection and the fused
  layer tail;
- cross-attention (the fusion models, ``MultiHeadAttention(x,
  context=...)``): in eval with T, S <= 64 one fused op,
  ``fe.fused_cross_attention``; otherwise plain q and kv products and the
  attention core of ``ops/attention`` with the dense bias (the blockwise
  kernel in dense-bias mode from 513 tokens), then the out-projection;
- train, T <= 64: the attention is ``fused_proj_attention_train`` (its
  forward and backward kernels, with hashed probability dropout);
- train, T > 64 (long clips): q/k/v from one plain product, the attention
  core through ``ops/flash.py``'s autograd Function (the short flash kernel
  or the blockwise one in lengths mode, each with in-kernel hashed dropout,
  and their backward kernels), then a plain out-projection;
- under a context mesh (``--context_parallel``, ``parallel/mesh.py``), a
  ``seq_shard`` layer (the STLT temporal encoder) runs ring attention
  (``ops/ring.py``, ``layers.py:206-218, 358-365``): q/k/v and the
  out-projection as plain products, since JAX turns its fused projection
  kernels off under the ring and computes them outside Pallas, the
  attention core one blockwise kernel call per ring step (in training its
  backward one blockwise backward call per step); the layer tail stays
  fused;
- train, the tail: JAX's gate (``ops/fused_tail_train.tail_train_wants``)
  on the model's clip length, which the encoders take as ``clip_frames``
  (the spatial stage's frame axis, the temporal stage's frame count). From
  ``TAIL_TRAIN_MIN_FRAMES = 256`` frames on, the tail is
  ``fused_layer_tail_train`` (the train forward kernel and its three
  backward kernels, with the three dropout sites hashed in them; dead tokens
  zeroed); below, the plain chain of ``layers.py:512-561`` with the same
  hashed dropout sites (``ops/dropout.py``), as JAX runs it there. The two
  are one function in f32; in bf16 the fused op adds ``b1`` and ``b2`` in
  f32 before rounding, the chain after.

Under a model mesh (``--model_parallel M``, ``parallel/sharding.py``) each
rank holds N / M heads and FF / M hidden units (Megatron's split): a
replicated activation enters the column-sharded layers (q/k/v,
``linear1``) through ``parallel/mesh.model_copy`` (backward: the sum of
the ranks' parts of its gradient) and the row-sharded products
(``out_proj``, ``linear2``) leave as f32 partials summed by
``parallel/mesh.model_sum`` (backward: the identity), before the
replicated bias; the fused rows run their partial modes (rows 1, 2 and 5
in eval, rows 3 and 4 in training) and their sum epilogues. The dropout
bits of a rank's heads and hidden units are hashed at their global
indices (m N / M + n, m FF / M + c), so M ranks drop the one process's
bits. Training there takes clips below the fused train tail's gate and
no ring (the rest waits for ``ROADMAP.md`` A9 (model axis, long-clip
training)).

The fused ops run the CUDA kernels on a CUDA tensor and their plain versions
on a CPU tensor. In train mode each layer takes two explicit uint32 seeds,
(attention, tail), where JAX draws two from its ``dropout`` stream; the
encoder draws them from a ``torch.Generator`` it is given.

Every dropout site hashes (or draws) its bits at GLOBAL coordinates, as
JAX's GSPMD step does: a layer takes ``row0``, the global index of its
first row or the map of its rows (``ops/dropout.RowMap``), and its
attention hashes at rows g(b) and its tail at the tokens of ``token0``
(by default each row's T tokens, ``g(b) T + i``). Under a data axis
(``parallel/mesh.clip_span``) a rank's rows are a slice of the global
batch; under a context axis a ring rank holds t of each clip's F frames,
and its (clip, frame) rows map to the global ones by period t and stride F
(``parallel/mesh.frame_rows``). So D x C ranks drop exactly what one
process drops on the whole batch at every site off the ring; without
either axis ``row0`` is 0. The ring attention hashes with seeds of its
own (``ops/ring.py``), as JAX's does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from stlt_tpu_torch.ops import fused_encoder as fe
from stlt_tpu_torch.ops import fused_tail_train as ftt
from stlt_tpu_torch.ops.attention import dot_product_attention
from stlt_tpu_torch.ops.dropout import (TAG_ATTN_DROP, TAG_MID_DROP, TAG_OUT_DROP, RowMap, Rows,
                                        hashed_dropout)
from stlt_tpu_torch.ops.flash import _BLOCKWISE_MIN_SEQ
from stlt_tpu_torch.ops.ring import ring_attention
from stlt_tpu_torch.parallel.mesh import (active_context_mesh, active_model_mesh, all_gather, clip_span,
                                          frame_span, model_copy, model_sum)


def apply_layer_norm(x, scale, bias, eps: float, dtype: torch.dtype) -> torch.Tensor:
    """flax.linen.LayerNorm step for step: promote to f32, fast variance
    clipped at 0, scale folded into the rsqrt, output cast to ``dtype``."""
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    mul = torch.rsqrt(var + eps) * scale.to(torch.float32)
    return ((x32 - mu) * mul + bias.to(torch.float32)).to(dtype)


def apply_dense(x, linear: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)`` on a torch Linear's parameters: operands
    and bias in the compute dtype, the product rounded before the bias add."""
    y = torch.matmul(x.to(dtype), linear.weight.to(dtype).t())
    return y + linear.bias.to(dtype)


def row_parallel_dense(x, linear: nn.Linear, dtype: torch.dtype, mesh=None) -> torch.Tensor:
    """:func:`apply_dense` of a row-sharded layer (``out_proj``,
    ``linear2``): under a model mesh this rank's partial ``x W_m^T`` in f32
    (the operands in the compute dtype), summed over the model group in
    f32 (``parallel/mesh.model_sum``: its backward the identity, so x and
    W_m get the rank's own gradients), rounded to the compute dtype, then
    the replicated bias added in it, as apply_dense rounds the product and
    adds the bias (the bias's gradient is then its whole one on every rank,
    never summed over the group). Without a mesh :func:`apply_dense`."""
    if mesh is None:
        return apply_dense(x, linear, dtype)
    f32 = torch.float32
    partial = torch.matmul(x.to(dtype).to(f32), linear.weight.to(dtype).to(f32).t())
    return model_sum(partial, mesh).to(dtype) + linear.bias.to(dtype)


def column_input(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """A replicated activation entering a column-sharded layer (q/k/v,
    ``linear1``, ``fc1``) under a model mesh: ``parallel/mesh.model_copy``,
    whose backward sums the ranks' parts of its gradient; x itself
    without a mesh."""
    return x if mesh is None else model_copy(x, mesh)


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, mesh):
        ctx.mesh, ctx.width = mesh, h.shape[-1]
        parts = all_gather(h.to(torch.float32), mesh, mesh.model_group)
        return torch.cat(list(parts), dim=-1).to(h.dtype)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.mesh.model_index * ctx.width
        return g[..., lo:lo + ctx.width], None


def gather_columns(h: torch.Tensor, mesh=None) -> torch.Tensor:
    """A column-sharded layer's output (``fc1``) with every model rank's
    columns, in rank order (whole columns, so one process's bits), the
    exchange in f32; its backward is this rank's columns of the cotangent.
    ``h`` itself without a mesh."""
    if mesh is None:
        return h
    return _GatherColumns.apply(h, mesh)


def activation_fn(name: str, dtype: torch.dtype):
    """GELU is exact erf in f32 and the tanh approximation in bf16, taken
    op for op in the input's dtype as ``jax.nn.gelu`` takes it."""
    approximate = dtype == torch.bfloat16
    return lambda x: fe.activation_fn(x, name, approximate)


def draw_seeds(generator: Optional[torch.Generator], n: int):
    """``n`` uint32 dropout seeds from ``generator``, in order."""
    if generator is None:
        raise ValueError("train mode with dropout needs a torch.Generator for its seeds")
    return torch.randint(0, 2 ** 32, (n,), generator=generator, dtype=torch.int64).tolist()


def embedding_dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]):
    """flax ``nn.Dropout``: keep with probability 1-rate, kept values divided
    by 1-rate in x's dtype. The mask is drawn on x's device from a generator
    seeded by one draw of ``generator``, over the global batch's shape (x's
    clips are rows [first, first + n) of it, :func:`parallel.mesh.clip_span`;
    under a context mesh x's dim 1 is this ring rank's frames [f0, f0 + t)
    of the clips' F, :func:`parallel.mesh.frame_span`), and x takes its
    rows and frames: a data or ring rank drops what one process drops
    there."""
    if rate <= 0.0:
        return x
    seed = draw_seeds(generator, 1)[0]
    first, total = clip_span(x.shape[0])
    f0, frames = frame_span(x.shape[1])
    device_gen = torch.Generator(device=x.device).manual_seed(seed)
    keep = torch.rand((total, frames, *x.shape[2:]), generator=device_gen, device=x.device)
    keep = keep[first:first + x.shape[0], f0:f0 + x.shape[1]] >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


def init_linear_(linear: nn.Linear, generator: torch.Generator, *, zero_bias: bool = False) -> None:
    """torch ``nn.Linear`` default init, U(+-1/sqrt(fan_in)), from ``generator``."""
    bound = 1.0 / math.sqrt(linear.in_features)
    uniform_(linear.weight, bound, generator)
    if zero_bias:
        nn.init.zeros_(linear.bias)
    else:
        uniform_(linear.bias, bound, generator)


class MultiHeadAttention(nn.Module):
    """Self- or cross-attention with torch ``nn.MultiheadAttention``'s
    parameters. ``causal`` declares that the bias it gets is causal (the
    temporal encoders): the lengths mode then masks keys above the diagonal
    too. ``seq_shard``: its token axis is the frame axis, sharded over the
    context axis when a context mesh is active (ring attention)."""

    def __init__(self, hidden_size: int, num_heads: int, dtype: torch.dtype,
                 generator: torch.Generator, dropout_rate: float = 0.0, causal: bool = False,
                 seq_shard: bool = False):
        super().__init__()
        assert hidden_size % num_heads == 0
        self.num_heads = num_heads
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.causal = causal
        self.seq_shard = seq_shard
        self.in_proj_weight = nn.Parameter(torch.empty(3 * hidden_size, hidden_size))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * hidden_size))
        self.out_proj = nn.Linear(hidden_size, hidden_size)
        # xavier-uniform over the stacked [3H, H] weight, zero biases.
        uniform_(self.in_proj_weight, math.sqrt(6.0 / (4.0 * hidden_size)), generator)
        init_linear_(self.out_proj, generator, zero_bias=True)

    def forward(self, x, bias=None, rows_live=None, seed: Optional[int] = None,
                kv_lengths=None, context=None, row0: Rows = 0) -> torch.Tensor:
        """``kv_lengths`` [B]: per-row live key counts (pads tail-contiguous),
        used in place of ``bias`` from ``_BLOCKWISE_MIN_SEQ`` tokens on;
        ``context`` [B, S, H]: the keys and values of a cross-attention
        (queries from x), see :meth:`_cross_attention`; ``row0``: the global
        index of x's first row, or the rows' map, at which the dropout bits
        are hashed (the long-clip and cross-attention kernels, rows 6-10,
        take an offset only)."""
        model = active_model_mesh()
        if context is not None:
            return self._cross_attention(x, context, bias, seed, row0, model)
        ring = active_context_mesh() if self.seq_shard else None
        if model is not None and ring is not None and self.training:
            raise NotImplementedError("training under --model_parallel with --context_parallel is not "
                                      "ported yet: it waits for ROADMAP.md item A9 (model axis, "
                                      "long-clip training)")
        if ring is not None or x.shape[1] > fe._KERNEL_MAX_SEQ:
            return self._projected_attention(x, bias, seed, kv_lengths, ring, row0, model)
        if model is not None:  # this rank's heads, its partial summed over the model group
            args = (column_input(x.to(self.dtype), model), self.in_proj_weight.t(), self.in_proj_bias,
                    self.out_proj.weight.t(), bias)
            kw = dict(num_heads=self.num_heads, compute_dtype=self.dtype, rows_live=rows_live)
            if self.training:
                head0, heads = self._head_base(model)
                partial = fe.fused_proj_attention_train_partial(
                    *args, seed, dropout_rate=self.dropout_rate, row0=row0, head0=head0, heads=heads, **kw)
            else:
                partial = fe.fused_proj_attention_partial(*args, **kw)
            return fe.sublayer_sum(model_sum(partial, model), self.out_proj.bias,
                                   compute_dtype=self.dtype, rows_live=rows_live)
        args = (x.to(self.dtype), self.in_proj_weight.t(), self.in_proj_bias,
                self.out_proj.weight.t(), self.out_proj.bias, bias)
        kw = dict(num_heads=self.num_heads, compute_dtype=self.dtype, rows_live=rows_live)
        if self.training:
            return fe.fused_proj_attention_train(*args, seed, dropout_rate=self.dropout_rate,
                                                 row0=row0, **kw)
        return fe.fused_proj_attention(*args, **kw)

    def _head_base(self, model):
        """(head0, heads): this rank's first head and the model's N, at which
        its dropout bits are hashed. Under a model mesh rank m holds heads
        [m N / M, (m + 1) N / M) of the N; without one, its own N."""
        if model is None:
            return 0, self.num_heads
        return model.model_index * self.num_heads, model.model_size * self.num_heads

    def _projected_attention(self, x, bias, seed, kv_lengths, ring=None,
                             row0: int = 0, model=None) -> torch.Tensor:
        """T > 64 (``layers.py:315-374``), or any T under the ring: q/k/v
        from one plain product, viewed as [B, T, N, D] without a copy, the
        attention core (in train mode with the layer's dropout seed, its
        gradients from the backward kernels; under the ring ``ring_attention``
        on this rank's frames, with ``kv_lengths`` when given and the dense
        bias rows otherwise), then the out-projection (under a ``model`` mesh
        this rank's heads, the out-projection's partial summed over the
        model group: :func:`row_parallel_dense`). Dead rows are left to the
        layer tail, as in JAX."""
        B, T, _ = x.shape
        N, dt = self.num_heads, self.dtype
        H = self.in_proj_weight.shape[0] // 3  # this rank's q/k/v width
        x = column_input(x.to(dt), model)
        qkv = torch.matmul(x, self.in_proj_weight.to(dt).t()) + self.in_proj_bias.to(dt)
        q, k, v = (qkv[..., i * H:(i + 1) * H].unflatten(-1, (N, H // N)) for i in range(3))
        drop = self.training and self.dropout_rate > 0.0
        if ring is not None:
            out = ring_attention(
                q, k, v, None if kv_lengths is not None else bias, ring,
                kv_lengths=kv_lengths, causal=self.causal,
                dropout_seed=seed if drop else None, dropout_rate=self.dropout_rate if drop else 0.0,
            )
            return row_parallel_dense(out.reshape(B, T, H), self.out_proj, dt, model)
        use_lengths = kv_lengths is not None and T >= _BLOCKWISE_MIN_SEQ
        head0, heads = self._head_base(model) if drop else (0, None)
        out = dot_product_attention(
            q, k, v, None if use_lengths else bias, causal=self.causal,
            kv_lengths=kv_lengths if use_lengths else None,
            dropout_seed=seed if drop else None, dropout_rate=self.dropout_rate if drop else 0.0,
            dropout_row0=row0, dropout_head0=head0, dropout_heads=heads,
        )
        return row_parallel_dense(out.reshape(B, T, H), self.out_proj, dt, model)

    def _cross_attention(self, x, ctx, bias, seed, row0: int = 0, model=None) -> torch.Tensor:
        """Cross-attention, JAX's dispatch (``layers.py:263-285, 315-374``):
        one parameter set, Wq the rows [0, H) of ``in_proj_weight`` and
        Wk, Wv the rows [H, 3H). In eval with T, S <= 64 it is one fused op
        (``fe.fused_cross_attention``); otherwise q and kv come from plain
        products and the attention core from ``dot_product_attention`` with
        the dense bias (the short flash kernel to 512 tokens, the blockwise
        kernel in dense-bias mode from 513), then the out-projection. Under a
        ``model`` mesh both take this rank's heads and sum the
        out-projection's partial over the model group (the fused op's
        partial mode and :func:`fe.sublayer_sum`, or
        :func:`row_parallel_dense`)."""
        B, T, _ = x.shape
        S = ctx.shape[1]
        N, dt = self.num_heads, self.dtype
        w, b = self.in_proj_weight, self.in_proj_bias
        H = w.shape[0] // 3  # this rank's q/k/v width
        if not self.training and max(T, S) <= fe._KERNEL_MAX_SEQ:
            if model is not None:
                partial = fe.fused_cross_attention_partial(
                    x.to(dt), ctx.to(dt), w[:H].t(), b[:H], w[H:].t(), b[H:],
                    self.out_proj.weight.t(), bias, num_heads=N, compute_dtype=dt)
                return fe.sublayer_sum(model_sum(partial, model), self.out_proj.bias,
                                       compute_dtype=dt, op="fused_cross_attention")
            return fe.fused_cross_attention(
                x.to(dt), ctx.to(dt), w[:H].t(), b[:H], w[H:].t(), b[H:],
                self.out_proj.weight.t(), self.out_proj.bias, bias, num_heads=N, compute_dtype=dt,
            )
        q = torch.matmul(column_input(x.to(dt), model), w[:H].to(dt).t()) + b[:H].to(dt)
        kv = torch.matmul(column_input(ctx.to(dt), model), w[H:].to(dt).t()) + b[H:].to(dt)
        drop = self.training and self.dropout_rate > 0.0
        head0, heads = self._head_base(model) if drop else (0, None)
        out = dot_product_attention(
            q.unflatten(-1, (N, H // N)), kv[..., :H].unflatten(-1, (N, H // N)),
            kv[..., H:].unflatten(-1, (N, H // N)), bias, causal=self.causal,
            dropout_seed=seed if drop else None, dropout_rate=self.dropout_rate if drop else 0.0,
            dropout_row0=row0, dropout_head0=head0, dropout_heads=heads,
        )
        return row_parallel_dense(out.reshape(B, T, H), self.out_proj, dt, model)


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer with torch ``nn.TransformerEncoderLayer``'s
    parameters: ``norm2(u + FFN(u))`` for ``u = norm1(x + self_attn(x))``."""

    def __init__(self, hidden_size: int, num_heads: int, ff_size: int, *,
                 activation: str, layer_norm_eps: float, dtype: torch.dtype,
                 generator: torch.Generator, dropout_rate: float = 0.0, causal: bool = False,
                 seq_shard: bool = False):
        super().__init__()
        self.activation = activation
        self.layer_norm_eps = layer_norm_eps
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.self_attn = MultiHeadAttention(hidden_size, num_heads, dtype, generator, dropout_rate,
                                            causal, seq_shard)
        self.linear1 = nn.Linear(hidden_size, ff_size)
        self.linear2 = nn.Linear(ff_size, hidden_size)
        self.norm1 = nn.LayerNorm(hidden_size, eps=layer_norm_eps)
        self.norm2 = nn.LayerNorm(hidden_size, eps=layer_norm_eps)
        init_linear_(self.linear1, generator)
        init_linear_(self.linear2, generator)

    def forward(self, x, bias=None, rows_live=None, tokens_live=None, seeds=None,
                kv_lengths=None, clip_frames: int = 0, row0: Rows = 0,
                token0: Optional[Rows] = None) -> torch.Tensor:
        """``seeds``: (attention, tail) uint32 dropout seeds, used in train
        mode with a nonzero dropout rate; ``kv_lengths``: see
        :meth:`MultiHeadAttention.forward`; ``clip_frames``: the clip length
        of the model, which picks the train tail (0: short or unknown);
        ``row0``: the global index of x's first row or the rows' map (the
        attention's); ``token0``: the tail's token map (default: each row's
        T tokens, ``RowMap.of(row0).scaled(T)``)."""
        if self.training:
            if self.dropout_rate > 0.0 and seeds is None:
                raise ValueError("train mode with dropout needs the layer's two dropout seeds")
            attn_seed, tail_seed = seeds if seeds is not None else (None, None)
            attn_out = self.self_attn(x, bias, rows_live=rows_live, seed=attn_seed,
                                      kv_lengths=kv_lengths, row0=row0)
            if token0 is None:
                token0 = RowMap.of(row0).scaled(x.shape[1])
            if ftt.tail_train_wants(clip_frames):
                return self._fused_train_tail(x, attn_out, tail_seed, rows_live, tokens_live,
                                              token0)
            return self._train_tail(x, attn_out, tail_seed, token0)
        attn_out = self.self_attn(x, bias, rows_live=rows_live, kv_lengths=kv_lengths)
        model = active_model_mesh()
        if model is not None:  # this rank's FF / M units, linear2's partial summed over the group
            partial, u = fe.fused_layer_tail_partial(
                x, attn_out, self.norm1.weight, self.norm1.bias, self.linear1.weight.t(),
                self.linear1.bias, self.linear2.weight.t(), eps=self.layer_norm_eps,
                compute_dtype=self.dtype, activation=self.activation,
                gelu_approximate=self.dtype == torch.bfloat16, rows_live=rows_live,
                tokens_live=tokens_live)
            return fe.fused_layer_tail_sum(
                model_sum(partial, model), u, self.linear2.bias, self.norm2.weight,
                self.norm2.bias, eps=self.layer_norm_eps, compute_dtype=self.dtype,
                rows_live=rows_live, tokens_live=tokens_live)
        return fe.fused_layer_tail(
            x, attn_out, self.norm1.weight, self.norm1.bias,
            self.linear1.weight.t(), self.linear1.bias,
            self.linear2.weight.t(), self.linear2.bias,
            self.norm2.weight, self.norm2.bias,
            eps=self.layer_norm_eps, compute_dtype=self.dtype,
            activation=self.activation,
            gelu_approximate=self.dtype == torch.bfloat16,
            rows_live=rows_live, tokens_live=tokens_live,
        )

    def _fused_train_tail(self, x, attn_out, seed: Optional[int], rows_live,
                          tokens_live, token0: Rows = 0) -> torch.Tensor:
        """The fused train tail (``layers.py:480-510``): one op, forward and
        backward, dead tokens zeroed. Not under a model mesh: its partial
        modes wait (``train.check_flags`` refuses such a clip)."""
        if active_model_mesh() is not None:
            raise NotImplementedError("the fused train tail under --model_parallel is not ported yet: "
                                      "it waits for ROADMAP.md item A9 (model axis, long-clip training)")
        return ftt.fused_layer_tail_train(
            x, attn_out, self.norm1.weight, self.norm1.bias,
            self.linear1.weight.t(), self.linear1.bias,
            self.linear2.weight.t(), self.linear2.bias,
            self.norm2.weight, self.norm2.bias,
            eps=self.layer_norm_eps, compute_dtype=self.dtype, activation=self.activation,
            gelu_approximate=self.dtype == torch.bfloat16,
            dropout_rate=self.dropout_rate, seed=seed if self.dropout_rate > 0.0 else None,
            rows_live=rows_live, tokens_live=tokens_live, token0=token0,
        )

    def _train_tail(self, x, attn_out, seed: Optional[int], token0: Rows = 0) -> torch.Tensor:
        """The plain train tail (``layers.py:512-561``): hashed dropout on the
        attention output, on the activation and on the FFN output, each its
        own stream of one seed at the global tokens from ``token0``; no
        dead-token zeroing, as in JAX. Under a model mesh (Megatron's FFN)
        u enters ``linear1``'s FF / M columns through
        :func:`column_input`, the activation's site hashes those columns at
        their global features m FF / M + c of the FF, and ``linear2`` is
        :func:`row_parallel_dense`; the attention and out sites act on the
        summed H-wide values, the same on every rank."""
        dt, rate = self.dtype, self.dropout_rate
        drop = rate > 0.0
        model = active_model_mesh()
        if drop:
            attn_out = hashed_dropout(attn_out, seed, TAG_ATTN_DROP, rate, token0)
        u = apply_layer_norm(x + attn_out, self.norm1.weight, self.norm1.bias, self.layer_norm_eps, dt)
        h = activation_fn(self.activation, dt)(apply_dense(column_input(u, model), self.linear1, dt))
        if drop:
            cols = h.shape[-1]
            m, M = (0, 1) if model is None else (model.model_index, model.model_size)
            h = hashed_dropout(h, seed, TAG_MID_DROP, rate, token0, f0=m * cols, width=M * cols)
        h = row_parallel_dense(h, self.linear2, dt, model)
        if drop:
            h = hashed_dropout(h, seed, TAG_OUT_DROP, rate, token0)
        return apply_layer_norm(u + h, self.norm2.weight, self.norm2.bias, self.layer_norm_eps, dt)


class TransformerEncoder(nn.Module):
    """Stack of post-LN encoder layers (torch ``nn.TransformerEncoder``).

    With ``remat`` (``--remat``, JAX's ``nn.remat`` of each layer,
    ``layers.py:563-606``), each layer of a train-mode forward that records
    gradients runs under ``torch.utils.checkpoint.checkpoint`` (non-reentrant):
    the layer keeps only its inputs, and the backward recomputes its forward
    (its kernels launch again) before taking its gradients. The layer's
    dropout seeds are drawn before the checkpointed call, so the recompute
    hashes the same keep bits; no RNG state is saved or restored
    (``preserve_rng_state=False``), since no layer draws from a global RNG."""

    def __init__(self, num_layers: int, hidden_size: int, num_heads: int, ff_size: int, *,
                 activation: str, layer_norm_eps: float, dtype: torch.dtype,
                 generator: torch.Generator, dropout_rate: float = 0.0, causal: bool = False,
                 seq_shard: bool = False, remat: bool = False):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.remat = remat
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(
                hidden_size, num_heads, ff_size, activation=activation,
                layer_norm_eps=layer_norm_eps, dtype=dtype, generator=generator,
                dropout_rate=dropout_rate, causal=causal, seq_shard=seq_shard,
            )
            for _ in range(num_layers)
        )

    def forward(self, x, bias=None, rows_live=None, tokens_live=None,
                generator: Optional[torch.Generator] = None, kv_lengths=None,
                clip_frames: int = 0, row0: Rows = 0,
                token0: Optional[Rows] = None) -> torch.Tensor:
        """In train mode with dropout, each layer's (attention, tail) seeds
        are drawn from ``generator``, layer by layer (a ring attention
        folds its seed with the rank's coordinates itself);
        ``clip_frames``, ``row0`` and ``token0`` (the rows' and the tail
        tokens' global indices) go to every layer
        (:meth:`TransformerEncoderLayer.forward`)."""
        remat = self.remat and self.training and torch.is_grad_enabled()
        for layer in self.layers:
            seeds = None
            if self.training and self.dropout_rate > 0.0:
                seeds = tuple(draw_seeds(generator, 2))
            kw = dict(rows_live=rows_live, tokens_live=tokens_live, seeds=seeds,
                      kv_lengths=kv_lengths, clip_frames=clip_frames, row0=row0, token0=token0)
            if remat:
                x = checkpoint(layer, x, bias, use_reentrant=False, preserve_rng_state=False, **kw)
            else:
                x = layer(x, bias, **kw)
        return x
