"""The data axis (``--num_processes N``) in one process, on the CPU.

- (a) model invariance, no collectives: STLT and CACNF at dropout 0.1 in
  train mode. Run on the whole batch, and on its two halves with a data
  mesh of 2 active (``parallel/mesh.Mesh``, ranks 0 and 1: every dropout
  site hashed or drawn at the half's global clips, ``clip_span``), the
  logits agree at atol 1e-6, and the halves' gradients
  (``training/loop._data_rank_loss_and_grads`` with the all-reduce taken
  out, then summed) agree with the whole batch's step at atol 1e-5, with
  one microbatch and with ``--grad_accum_steps 2``. A rank that hashes at
  its local rows (a mesh whose ``first_clip`` is 0) is caught.
- (d) the plain versions with a base: ``hash_keep_mask`` / ``hash_keep_rows``
  at a base equal the JAX package's masks of the longer batch, sliced; each
  dropout op's plain version at base b equals rows [b:] of its launch at
  base 0 on the whole input (forward and gradients).
- the CLIs' flags: the data axis taken, a batch or a ``--grad_accum_steps``
  that the data axis does not divide refused, ``--coordinator_address``
  alone refused.

The ranks' collectives (two gloo ranks against JAX's data mesh and the
CLIs on two ranks): ``tests/test_torch_data_axis_ranks.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_layout_batch
from stlt_tpu.ops import flash as jflash
from stlt_tpu.ops import fused_tail_train as jtail
from stlt_tpu_torch import configs
from stlt_tpu_torch import predict as port_predict
from stlt_tpu_torch import train as port_train
from stlt_tpu_torch.data.loader import VALID_TOTAL
from stlt_tpu_torch.models import models_factory
from stlt_tpu_torch.ops import dropout as tdrop
from stlt_tpu_torch.ops import flash
from stlt_tpu_torch.ops import fused_encoder as fe
from stlt_tpu_torch.ops import fused_tail_train as ftt
from stlt_tpu_torch.parallel.mesh import Mesh, set_active_mesh
from stlt_tpu_torch.parser import build_parser
from stlt_tpu_torch.training import loop
from stlt_tpu_torch.training.criterion import make_criterion
from stlt_tpu_torch.training.optimizer import frozen_stats_mask

LOGITS_ATOL = 1e-6
GRAD_ATOL = 1e-5
RATE = 0.1
SEED = 11
CPU = torch.device("cpu")

STLT_KW = dict(num_classes=7, unique_categories=4, hidden_size=32, num_attention_heads=4,
               num_spatial_layers=1, num_temporal_layers=2, hidden_dropout_prob=RATE)
CACNF_KW = dict(num_classes=5, unique_categories=4, hidden_size=32, num_attention_heads=4,
                num_spatial_layers=1, num_temporal_layers=1, num_appearance_layers=1,
                num_fusion_layers=1, appearance_num_frames=1, resnet_depth=10,
                hidden_dropout_prob=RATE)


class _LocalRows(Mesh):
    """A data mesh whose ranks hash at their local rows: the fault the
    global base is there to prevent."""

    def first_clip(self, clips: int) -> int:
        return 0


def _case(name: str):
    """(model, batch) of a tiny f32 model at dropout 0.1 and a seeded batch
    of 8 (STLT) or 4 (CACNF) clips, the last one padding."""
    frames = 8
    clips = 8 if name == "stlt" else 4
    kw = STLT_KW if name == "stlt" else CACNF_KW
    cfg = configs.model_configs_factory[name](layout_num_frames=frames, **kw)
    model = models_factory[name](cfg, torch.Generator().manual_seed(SEED))
    trainable = frozen_stats_mask(model)  # as make_optimizer freezes them: no FrozenBatchNorm grads
    for n, p in model.named_parameters():
        p.requires_grad_(trainable[n])
    batch = _synthetic_layout_batch(clips, frames, 4, 4, seed=3, length_range=(3, frames))
    rng = np.random.default_rng(4)
    batch["labels"] = rng.integers(0, kw["num_classes"], clips).astype(np.int32)
    batch["valid"] = np.arange(clips) < clips - 1
    if name == "cacnf":
        batch["video_frames"] = rng.standard_normal((clips, 8, 32, 32, 3)).astype(np.float32)
    return model, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _half(batch, rank: int):
    h = batch["labels"].shape[0] // 2
    out = {k: v[rank * h:(rank + 1) * h] for k, v in batch.items()}
    out[VALID_TOTAL] = batch["valid"].sum()
    return out


def _inputs(batch):
    return {k: v for k, v in batch.items() if k not in ("labels", "valid", VALID_TOTAL)}


def _on_rank(rank: int, fn, mesh_cls=Mesh):
    set_active_mesh(mesh_cls((2, 1, 1), rank, "none", CPU))
    try:
        return fn()
    finally:
        set_active_mesh(None)


@pytest.mark.parametrize("name", ["stlt", "cacnf"])
def test_halves_at_their_base_give_the_whole_batch_logits(name):
    model, batch = _case(name)
    model.train()
    gen = lambda: loop.step_generator(SEED, 3)  # noqa: E731
    with torch.no_grad():
        whole = model(_inputs(batch), gen())
        halves = [_on_rank(r, lambda r=r: model(_inputs(_half(batch, r)), gen())) for r in range(2)]
        local = _on_rank(1, lambda: model(_inputs(_half(batch, 1)), gen()), _LocalRows)
    h = batch["labels"].shape[0] // 2
    for head, want in whole.items():
        got = torch.cat([halves[0][head], halves[1][head]])
        torch.testing.assert_close(got, want, atol=LOGITS_ATOL, rtol=0, msg=head)
        assert not torch.allclose(local[head], want[h:], atol=1e-3), \
            f"{head}: rank 1 hashing at its local rows gives the whole batch's logits"


def _grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("name", ["stlt", "cacnf"])
def test_halves_gradients_sum_to_the_whole_batch_step(name, grad_accum, monkeypatch):
    """Each half's loss (its valid rows over the global batch's valid count)
    and gradients, as a data rank computes them before the all-reduce; their
    sums against the one process's step on the whole batch."""
    model, batch = _case(name)
    criterion = make_criterion("something")
    want_loss = loop.loss_and_grads(model, criterion, batch, loop.step_generator(SEED, 5),
                                    grad_accum)
    want = _grads(model)
    monkeypatch.setattr(loop, "all_sum", lambda x, mesh: x)  # this rank's part alone
    losses, parts = [], []
    for r in range(2):
        def part(r=r):
            model.zero_grad(set_to_none=True)
            mesh = Mesh((2, 1, 1), r, "none", CPU)
            return loop._data_rank_loss_and_grads(model, criterion, _half(batch, r),
                                                  loop.step_generator(SEED, 5), grad_accum, mesh)
        losses.append(_on_rank(r, part))
        parts.append(_grads(model))
    torch.testing.assert_close(losses[0] + losses[1], want_loss, atol=GRAD_ATOL, rtol=0)
    assert set(parts[0]) == set(parts[1]) == set(want)
    for n, g in want.items():
        torch.testing.assert_close(parts[0][n] + parts[1][n], g, atol=GRAD_ATOL, rtol=0, msg=n)


def test_a_rank_without_the_global_valid_count_is_refused():
    model, batch = _case("stlt")
    half = {k: v for k, v in _half(batch, 0).items() if k != VALID_TOTAL}
    mesh = Mesh((2, 1, 1), 0, "none", CPU)
    with pytest.raises(ValueError, match=VALID_TOTAL):
        _on_rank(0, lambda: loop.loss_and_grads(model, make_criterion("something"), half,
                                                loop.step_generator(0, 0)))
    assert mesh.first_clip(4) == 0 and Mesh((2, 1, 1), 1, "none", CPU).first_clip(4) == 4


# --- (d) the plain versions with a base -----------------------------------------


@pytest.mark.parametrize("b0", [1, 5, 37])
def test_hash_keep_mask_at_a_base_is_jax_sliced(b0):
    B, N, T, S, seed = 3, 4, 9, 11, 2 ** 32 - 5
    want = np.asarray(jflash.hash_keep_mask(jnp.uint32(seed), b0 + B, N, T, S, RATE))[b0:]
    got = tdrop.hash_keep_mask(seed, B, N, T, S, RATE, b0=b0)
    np.testing.assert_array_equal(got.numpy(), want.astype(bool))


@pytest.mark.parametrize("tag", [tdrop.TAG_ATTN_DROP, tdrop.TAG_MID_DROP, tdrop.TAG_OUT_DROP])
def test_hash_keep_rows_at_a_base_is_jax_sliced(tag):
    rows, width, r0 = 7, 96, 40
    want = np.asarray(jtail.hash_keep_rows(jnp.uint32(77), tag, r0 + rows, width, RATE))[r0:]
    got = tdrop.hash_keep_rows(77, tag, rows, width, RATE, r0=r0)
    np.testing.assert_array_equal(got.numpy(), want.astype(bool))
    v = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (rows, width)).astype(np.float32))
    whole = tdrop.hashed_dropout(torch.cat([torch.zeros(r0, width), v]), 77, tag, RATE)
    torch.testing.assert_close(tdrop.hashed_dropout(v, 77, tag, RATE, r0), whole[r0:], atol=0,
                               rtol=0)


def _leaves(rng, *shapes):
    return [torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)).requires_grad_() for s in shapes]


def _rows_from(fn, leaves, b, batch_dims):
    """fn on every leaf's rows [b:] (those with a batch dim) at base b, and
    rows [b:] of fn at base 0 on the whole leaves: (outputs, gradients) of
    both, the gradients of sum(out * g) for one seeded cotangent."""
    cut = [x[b:].detach().clone().requires_grad_() if d else x for x, d in zip(leaves, batch_dims)]
    part, whole = fn(cut, b), fn(leaves, 0)
    g = torch.from_numpy(np.random.default_rng(9).normal(0, 1, whole.shape).astype(np.float32))
    (whole * g).sum().backward()
    (part * g[b:]).sum().backward()
    return part, whole[b:], [(x.grad, y.grad[b:] if d else None)
                             for x, y, d in zip(cut, leaves, batch_dims) if d]


def _check_rows(part, want, grads):
    torch.testing.assert_close(part, want, atol=1e-6, rtol=1e-6)
    for got, ref in grads:
        torch.testing.assert_close(got, ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("b", [2, 3])
def test_projection_attention_train_plain_at_a_base(b):
    """Rows 3 and 4 (the train sublayer, forward and backward)."""
    rng = np.random.default_rng(b)
    B, T, H, N = 6, 9, 32, 4
    x, wqkv, bqkv, wo, bo = _leaves(rng, (B, T, H), (H, 3 * H), (3 * H,), (H, H), (H,))

    def fn(leaves, row0):
        return fe.fused_proj_attention_train(*leaves, None, 0xABCDE, num_heads=N, dropout_rate=RATE,
                                             compute_dtype=torch.float32, row0=row0)

    _check_rows(*_rows_from(fn, [x, wqkv, bqkv, wo, bo], b, [True, False, False, False, False]))
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (B - b, T, H)).astype(np.float32)) for _ in range(3))
    bias3 = torch.zeros((1, 1, T))
    rows = torch.arange(B - b)
    got = fe.short_attention_plain(q, k, v, bias3, rows, num_heads=N, seed=5, dropout_rate=RATE, row0=b)
    pad = lambda t: torch.cat([torch.zeros(b, *t.shape[1:]), t])  # noqa: E731
    want = fe.short_attention_plain(pad(q), pad(k), pad(v), bias3, None, num_heads=N, seed=5,
                                    dropout_rate=RATE)[b:]
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("T,mode", [(70, "short"), (513, "lengths"), (513, "dense")])
def test_attention_core_plain_at_a_base(T, mode):
    """Rows 6-10 (the long-clip attention core and its backwards)."""
    rng = np.random.default_rng(T)
    B, N, D, b = 4, 2, 8, 1
    q, k, v = _leaves(rng, (B, T, N, D), (B, T, N, D), (B, T, N, D))
    lengths = torch.tensor([T, T - 9, 40, 3])
    kw = dict(kv_lengths=lengths, causal=True) if mode == "lengths" else {}

    def fn(leaves, row0):
        extra = dict(kw, kv_lengths=lengths[B - leaves[0].shape[0]:]) if kw else {}
        return flash.flash_attention(*leaves, dropout_seed=99, dropout_rate=RATE, dropout_row0=row0,
                                     **extra)

    _check_rows(*_rows_from(fn, [q, k, v], b, [True, True, True]))


def test_train_tail_plain_at_a_token_base():
    """Rows 11-14 (the fused train tail, forward and its backward)."""
    rng = np.random.default_rng(1)
    B, T, H = 4, 5, 64
    x, a = _leaves(rng, (B, T, H), (B, T, H))
    w = [torch.from_numpy(rng.normal(0, 0.1, s).astype(np.float32)).requires_grad_()
         for s in ((H,), (H,), (H, 4 * H), (4 * H,), (4 * H, H), (H,), (H,), (H,))]

    def fn(leaves, row0):
        return ftt.fused_layer_tail_train(*leaves[:2], *w, eps=1e-12, compute_dtype=torch.float32,
                                          dropout_rate=RATE, seed=4321, token0=row0 * T)

    _check_rows(*_rows_from(fn, [x, a], 1, [True, True]))


# --- the CLIs' flags --------------------------------------------------------------


def _args(*extra, model="stlt", dataset_type="layout"):
    return build_parser("test").parse_args(
        ["--dataset_name", "something", "--dataset_type", dataset_type, "--model_name", model,
         "--coordinator_address", "localhost:1", *extra])


@pytest.mark.parametrize("model,dataset_type", [
    ("stlt", "layout"), ("resnet3d", "appearance"), ("resnet3d-transformer", "appearance"),
    ("lcf", "multimodal"), ("caf", "multimodal"), ("cacnf", "multimodal"),
])
def test_every_model_takes_the_data_axis(model, dataset_type):
    args = _args("--num_processes", "4", "--batch_size", "8", "--grad_accum_steps", "2",
                 model=model, dataset_type=dataset_type)
    port_predict.check_flags(args)
    port_train.check_flags(args)


@pytest.mark.parametrize("extra,what", [
    (["--num_processes", "3", "--batch_size", "8"], "batch_size=8 does not divide the data axis \\(3\\)"),
    (["--num_processes", "2", "--batch_size", "8", "--grad_accum_steps", "8"],
     "--grad_accum_steps 8 must divide --batch_size 8 / 2 data ranks = 4 rows a rank"),
    (["--num_processes", "4", "--batch_size", "8", "--grad_accum_steps", "4"],
     "--grad_accum_steps 4 must divide --batch_size 8 / 4 data ranks = 2 rows a rank"),
    (["--context_parallel", "2", "--num_processes", "3"], "--context_parallel 2 does not divide"),
])
def test_what_the_data_axis_does_not_divide_is_refused(extra, what):
    with pytest.raises(ValueError, match=what):
        port_train.check_flags(_args(*extra))


def test_a_coordinator_without_processes_is_refused():
    args = build_parser("test").parse_args(
        ["--dataset_name", "something", "--dataset_type", "layout", "--model_name", "stlt",
         "--coordinator_address", "localhost:1"])
    with pytest.raises(ValueError, match="pass --num_processes N > 1 with it"):
        port_predict.check_flags(args)
