"""The dropout sites off the ring hash at JAX's global coordinates, on the CPU.

JAX's GSPMD step runs the embedding dropouts, the spatial attention (TPU
rows 3/4) and every layer tail on the global arrays, so it hashes them at
global indices (``stlt_tpu/ops/flash.py::hash_keep_mask``,
``stlt_tpu/ops/fused_tail_train.py::hash_keep_rows``). A port rank of a
C-ring holds t = F / C of each clip's F frames, so its (clip, frame) rows
map to the global ones by ``g(i) = (i // t) F + clip0 F + c t + i % t``
(``parallel/mesh.frame_rows``). In one process, with a ``Mesh`` of each
grid coordinate set in the registry (no process group):

- the attention keep bits at the rank's row map equal JAX's on the global
  rows, sliced to the rank's clips and frames, for C in {2, 4} with and
  without a data axis; hashing at the rank's local rows does not;
- the three tail streams' keep bits at the spatial tokens' map and at the
  temporal tokens' map equal JAX's, sliced;
- at dropout 0.1 (f32, tiny), the spatial stage and the frames embeddings
  in train mode on the rank's clips and frames equal one process's
  matching rows within 1e-6;
- the ring's ``_device_seed`` on each (d, c) of a (2, 1, 2) grid is JAX's
  ``lowbias32(seed ^ ((d M + m) C + c))``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlt_tpu.ops.flash import _lowbias32
from stlt_tpu.ops.flash import hash_keep_mask as jax_hash_keep_mask
from stlt_tpu.ops.fused_tail_train import TAG_ATTN_DROP, TAG_MID_DROP, TAG_OUT_DROP
from stlt_tpu.ops.fused_tail_train import hash_keep_rows as jax_hash_keep_rows
from stlt_tpu_torch.configs import StltModelConfig
from stlt_tpu_torch.models import models_factory
from stlt_tpu_torch.ops.dropout import RowMap, hash_keep_mask, hash_keep_rows
from stlt_tpu_torch.ops.ring import _device_seed
from stlt_tpu_torch.parallel.mesh import Mesh, frame_rows, set_active_mesh
from stlt_tpu_torch.training.loop import shard_frames

SEED, RATE = 0x5EED1234, 0.1
CLIPS, FRAMES, TOKENS, HEADS, WIDTH = 4, 8, 5, 2, 12  # global clips and frames, tokens per frame
GRIDS = [(1, 2), (2, 2), (1, 4), (2, 4)]  # (data, context)


def _ranks(data: int, context: int):
    """Each rank of a (data, 1, context) grid: (d, c, its Mesh)."""
    for d in range(data):
        for c in range(context):
            yield d, c, Mesh((data, 1, context), d * context + c, "none", torch.device("cpu"))


def _slice(global_rows: np.ndarray, d: int, c: int, data: int, context: int, per_frame: int = 1):
    """Rank (d, c)'s rows of [clips * frames * per_frame, ...] global rows."""
    b, t = CLIPS // data, FRAMES // context
    x = global_rows.reshape(CLIPS, FRAMES, per_frame, *global_rows.shape[1:])
    return x[d * b:(d + 1) * b, c * t:(c + 1) * t].reshape(-1, *global_rows.shape[1:])


@pytest.fixture
def registry():
    yield set_active_mesh
    set_active_mesh(None)


@pytest.mark.parametrize("data,context", GRIDS)
def test_attention_keep_bits_at_global_rows(registry, data, context):
    """Rows 3/4's bits: [rows, N, T, T] over the (clip, frame) rows."""
    want = np.asarray(jax_hash_keep_mask(jnp.uint32(SEED), CLIPS * FRAMES, HEADS, TOKENS, TOKENS,
                                         RATE)).astype(bool)
    b, t = CLIPS // data, FRAMES // context
    for d, c, mesh in _ranks(data, context):
        registry(mesh)
        rows = frame_rows(b, t)
        assert rows.affine == (context == 1)
        got = hash_keep_mask(SEED, b * t, HEADS, TOKENS, TOKENS, RATE, b0=rows).numpy()
        np.testing.assert_array_equal(got, _slice(want, d, c, data, context), err_msg=f"rank {(d, c)}")
        if c > 0:  # the rank's local rows are not its global ones
            local = hash_keep_mask(SEED, b * t, HEADS, TOKENS, TOKENS, RATE).numpy()
            assert not np.array_equal(local, _slice(want, d, c, data, context))


@pytest.mark.parametrize("tag", [TAG_ATTN_DROP, TAG_MID_DROP, TAG_OUT_DROP])
@pytest.mark.parametrize("stage", ["spatial", "temporal"])
@pytest.mark.parametrize("data,context", GRIDS)
def test_tail_keep_bits_at_global_tokens(registry, data, context, stage, tag):
    """The tails' streams: the spatial tail's tokens are TOKENS a
    (clip, frame) row (the row map scaled), the temporal tail's one a frame
    (the row map itself)."""
    per = TOKENS if stage == "spatial" else 1
    want = np.asarray(jax_hash_keep_rows(jnp.uint32(SEED), tag, CLIPS * FRAMES * per, WIDTH, RATE))
    b, t = CLIPS // data, FRAMES // context
    for d, c, mesh in _ranks(data, context):
        registry(mesh)
        tokens = frame_rows(b, t).scaled(per)
        got = hash_keep_rows(SEED, tag, b * t * per, WIDTH, RATE, r0=tokens).numpy()
        np.testing.assert_array_equal(got, _slice(want, d, c, data, context, per).astype(bool),
                                      err_msg=f"rank {(d, c)}")


def _device_map(args, i: int) -> int:
    """``csrc/common.cuh::RowMap`` in Python: the quotient by a multiply-high
    and a shift of 31 + ceil(log2 period), all mod 2**32."""
    base, period, stride, magic = args
    q = (i * magic) >> (31 + (period - 1).bit_length()) & 0xFFFFFFFF
    return (q * stride + base + i - q * period) & 0xFFFFFFFF


@pytest.mark.parametrize("period,stride",
                         [(1, 1), (1, 5), (3, 7), (257, 514), (2 ** 31 - 1, 2 ** 31 + 3)])
def test_row_map_kernel_args_and_wrap(period, stride):
    """The kernels' map (base, period, stride, magic) gives every global
    row mod 2**32 without a division, the affine map as period = stride =
    2**31; the keep bits of a map whose rows pass 2**32 are those of the
    64-bit global rows truncated (the counter's wrap)."""
    assert RowMap(7, 4, 4).kernel_args() == (7, 2 ** 31, 2 ** 31, 2 ** 31)
    rank = RowMap(2 ** 32 - 9, period, stride)
    args = rank.kernel_args()
    assert args[3] < 2 ** 32
    rng = np.random.default_rng(period)
    global_row = lambda i: (i // period) * stride + rank.offset + i % period  # noqa: E731
    for i in [0, 1, period - 1, period, period + 1, 2 ** 31 - 1, *rng.integers(0, 2 ** 31, 200)]:
        assert _device_map(args, int(i)) == global_row(int(i)) % 2 ** 32, i
    assert rank.rows(8).tolist() == [global_row(i) for i in range(8)]
    assert _device_map(RowMap(5).kernel_args(), 2 ** 31 - 1) == 5 + 2 ** 31 - 1
    big = RowMap(2 ** 32 - 2, 3, 6)
    rows = big.rows(6)
    assert rows.tolist() == [2 ** 32 - 2, 2 ** 32 - 1, 2 ** 32, 2 ** 32 + 4, 2 ** 32 + 5, 2 ** 32 + 6]
    got = hash_keep_rows(SEED, TAG_MID_DROP, 6, WIDTH, RATE, r0=big)
    for i, r in enumerate(rows.tolist()):
        torch.testing.assert_close(got[i], hash_keep_rows(SEED, TAG_MID_DROP, 1, WIDTH, RATE,
                                                          r0=r % 2 ** 32)[0])


def _model():
    cfg = StltModelConfig(num_classes=5, unique_categories=4, hidden_size=32, num_attention_heads=4,
                          num_spatial_layers=2, num_temporal_layers=1, layout_num_frames=FRAMES,
                          hidden_dropout_prob=RATE)
    return models_factory["stlt"](cfg, torch.Generator().manual_seed(11)).train()


def _layout_batch():
    from __graft_entry__ import _synthetic_layout_batch

    batch = _synthetic_layout_batch(CLIPS, FRAMES, TOKENS - 1, 4, seed=5, length_range=(3, FRAMES))
    return {k: torch.from_numpy(v) for k, v in batch.items() if k != "labels"}


@pytest.mark.parametrize("data,context", GRIDS)
def test_spatial_stage_and_frames_embeddings_match_one_process(registry, data, context):
    """At dropout 0.1 the sites off the ring (the two embedding dropouts,
    the spatial attention and the spatial tails) on each rank's clips and
    frames equal one process's rows; the dropout acted."""
    model, batch = _model(), _layout_batch()
    emb = model.backbone.frames_embeddings
    with torch.no_grad():
        whole_spatial = emb.layout_embedding(batch, torch.Generator().manual_seed(3))
        whole = emb(batch, torch.Generator().manual_seed(4))
        model.eval()
        assert not torch.allclose(whole, emb(batch), atol=1e-3)
        model.train()
        b, t = CLIPS // data, FRAMES // context
        for d, c, mesh in _ranks(data, context):
            registry(mesh)
            rows = {k: v[d * b:(d + 1) * b] for k, v in batch.items()}
            local, offset = shard_frames(rows, context, c)
            want = whole_spatial[d * b:(d + 1) * b, c * t:(c + 1) * t]
            torch.testing.assert_close(emb.layout_embedding(local, torch.Generator().manual_seed(3)),
                                       want, atol=1e-6, rtol=0, msg=f"rank {(d, c)} spatial stage")
            got = emb(local, torch.Generator().manual_seed(4), position_offset=offset,
                      total_frames=FRAMES)
            torch.testing.assert_close(got, whole[d * b:(d + 1) * b, c * t:(c + 1) * t], atol=1e-6,
                                       rtol=0, msg=f"rank {(d, c)} frames embeddings")


def test_device_seed_folds_every_grid_coordinate():
    """``dev = (data M + model) C + context`` on a (2, 1, 2) grid, as
    ``stlt_tpu/ops/ring.py::_device_seed`` folds it."""
    seeds = set()
    for d, c, mesh in _ranks(2, 2):
        want = int(_lowbias32(jnp.uint32(SEED) ^ jnp.uint32((d * 1 + 0) * 2 + c)))
        assert _device_seed(mesh, SEED) == want, (d, c)
        seeds.add(want)
    assert len(seeds) == 4
