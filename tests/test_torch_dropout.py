"""The port's counter-hashed dropout bits (stlt_tpu_torch.ops.dropout)
against the JAX package's (ops/flash.py, ops/fused_tail_train.py): equal bit
for bit, including counters and lanes that pass 2**32 and wrap."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlt_tpu.ops import flash as jflash
from stlt_tpu.ops import fused_tail_train as jtail
from stlt_tpu_torch.ops import dropout as tdrop

SEEDS = [0, 1234, 2 ** 31 + 7, 2 ** 32 - 1]
TAGS = [tdrop.TAG_ATTN_DROP, tdrop.TAG_MID_DROP, tdrop.TAG_OUT_DROP]


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.float32)


def test_constants_match_jax():
    assert (tdrop.TAG_ATTN_DROP, tdrop.TAG_MID_DROP, tdrop.TAG_OUT_DROP) == (
        jtail.TAG_ATTN_DROP, jtail.TAG_MID_DROP, jtail.TAG_OUT_DROP)
    for rate in (0.0, 0.1, 0.25, 0.5, 1.0 - 2.0 ** -40, 1.0):
        assert tdrop.dropout_thresh(rate) == jflash._dropout_thresh(rate)


def test_lowbias32_matches_jax():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.integers(0, 2 ** 32, 4096, dtype=np.uint64),
                        np.array([0, 1, 2 ** 31, 2 ** 32 - 1], np.uint64)])
    want = np.asarray(jflash._lowbias32(jnp.asarray(x.astype(np.uint32))))
    got = tdrop.lowbias32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("B,N,T,S,rate", [
    (3, 4, 17, 17, 0.1), (5, 2, 8, 8, 0.25), (2, 12, 33, 33, 0.45), (1, 1, 1, 1, 0.3),
])
def test_hash_keep_mask_matches_jax(seed, B, N, T, S, rate):
    # Rates below 0.5: JAX's hash_keep_mask compares with the threshold as a
    # Python int, which overflows int32 from rate 0.5 on (its kernels'
    # _keep_block casts it to uint32; the tests below reach those rates).
    want = np.asarray(jflash.hash_keep_mask(jnp.uint32(seed), B, N, T, S, rate))
    got = tdrop.hash_keep_mask(seed, B, N, T, S, rate)
    assert got.shape == (B, N, T, S) and got.dtype == torch.bool
    np.testing.assert_array_equal(_bits(got), want)
    if got.numel() > 100:
        assert 0 < got.float().mean() < 1


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("rows,width,rate", [(17, 64, 0.1), (40, 256, 0.2), (3, 3072, 0.5)])
def test_hash_keep_rows_matches_jax(seed, tag, rows, width, rate):
    want = np.asarray(jtail.hash_keep_rows(jnp.uint32(seed), tag, rows, width, rate))
    got = tdrop.hash_keep_rows(seed, tag, rows, width, rate)
    np.testing.assert_array_equal(_bits(got), want)


@pytest.mark.parametrize("seed", [7, 2 ** 32 - 3])
@pytest.mark.parametrize("b0,n,t0,s0,num_heads,s_total", [
    (2 ** 31 + 5, 3, 70_000, 69_990, 12, 70_003),   # b*N and t*S + s both pass 2**32
    (0, 0, 2 ** 32 - 2, 0, 4, 17),                   # t itself near 2**32
    (123, 11, 5, 3, 12, 17),
])
def test_keep_block_with_offsets_matches_jax(seed, b0, n, t0, s0, num_heads, s_total):
    assert (t0 + 4) * s_total + s0 > 2 ** 32 or b0 < 2 ** 31
    shape = (3, 4, 9)
    thresh = jflash._dropout_thresh(0.7)
    want = np.asarray(jflash._keep_block(jnp.uint32(seed), b0, n, t0, s0, shape, num_heads,
                                         s_total, thresh))
    got = tdrop.keep_block(seed, b0, n, t0, s0, shape, num_heads, s_total, thresh)
    np.testing.assert_array_equal(_bits(got), want)


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("r0,f0,width", [(5_000_000, 100, 3072), (2 ** 32 - 2, 0, 768), (9, 7, 64)])
def test_keep_rows_with_offsets_matches_jax(tag, r0, f0, width):
    shape = (4, 33)
    thresh = jflash._dropout_thresh(0.1)
    want = np.asarray(jtail._keep_rows(jnp.uint32(99), tag, r0, f0, shape, width, thresh))
    got = tdrop.keep_rows(99, tag, r0, f0, shape, width, thresh)
    np.testing.assert_array_equal(_bits(got), want)


def test_hashed_dropout_matches_the_jax_chain():
    """One tail dropout site as layers.py:536-545 computes it."""
    rng = np.random.default_rng(1)
    v = rng.normal(0, 1, (3, 5, 48)).astype(np.float32)
    seed, rate = 4242, 0.2
    keep = np.asarray(jtail.hash_keep_rows(jnp.uint32(seed), tdrop.TAG_MID_DROP, 15, 48, rate))
    want = (jnp.asarray(v) * keep.reshape(v.shape) * (1.0 / (1.0 - rate))).astype(jnp.float32)
    got = tdrop.hashed_dropout(torch.from_numpy(v), seed, tdrop.TAG_MID_DROP, rate)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
