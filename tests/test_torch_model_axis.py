"""The port's model axis (``--model_parallel M``) in one process, against the
JAX package on the CPU.

- ``parallel/sharding.param_spec`` against JAX's ``params_partition_specs``
  over ``jax.eval_shape`` of each of the six factory models' ``init``: every
  flax path's spec maps, through ``utils/convert.py``'s names, to the torch
  dimension the port shards (a column shard of a kernel is dim 0 of the
  torch weight, a row shard dim 1; q, k and v land in ``in_proj_*``);
- the shards' round trip at M = 2 and 4 (q/k/v in three slices a rank);
- rows 1, 2 and 5's plain partial modes of M simulated ranks, summed in f32
  and finished by their sum epilogues, against the full ops (f32, 1e-6),
  dead rows and tokens exact zeros;
- the column-sharded ``fc1`` head gathered from its shards equals one
  process's bit for bit;
- the refusals: a model axis that does not divide the heads, H or FF, and
  the kernel guards' shard widths (Hq and FF / M multiples of 64).

The JAX references run as one compiled program each (``jax.eval_shape``).
"""

import numpy as np
import pytest
import torch

import jax
from __graft_entry__ import _synthetic_layout_batch
from jax.sharding import PartitionSpec as P
from stlt_tpu.configs import make_model_config as jax_make_model_config
from stlt_tpu.models import models_factory as jax_models
from stlt_tpu.parallel.sharding import params_partition_specs
from stlt_tpu_torch import predict as port_predict
from stlt_tpu_torch import train as port_train
from stlt_tpu_torch.configs import make_model_config
from stlt_tpu_torch.models import models_factory
from stlt_tpu_torch.models.layers import apply_dense
from stlt_tpu_torch.models.stlt import ClassificationHead
from stlt_tpu_torch.ops import fused_encoder as fe
from stlt_tpu_torch.parallel import sharding
from stlt_tpu_torch.parser import build_parser
from stlt_tpu_torch.utils.convert import jax_params_to_state_dict

MODEL_KW = dict(num_classes=5, unique_categories=4, hidden_size=32, num_attention_heads=4,
                num_spatial_layers=1, num_temporal_layers=1, num_appearance_layers=1,
                num_fusion_layers=1, appearance_num_frames=1, resnet_depth=10, layout_num_frames=8)
F32 = dict(atol=1e-6, rtol=1e-6)


def _inputs(seed=0, clips=2):
    batch = _synthetic_layout_batch(clips, 8, 4, 4, seed=seed)
    batch = {k: v for k, v in batch.items() if k != "labels"}
    batch["video_frames"] = np.random.default_rng(seed).standard_normal(
        (clips, 8, 32, 32, 3)).astype(np.float32)
    return batch


# --- the rules against JAX's -------------------------------------------------------


def _port_dim(spec: P, leaf: str):
    """The torch dimension a JAX spec shards (torch weights are the
    transposed kernels)."""
    if spec == P():
        return None
    if leaf == "kernel":
        return 0 if spec == P(None, "model") else 1
    return 0


@pytest.mark.parametrize("name", sorted(models_factory))
def test_param_spec_follows_jax_rules(name):
    model = jax_models[name](jax_make_model_config(name, **MODEL_KW))
    inputs = _inputs()
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), inputs))["params"]
    specs = jax.tree_util.tree_leaves(params_partition_specs(shapes), is_leaf=lambda x: isinstance(x, P))
    paths = [p for p, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    # Each leaf filled with its own index + 1: a port tensor's values say
    # which flax leaves it came from (in_proj_* from three).
    ids = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes),
        [np.full(s.shape, i + 1, np.float32) for i, s in enumerate(jax.tree_util.tree_leaves(shapes))])
    state = jax_params_to_state_dict(ids)
    seen, sharded = set(), set()
    for key, value in state.items():
        if not value.is_floating_point():  # position_ids, num_batches_tracked
            continue
        for i in {int(v) for v in np.unique(value.numpy()) if v > 0}:
            want = _port_dim(specs[i - 1], paths[i - 1][-1].key)
            assert sharding.param_spec(key) == want, (key, paths[i - 1], specs[i - 1])
            seen.add(i)
            if want is not None:
                sharded.add(key)
    assert seen == set(range(1, len(paths) + 1))  # every flax leaf checked
    port = models_factory[name](make_model_config(name, **MODEL_KW))
    assert sharded <= {k for k, _ in port.named_parameters()}
    if name != "resnet3d":  # every transformer shards its attention and FFN
        assert any(k.endswith("in_proj_weight") for k in sharded)
        assert any(k.endswith("linear2.weight") for k in sharded)
    else:
        assert not sharded


@pytest.mark.parametrize("M", [2, 4])
def test_shards_round_trip(M):
    port = models_factory["cacnf"](make_model_config("cacnf", **MODEL_KW))
    full = {k: v.detach() for k, v in port.named_parameters()}

    class Rank:
        model_size = M

        def __init__(self, m):
            self.model_index = m

    local = [sharding.shard_state_dict(full, Rank(m)) for m in range(M)]
    for key, value in full.items():
        dim = sharding.param_spec(key)
        if dim is None:
            assert all(part[key] is value for part in local)
            continue
        if key.endswith(("in_proj_weight", "in_proj_bias")):  # a third of q, of k and of v each
            thirds = [part[key].chunk(3, dim=0) for part in local]
            joined = torch.cat([torch.cat([t[i] for t in thirds]) for i in range(3)])
        else:
            joined = torch.cat([part[key] for part in local], dim=dim)
        assert torch.equal(joined, value), key
        assert local[0][key].shape[dim] == value.shape[dim] // M


def test_shard_model_cuts_widths_and_heads():
    port = models_factory["stlt"](make_model_config("stlt", **MODEL_KW))

    class Rank:
        model_size, model_index = 2, 1

    sharding.shard_model_(port, Rank())
    layer = port.backbone.transformer.layers[0]
    assert layer.self_attn.num_heads == 2
    assert tuple(layer.self_attn.in_proj_weight.shape) == (48, 32)
    assert tuple(layer.self_attn.out_proj.weight.shape) == (32, 16)
    assert tuple(layer.linear1.weight.shape) == (64, 32)
    assert tuple(layer.linear2.weight.shape) == (32, 64)
    assert tuple(port.prediction_head.fc1.weight.shape) == (16, 32)
    assert tuple(port.prediction_head.fc2.weight.shape) == (5, 32)


# --- rows 1, 2 and 5: M simulated ranks' partials against the full ops -----------


def _layer(H, N, seed):
    g = torch.Generator().manual_seed(seed)
    FF = 4 * H

    def u(*shape, scale):
        return (torch.rand(shape, generator=g) * 2 - 1) * scale

    return dict(in_proj=u(3 * H, H, scale=H ** -0.5), bqkv=u(3 * H, scale=0.1), wo=u(H, H, scale=H ** -0.5),
                bo=u(H, scale=0.1), w1=u(FF, H, scale=H ** -0.5), b1=u(FF, scale=0.1),
                w2=u(H, FF, scale=FF ** -0.5), b2=u(H, scale=0.1), n1s=1 + u(H, scale=0.1),
                n1b=u(H, scale=0.1), n2s=1 + u(H, scale=0.1), n2b=u(H, scale=0.1))


def _cut(w, M, m):
    def c(name, t):
        return sharding.shard_tensor(name, t, M, m)

    return dict(in_proj=c("a.in_proj_weight", w["in_proj"]), bqkv=c("a.in_proj_bias", w["bqkv"]),
                wo=c("a.out_proj.weight", w["wo"]), w1=c("l.linear1.weight", w["w1"]),
                b1=c("l.linear1.bias", w["b1"]), w2=c("l.linear2.weight", w["w2"]))


@pytest.mark.parametrize("M", [2, 4])
def test_proj_attention_partials_sum_to_the_full_op(M):
    H, N, B, T = 64, 4, 5, 7
    w = _layer(H, N, 1)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((B, T, H)).astype(np.float32))
    rows_live = torch.tensor([True, False, True, True, False])
    pad = torch.from_numpy(np.arange(T)[None, :] >= rng.integers(1, T + 1, B)[:, None])
    bias = torch.where(pad, -1e9, 0.0)[:, None, None, :]
    full = fe.fused_proj_attention(x, w["in_proj"].t(), w["bqkv"], w["wo"].t(), w["bo"], bias, num_heads=N,
                                   compute_dtype=torch.float32, rows_live=rows_live)
    s = torch.zeros(B, T, H)
    for m in range(M):
        c = _cut(w, M, m)
        s += fe.fused_proj_attention_partial(x, c["in_proj"].t(), c["bqkv"], c["wo"].t(), bias,
                                             num_heads=N // M, compute_dtype=torch.float32,
                                             rows_live=rows_live)
    got = fe.sublayer_sum(s, w["bo"], compute_dtype=torch.float32, rows_live=rows_live)
    torch.testing.assert_close(got, full, **F32)
    assert got[~rows_live].abs().max() == 0  # dead rows exact zeros, not bo


@pytest.mark.parametrize("M", [2, 4])
def test_cross_attention_partials_sum_to_the_full_op(M):
    H, N, B, T, S = 64, 4, 3, 5, 9
    w = _layer(H, N, 3)
    rng = np.random.default_rng(4)
    x, ctx = (torch.from_numpy(rng.standard_normal((B, L, H)).astype(np.float32)) for L in (T, S))
    ip, b = w["in_proj"], w["bqkv"]
    full = fe.fused_cross_attention(x, ctx, ip[:H].t(), b[:H], ip[H:].t(), b[H:], w["wo"].t(), w["bo"],
                                    None, num_heads=N, compute_dtype=torch.float32)
    s = torch.zeros(B, T, H)
    Hq = H // M
    for m in range(M):
        c = _cut(w, M, m)
        ip_m, b_m = c["in_proj"], c["bqkv"]
        s += fe.fused_cross_attention_partial(x, ctx, ip_m[:Hq].t(), b_m[:Hq], ip_m[Hq:].t(), b_m[Hq:],
                                              c["wo"].t(), None, num_heads=N // M,
                                              compute_dtype=torch.float32)
    got = fe.sublayer_sum(s, w["bo"], compute_dtype=torch.float32, op="fused_cross_attention")
    torch.testing.assert_close(got, full, **F32)


@pytest.mark.parametrize("activation", ["gelu", "relu"])
@pytest.mark.parametrize("M", [2, 4])
def test_layer_tail_partials_sum_to_the_full_op(M, activation):
    H, B, T = 64, 4, 6
    w = _layer(H, 4, 5)
    rng = np.random.default_rng(6)
    x, a = (torch.from_numpy(rng.standard_normal((B, T, H)).astype(np.float32)) for _ in range(2))
    tokens_live = torch.from_numpy(rng.random((B, T)) > 0.3)
    kw = dict(eps=1e-12, compute_dtype=torch.float32, activation=activation)
    full = fe.fused_layer_tail(x, a, w["n1s"], w["n1b"], w["w1"].t(), w["b1"], w["w2"].t(), w["b2"],
                               w["n2s"], w["n2b"], tokens_live=tokens_live, **kw)
    s, u = torch.zeros(B, T, H), None
    for m in range(M):
        c = _cut(w, M, m)
        part, u_m = fe.fused_layer_tail_partial(x, a, w["n1s"], w["n1b"], c["w1"].t(), c["b1"], c["w2"].t(),
                                                **kw)
        assert u is None or torch.equal(u_m, u)  # u: one process's bits on every rank
        s, u = s + part, u_m
    got = fe.fused_layer_tail_sum(s, u, w["b2"], w["n2s"], w["n2b"], eps=1e-12,
                                  compute_dtype=torch.float32, tokens_live=tokens_live)
    torch.testing.assert_close(got, full, **F32)
    assert got[~tokens_live].abs().max() == 0


def test_gathered_fc1_head_is_one_process_bit_for_bit():
    """The head's fc1 columns of each shard, joined in rank order, are one
    process's fc1 output: whole columns over the whole K."""
    head = ClassificationHead(32, 5, 1e-12, torch.float32, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((6, 32)).astype(np.float32))
    want = apply_dense(x, head.fc1, torch.float32)
    for M in (2, 4):
        parts = []
        for m in range(M):
            shard = torch.nn.Linear(32, 32 // M)
            with torch.no_grad():
                shard.weight.copy_(sharding.shard_tensor("fc1.weight", head.fc1.weight, M, m))
                shard.bias.copy_(sharding.shard_tensor("fc1.bias", head.fc1.bias, M, m))
            parts.append(apply_dense(x, shard, torch.float32))
        assert torch.equal(torch.cat(parts, dim=-1), want)


# --- refusals ----------------------------------------------------------------------


def _args(*extra):
    return build_parser("test").parse_args(
        ["--dataset_name", "something", "--dataset_type", "layout", "--model_name", "stlt",
         "--hidden_size", "96", "--num_attention_heads", "6", *extra])


@pytest.mark.parametrize("extra,what", [
    (["--model_parallel", "4"], "does not divide --num_attention_heads \\(6\\)"),
    (["--model_parallel", "4", "--num_attention_heads", "4", "--hidden_size", "90"], "--hidden_size"),
    (["--model_parallel", "3", "--num_processes", "2"], "--num_processes 2 does not divide"),
    (["--model_parallel", "2", "--num_processes", "3"], "does not divide --num_processes 3"),
])
def test_model_axis_refuses_what_it_does_not_divide(extra, what):
    with pytest.raises(ValueError, match=what):
        port_predict.check_flags(_args(*extra))


def test_model_axis_refuses_an_uneven_feed_forward():
    """FF = 4 H: an M that divides the heads but not H does not divide FF
    either; an M dividing H divides FF."""
    with pytest.raises(ValueError, match="does not divide"):
        sharding.check_model_axis(8, 100, 8)
    sharding.check_model_axis(4, 96, 4)


def test_serving_takes_the_model_axis_and_training_refuses_it():
    """Serving takes the model axis beside a ring; training takes it at 17
    frames and refuses what waits for A9 (model axis, long-clip training):
    the fused train tail's 256 frames and a ring beside it."""
    args = _args("--model_parallel", "2", "--context_parallel", "3")
    port_predict.check_flags(args)
    port_train.check_flags(_args("--model_parallel", "2", "--save_model_path", "x.pt"))
    for extra in (["--layout_num_frames", "256"], ["--context_parallel", "2"]):
        with pytest.raises(NotImplementedError, match="ROADMAP.md item A9 \\(model axis, long-clip training\\)"):
            port_train.check_flags(_args("--model_parallel", "2", "--save_model_path", "x.pt", *extra))


@pytest.mark.parametrize("H", [768, 1024])
@pytest.mark.parametrize("M", [2, 4])
def test_kernel_guards_take_the_shard_widths(H, M):
    N, FF = H // 64, 4 * H
    fe._check_partial_widths("op", H, H // M, N // M)
    w1, w2 = torch.empty((H, FF // M), device="meta"), torch.empty((FF // M, H), device="meta")
    assert fe._check_tail_kernel("op", torch.bfloat16, H, w1, w2) == 1


def test_kernel_guards_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="takes H in 64"):
        fe._check_partial_widths("op", 768, 96, 1)  # Hq = 96: not a multiple of 64
    with pytest.raises(ValueError, match="head dim"):
        fe._check_partial_widths("op", 768, 384, 2)  # head dim 192
