"""The model axis in training (``train --model_parallel M``), op by op in one
process on the CPU: M model ranks simulated by their shards, their
partials summed by hand.

- row 3's train partial (``fused_proj_attention_train_partial``, dropout
  0.1) of M = 2 and 4 ranks, summed and finished by ``sublayer_sum``,
  equals the one-process ``fused_proj_attention_train_plain`` (1e-6), and
  its backward through ``sublayer_sum`` gives dx (summed over the ranks),
  each rank's shard of dWqkv, dbqkv and dWo, and dbo within 1e-5 of one
  process's autograd; dead rows exact zeros both ways;
- the keep bits at the head base (rank m's heads hashed as the global m N
  / M + n) are the one-process mask's head slice bit for bit and JAX's
  ``_keep_block_heads``; hashed at the local head they are not;
- the plain train tail's mid site at the global column (m FF / M + c of
  the FF) is the one-process site's columns and JAX's ``_keep_rows``;
  hashed at the local column it is not;
- ``sublayer_sum``'s backward, ``model_copy``'s (the ranks' parts summed
  over the model group), ``model_sum``'s (the identity) and the gathered
  ``fc1``'s (the rank's columns);
- the clip's norm over shards equals the one-process norm;
- ``gather_state_dict`` of ``shard_state_dict`` is the identity for each
  of the six factory models, and so is AdamW's state cut and gathered by
  its parameters' specs.

The collectives of one simulated rank are stood in for by the other
ranks' values, computed here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlt_tpu.ops.flash import _keep_block_heads
from stlt_tpu.ops.fused_tail_train import _keep_rows as jax_keep_rows
from stlt_tpu_torch.configs import make_model_config
from stlt_tpu_torch.models import layers as port_layers
from stlt_tpu_torch.models import models_factory
from stlt_tpu_torch.models.layers import gather_columns
from stlt_tpu_torch.ops import fused_encoder as fe
from stlt_tpu_torch.ops.dropout import TAG_MID_DROP, dropout_thresh, hash_keep_mask, hashed_dropout
from stlt_tpu_torch.parallel import mesh as port_mesh
from stlt_tpu_torch.parallel import sharding
from stlt_tpu_torch.training import optimizer as port_optimizer

SEED, RATE = 0x2545F491, 0.1
F32_FWD = dict(atol=1e-6, rtol=1e-6)
F32_GRAD = dict(atol=1e-5, rtol=1e-5)
MODEL_KW = dict(num_classes=5, unique_categories=4, hidden_size=32, num_attention_heads=4,
                num_spatial_layers=1, num_temporal_layers=1, num_appearance_layers=1,
                num_fusion_layers=1, appearance_num_frames=1, resnet_depth=10, layout_num_frames=8)


class Rank:
    """A model rank's place without a process group: M ranks, index m."""

    context_size = 1
    model_group = None

    def __init__(self, M, m):
        self.model_size, self.model_index = M, m


def _cut(name, t, M, m):
    return sharding.shard_tensor(name, t, M, m)


# --- row 3's train partial and row 4's backward against one process -------------


def _proj_inputs(H, N, B, T, seed):
    g = torch.Generator().manual_seed(seed)

    def u(*shape, scale):
        return ((torch.rand(shape, generator=g) * 2 - 1) * scale)

    w = dict(in_proj=u(3 * H, H, scale=H ** -0.5), bqkv=u(3 * H, scale=0.1),
             wo=u(H, H, scale=H ** -0.5), bo=u(H, scale=0.1))
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, T, H)).astype(np.float32))
    pad = torch.from_numpy(np.arange(T)[None, :] >= rng.integers(1, T + 1, B)[:, None])
    bias = torch.where(pad, -1e9, 0.0)[:, None, None, :]
    cot = torch.from_numpy(rng.standard_normal((B, T, H)).astype(np.float32))
    return w, x, bias, cot


@pytest.mark.parametrize("M", [2, 4])
def test_train_partials_sum_to_the_one_process_op_and_its_gradients(M):
    H, N, B, T = 64, 4, 5, 7
    w, x, bias, cot = _proj_inputs(H, N, B, T, 21)
    rows_live = torch.tensor([True, False, True, True, True])
    f32 = torch.float32
    kw = dict(compute_dtype=f32, rows_live=rows_live, dropout_rate=RATE)

    # one process: the plain op under autograd
    leaves = {k: v.clone().requires_grad_() for k, v in w.items()}
    xo = x.clone().requires_grad_()
    want = fe.fused_proj_attention_train_plain(xo, leaves["in_proj"].t(), leaves["bqkv"], leaves["wo"].t(),
                                               leaves["bo"], bias, SEED, num_heads=N, row0=3, **kw)
    want.backward(cot)

    # M ranks: each its shards, the partials summed, then the epilogue
    bo = w["bo"].clone().requires_grad_()
    s, ranks = torch.zeros(B, T, H), []
    for m in range(M):
        c = {"in_proj": _cut("a.in_proj_weight", w["in_proj"], M, m).requires_grad_(),
             "bqkv": _cut("a.in_proj_bias", w["bqkv"], M, m).requires_grad_(),
             "wo": _cut("a.out_proj.weight", w["wo"], M, m).requires_grad_()}
        xm = x.clone().requires_grad_()
        part = fe.fused_proj_attention_train_partial(xm, c["in_proj"].t(), c["bqkv"], c["wo"].t(), bias, SEED,
                                                     num_heads=N // M, row0=3, head0=m * N // M, heads=N,
                                                     **kw)
        ranks.append((xm, c, part))
        s = s + part
    summed = s.detach().requires_grad_()
    got = fe.sublayer_sum(summed, bo, compute_dtype=f32, rows_live=rows_live)
    torch.testing.assert_close(got, want, **F32_FWD)
    assert got[~rows_live].abs().max() == 0
    got.backward(cot)
    torch.testing.assert_close(bo.grad, leaves["bo"].grad, **F32_GRAD)
    dx = torch.zeros_like(x)
    for m, (xm, c, part) in enumerate(ranks):
        part.backward(summed.grad)  # the cotangent of the sum, the same on every rank
        dx += xm.grad
        torch.testing.assert_close(c["in_proj"].grad, _cut("a.in_proj_weight", leaves["in_proj"].grad, M, m),
                                   **F32_GRAD)
        torch.testing.assert_close(c["bqkv"].grad, _cut("a.in_proj_bias", leaves["bqkv"].grad, M, m),
                                   **F32_GRAD)
        torch.testing.assert_close(c["wo"].grad, _cut("a.out_proj.weight", leaves["wo"].grad, M, m),
                                   **F32_GRAD)
    torch.testing.assert_close(dx, xo.grad, **F32_GRAD)
    assert dx[~rows_live].abs().max() == 0


@pytest.mark.parametrize("M", [2, 4])
def test_row4_partial_backward_matches_the_one_process_backward(M):
    """The raw backward (``fused_proj_attention_train_bwd_plain`` at the
    head base): each rank's dqkv is its heads' slice of one process's, its
    dWo its rows of one process's, and its dbo the whole one."""
    H, N, B, T = 64, 4, 3, 9
    w, x, bias, g = _proj_inputs(H, N, B, T, 22)
    kw = dict(dropout_rate=RATE, compute_dtype=torch.float32)
    dqkv, dwo, dbo = fe.fused_proj_attention_train_bwd_plain(x, w["in_proj"].t(), w["bqkv"], w["wo"].t(), bias,
                                                             g, SEED, num_heads=N, **kw)
    Hq = H // M
    for m in range(M):
        c_ip, c_b = _cut("a.in_proj_weight", w["in_proj"], M, m), _cut("a.in_proj_bias", w["bqkv"], M, m)
        c_wo = _cut("a.out_proj.weight", w["wo"], M, m)
        dq_m, dwo_m, dbo_m = fe.fused_proj_attention_train_bwd_plain(
            x, c_ip.t(), c_b, c_wo.t(), bias, g, SEED, num_heads=N // M, head0=m * N // M, heads=N, **kw)
        cols = torch.cat([torch.arange(i * H + m * Hq, i * H + (m + 1) * Hq) for i in range(3)])
        torch.testing.assert_close(dq_m, dqkv[..., cols], **F32_FWD)
        torch.testing.assert_close(dwo_m, dwo[m * Hq:(m + 1) * Hq], **F32_FWD)
        torch.testing.assert_close(dbo_m, dbo, atol=0, rtol=0)


# --- the keep bits at the head base and at the global column --------------------


@pytest.mark.parametrize("M", [2, 4])
def test_head_base_keep_bits_are_the_global_heads(M):
    B, N, T, S = 3, 8, 5, 6
    full = hash_keep_mask(SEED, B, N, T, S, RATE, b0=7)
    thresh = dropout_thresh(RATE)
    n = N // M
    for m in range(M):
        got = hash_keep_mask(SEED, B, n, T, S, RATE, b0=7, n0=m * n, heads=N)
        assert torch.equal(got, full[:, m * n:(m + 1) * n])
        jax_bits = jax.jit(lambda seed, m=m: jnp.stack([
            _keep_block_heads(seed, 7 + b, m * n, 0, 0, (n, T, S), N, S, thresh) for b in range(B)]))(
            jnp.uint32(SEED))
        assert np.array_equal(got.numpy(), np.asarray(jax_bits) > 0)
        if m:  # hashed at the local head the bits are another rank's
            local = hash_keep_mask(SEED, B, n, T, S, RATE, b0=7, heads=N)
            assert not torch.equal(local, got)
    with pytest.raises(ValueError, match="do not lie"):
        hash_keep_mask(SEED, B, n, T, S, RATE, n0=N, heads=N)


@pytest.mark.parametrize("M", [2, 4])
def test_mid_site_hashes_the_global_columns(M):
    tokens, FF = 12, 64
    h = torch.from_numpy(np.random.default_rng(23).standard_normal((3, 4, FF)).astype(np.float32))
    full = hashed_dropout(h, SEED, TAG_MID_DROP, RATE, token0=40)
    w = FF // M
    thresh = dropout_thresh(RATE)
    lane_seed = jnp.uint32(SEED)
    for m in range(M):
        got = hashed_dropout(h[..., m * w:(m + 1) * w], SEED, TAG_MID_DROP, RATE, token0=40, f0=m * w, width=FF)
        assert torch.equal(got, full[..., m * w:(m + 1) * w])
        keep = jax.jit(lambda s, m=m: jax_keep_rows(s, TAG_MID_DROP, 40, m * w, (tokens, w), FF, thresh))(
            lane_seed)
        assert np.array_equal((got != 0).numpy().reshape(tokens, w), np.asarray(keep) > 0)
        if m:
            local = hashed_dropout(h[..., m * w:(m + 1) * w], SEED, TAG_MID_DROP, RATE, token0=40)
            assert not torch.equal(local, got)


# --- the operators' backwards ------------------------------------------------------


def test_sublayer_sum_backward_passes_through_the_rounding():
    B, T, H = 3, 4, 64
    rng = np.random.default_rng(24)
    rows_live = torch.tensor([True, False, True])
    for cd in (torch.float32, torch.bfloat16):
        s = torch.from_numpy(rng.standard_normal((B, T, H)).astype(np.float32)).requires_grad_()
        bo = torch.from_numpy(rng.standard_normal(H).astype(np.float32)).requires_grad_()
        g = torch.from_numpy(rng.standard_normal((B, T, H)).astype(np.float32)).to(cd)
        y = fe.sublayer_sum(s, bo, compute_dtype=cd, rows_live=rows_live)
        assert y.dtype == cd
        ds, dbo = torch.autograd.grad(y, (s, bo), g)
        want = torch.where(rows_live[:, None, None], g.to(torch.float32), 0.0)
        assert torch.equal(ds, want)
        torch.testing.assert_close(dbo, want.sum(dim=(0, 1)), atol=0, rtol=0)


def test_model_copy_sums_the_parts_and_model_sum_passes_the_cotangent(monkeypatch):
    """Rank 0 of two: its collectives stood in for by adding rank 1's
    values, so each operator's direction shows."""
    other = torch.full((2, 3), 5.0)
    calls = []

    def fake_sum(x, mesh, group=None):
        calls.append(group)
        return x + other

    monkeypatch.setattr(port_mesh, "all_sum", fake_sum)
    mesh = Rank(2, 0)
    mesh.model_group = "model"
    x = torch.ones(2, 3, requires_grad=True)
    y = port_mesh.model_copy(x, mesh)
    assert torch.equal(y, x) and not calls  # forward: no collective
    (y * 2).sum().backward()
    assert torch.equal(x.grad, 2 + other) and calls == ["model"]
    p = torch.ones(2, 3, requires_grad=True)
    z = port_mesh.model_sum(p, mesh)
    assert torch.equal(z, p + other)
    (z * 3).sum().backward()
    assert torch.equal(p.grad, torch.full((2, 3), 3.0))


def test_gathered_columns_backward_is_the_ranks_columns(monkeypatch):
    parts = [torch.arange(6.0).reshape(2, 3) + 10 * r for r in range(2)]
    monkeypatch.setattr(port_layers, "all_gather", lambda x, mesh, group=None: torch.stack(parts))
    for m in range(2):
        mesh = Rank(2, m)
        h = parts[m].clone().requires_grad_()
        out = gather_columns(h, mesh)
        assert torch.equal(out, torch.cat(parts, dim=-1))
        g = torch.arange(12.0).reshape(2, 6)
        out.backward(g)
        assert torch.equal(h.grad, g[:, 3 * m:3 * (m + 1)])


# --- the clip's norm over shards --------------------------------------------------------


@pytest.mark.parametrize("M", [2, 4])
def test_sharded_clip_norm_is_the_one_process_norm(M, monkeypatch):
    model = models_factory["stlt"](make_model_config("stlt", **MODEL_KW), torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    grads = {n: torch.randn(p.shape, generator=g) * 3 for n, p in model.named_parameters()}
    params = [torch.nn.Parameter(v.clone()) for v in grads.values()]
    for p, v in zip(params, grads.values()):
        p.grad = v.clone()
    want = port_optimizer.clip_by_global_norm_(params, 1.0)
    shard_sq = [sum(float(sharding.shard_tensor(n, v, M, m).double().square().sum())
                    for n, v in grads.items() if sharding.param_spec(n) is not None) for m in range(M)]
    for m in range(M):
        mesh = Rank(M, m)
        monkeypatch.setattr(port_optimizer, "active_model_mesh", lambda mesh=mesh: mesh)
        monkeypatch.setattr(port_optimizer, "all_sum",
                            lambda x, mesh, group=None: torch.tensor(sum(shard_sq), dtype=x.dtype))
        local = []
        for n, v in grads.items():
            p = torch.nn.Parameter(sharding.shard_tensor(n, v, M, m).clone())
            p.grad = p.detach().clone()
            if sharding.param_spec(n) is not None:
                p.model_shard_dim = sharding.param_spec(n)
            local.append(p)
        norm = port_optimizer.clip_by_global_norm_(local, 1.0)
        torch.testing.assert_close(norm, want, atol=0, rtol=1e-6)
        for p, (n, v) in zip(local, grads.items()):  # clipped by the one-process factor
            torch.testing.assert_close(p.grad, sharding.shard_tensor(n, v, M, m) / want, atol=0, rtol=1e-6)


# --- the gather of states -------------------------------------------------------------


def _fake_gather(named, M):
    """An ``all_gather`` over the model group of M ranks that knows every
    rank's shard of each (parameter name, full tensor) of ``named``
    (identified by its bytes)."""
    shards = {}
    for name, value in named:
        if sharding.param_spec(name) is None:
            continue
        parts = [sharding.shard_tensor(name, value, M, m) for m in range(M)]
        for part in parts:
            shards[part.numpy().tobytes()] = torch.stack(parts)
    return lambda x, mesh, group=None: shards[x.numpy().tobytes()]


@pytest.mark.parametrize("name", ["stlt", "lcf", "caf", "cacnf", "resnet3d", "resnet3d-transformer"])
def test_gather_of_shards_is_the_identity_with_adamw_state(name, monkeypatch):
    M = 2
    model = models_factory[name](make_model_config(name, **MODEL_KW), torch.Generator().manual_seed(5))
    full = {k: v.detach().clone() for k, v in model.state_dict().items()}
    optimizer = torch.optim.AdamW(model.parameters(), lr=1e-3)
    g = torch.Generator().manual_seed(6)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=g)
    optimizer.step()
    names = sharding.optimizer_param_names(optimizer, model)
    opt_full = optimizer.state_dict()
    moments = [(names[i], v) for i, entry in opt_full["state"].items() for v in entry.values() if v.dim() > 0]
    monkeypatch.setattr(sharding, "all_gather", _fake_gather(list(full.items()) + moments, M))
    sharded_any = False
    for m in range(M):
        mesh = Rank(M, m)
        local = sharding.shard_state_dict(full, mesh)
        sharded_any |= any(local[k].shape != full[k].shape for k in full)
        back = sharding.gather_state_dict(local, mesh)
        assert set(back) == set(full)
        for k in full:
            assert torch.equal(back[k], full[k]), k
        opt_back = sharding.gather_optimizer_state(sharding.shard_optimizer_state(opt_full, names, mesh), names,
                                                   mesh)
        assert opt_back["param_groups"] == opt_full["param_groups"]
        for i, entry in opt_full["state"].items():
            for k, v in entry.items():
                assert torch.equal(opt_back["state"][i][k], v), (names[i], k)
    assert sharded_any == (name not in ("resnet3d",))


# --- the launchers hand the entry points what they declare ------------------------------


def _record(monkeypatch):
    """``_kernels.launch`` recorded, not run (no GPU here), and the CUDA
    stream calls stood in for."""
    import contextlib
    import types

    from stlt_tpu_torch.ops import _kernels
    from stlt_tpu_torch.ops import flash

    seen = []
    monkeypatch.setattr(_kernels, "launch", lambda name, *args: seen.append((name, args)))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(flash, "_stream", lambda device: 0)
    monkeypatch.setattr(flash, "_on_cpu", lambda x, op: False)  # the wrappers' launch route on CPU tensors
    return seen, _kernels


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_partial_launchers_pass_the_head_base(monkeypatch, dtype):
    """Rows 3 and 4's partial modes and rows 6 and 7 at a head base, and
    row 4 in one process (its one entry point at width H, head base 0 of
    its N): as many arguments as ``_kernels.SIGNATURES`` declares, each one
    ctypes converts, the head base and the whole N where the entry points
    take them, and the launches counted under the row's name."""
    from stlt_tpu_torch.ops import flash

    seen, kernels = _record(monkeypatch)
    fe.reset_launches()
    flash.reset_launches()
    H, Hq, N, B, T = 128, 64, 2, 3, 17  # rank 1 of M = 2 of a 4-head model
    x = torch.zeros(B, T, H, dtype=dtype)
    wqkv, bqkv, wo = torch.zeros(H, 3 * Hq), torch.zeros(3 * Hq), torch.zeros(Hq, H)
    kw = dict(num_heads=N, compute_dtype=dtype, rows_live=torch.tensor([True, False, True]))
    fe._launch_proj_partial(x, wqkv, bqkv, wo, None, train=True, seed=5, dropout_rate=RATE, head0=2, heads=4,
                            **kw)
    fe._launch_proj_bwd(x, wqkv, bqkv, wo, None, x, 5, dropout_rate=RATE, head0=2, heads=4, **kw)
    q = torch.zeros(B, 70, N, 64, dtype=dtype)
    flash.fused_attention(q, q, q, dropout_seed=5, dropout_rate=RATE, with_lse=True, dropout_head0=2,
                          dropout_heads=4)
    lse = torch.zeros(B, N, 70)
    flash.fused_attention_bwd(q, q, q, q, lse, lse, dropout_seed=5, dropout_rate=RATE, dropout_head0=2,
                              dropout_heads=4)
    fe._launch_proj_bwd(x, torch.zeros(H, 3 * H), torch.zeros(3 * H), torch.zeros(H, H), None, x, 5,
                        dropout_rate=RATE, **dict(kw, num_heads=4))
    names = [name for name, _ in seen]
    assert names == ["fused_proj_attention_partial", "fused_proj_attention_bwd", "flash_attention",
                     "flash_attention_bwd", "fused_proj_attention_bwd"]
    for name, args in seen:
        _, argtypes = kernels.SIGNATURES[name]
        assert len(args) == len(argtypes), name
        for arg, argtype in zip(args, argtypes):
            argtype.from_param(arg)
    fwd, bwd, attn, attn_bwd, one = (args for _, args in seen)
    assert fwd[-4:-2] == (2, 4) and bwd[-6:-4] == (2, 4)  # head0, heads before (splits, chunk,) dtype, stream
    assert fwd[13] == Hq and bwd[18] == Hq  # inner
    assert one[18] == H and one[19] == 4 and one[-6:-4] == (0, 4)  # one process: width H, heads 0 of N
    assert attn[29:31] == (2, 4) and attn_bwd[36:38] == (2, 4)  # after row_base
    assert fe.LAUNCHES["fused_proj_attention_train"] == 1 and fe.LAUNCHES["fused_proj_attention_train_bwd"] == 2
    assert flash.LAUNCHES["flash_attention"] == 1 and flash.LAUNCHES["flash_attention_bwd"] == 1
    with pytest.raises(ValueError, match="do not lie"):
        flash.fused_attention(q, q, q, dropout_seed=5, dropout_rate=RATE, dropout_head0=3, dropout_heads=4)
    with pytest.raises(NotImplementedError, match="A9 \\(model axis, long-clip training\\)"):
        long = torch.zeros(1, 513, N, 64, dtype=dtype)
        flash.flash_attention(long, long, long, dropout_seed=5, dropout_rate=RATE, dropout_head0=2,
                              dropout_heads=4)
