"""The port's fused train tail (plain versions on the CPU) against the JAX
package's ``fused_layer_tail_train`` (its Pallas kernels in interpret mode).

The same numpy-seeded inputs and uint32 seed go through both; the forward
and all ten gradients (x, attn_out and the eight parameters, under
``jax.vjp``) are compared. Tolerances:

- f32: y at atol = rtol = 1e-5 (one flipped keep bit moves an output by a
  tenth or more), gradients at atol = rtol = 1e-4 (both compute the same f32
  function with the same rounding points and keep bits; only the order of
  f32 sums differs, and a parameter gradient sums over every token);
- bf16: y at atol 6e-2, rtol 2e-2, each gradient within a relative
  Frobenius norm of 2e-2. The rounding points are the same, but an f32 sum
  taken in another order can round to the neighbouring bf16 value (2**-8
  relative) in u, the hidden or h2, and LayerNorm moves its outputs a few
  bf16 steps with it; the gradients are sums of such roundings.

Dead tokens (``rows_live`` / ``tokens_live``) get a large cotangent: the
port's y, dx and dattn there are exact zeros, as JAX's.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlt_tpu.ops import fused_tail_train as jftt
from stlt_tpu_torch.models.layers import TransformerEncoderLayer
from stlt_tpu_torch.ops import _kernels
from stlt_tpu_torch.ops import flash
from stlt_tpu_torch.ops import fused_encoder as fe
from stlt_tpu_torch.ops import fused_tail_train as ftt
from stlt_tpu_torch.utils import bwd_tolerance
from tests.jax_reference import jit_vjp

SEED = 0x1234ABCD
EPS = 1e-12
Y_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5), torch.bfloat16: dict(atol=6e-2, rtol=2e-2)}
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_GRAD_REL = 2e-2
NAMES = ("dx", "dattn", "dn1s", "dn1b", "dw1", "db1", "dw2", "db2", "dn2s", "dn2b")
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(B, T, H, FF, live_kind, seed=0):
    """x, attn [B, T, H], the eight parameters, a cotangent (1e3 on dead
    tokens) and the live flags, all numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, T, H)).astype(np.float32)
    attn = rng.normal(0, 0.5, (B, T, H)).astype(np.float32)
    params = [
        1 + 0.1 * rng.normal(size=H), 0.1 * rng.normal(size=H),
        rng.normal(size=(H, FF)) / np.sqrt(H), 0.1 * rng.normal(size=FF),
        rng.normal(size=(FF, H)) / np.sqrt(FF), 0.1 * rng.normal(size=H),
        1 + 0.1 * rng.normal(size=H), 0.1 * rng.normal(size=H),
    ]
    params = [p.astype(np.float32) for p in params]
    g = rng.normal(0, 1, (B, T, H)).astype(np.float32)
    live = {}
    token_live = np.ones((B, T), bool)
    if live_kind == "rows":
        rows = np.array([True, False, True][:B] + [True] * max(0, B - 3))
        live["rows_live"] = rows
        token_live = np.repeat(rows[:, None], T, axis=1)
    elif live_kind == "tokens":
        lengths = rng.integers(1, T + 1, B)
        lengths[0] = T
        token_live = np.arange(T)[None, :] < lengths[:, None]
        live["tokens_live"] = token_live
    g[~token_live] = 1e3
    return x, attn, params, g, live, token_live


def _jax(x, attn, params, g, live, dtype, activation, approximate, rate, fwd_blocks=None):
    kw = dict(eps=EPS, compute_dtype=JAX_DTYPES[dtype], activation=activation,
              gelu_approximate=approximate, dropout_rate=rate,
              seed=jnp.uint32(SEED) if rate else None, fwd_blocks=fwd_blocks,
              **{k: jnp.asarray(v) for k, v in live.items()})

    def op(*args):
        return jftt.fused_layer_tail_train(*args, **kw)

    y, grads = jit_vjp(op, [jnp.asarray(a) for a in (x, attn, *params)], jnp.asarray(g))
    return np.asarray(y.astype(jnp.float32)), [np.asarray(d.astype(jnp.float32)) for d in grads]


def _port(x, attn, params, g, live, dtype, activation, approximate, rate):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, attn, *params)]
    y = ftt.fused_layer_tail_train(
        *leaves, eps=EPS, compute_dtype=dtype, activation=activation,
        gelu_approximate=approximate, dropout_rate=rate, seed=SEED if rate else None,
        **{k: torch.from_numpy(v) for k, v in live.items()})
    assert y.dtype == dtype
    y.backward(torch.from_numpy(g).to(dtype))
    return y.detach().float().numpy(), [leaf.grad.float().numpy() for leaf in leaves]


def _rel(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("dtype,rate,activation,live_kind,FF,fwd_blocks", [
    (torch.float32, 0.25, "gelu", "tokens", 384, None),
    (torch.float32, 0.25, "relu", "rows", 256, None),
    (torch.float32, 0.0, "gelu", None, 256, None),
    (torch.float32, 0.25, "gelu", None, 384, (1, 128)),
    (torch.bfloat16, 0.25, "gelu", "tokens", 384, None),
    (torch.bfloat16, 0.0, "relu", "rows", 256, None),
])
def test_op_matches_jax(dtype, rate, activation, live_kind, FF, fwd_blocks):
    """y and the ten gradients. GELU is exact erf in f32 and the tanh
    approximation in bf16, as the models take it; FF spans two or three of
    the CUDA kernels' 128-column chunks (one case also makes JAX's forward
    take 128-column chunks and blocks of one 8-token row)."""
    B, T, H = 3, 12, 64
    x, attn, params, g, live, token_live = _inputs(B, T, H, FF, live_kind, seed=FF + int(rate * 4))
    approximate = dtype == torch.bfloat16
    y_j, grads_j = _jax(x, attn, params, g, live, dtype, activation, approximate, rate, fwd_blocks)
    y_t, grads_t = _port(x, attn, params, g, live, dtype, activation, approximate, rate)

    dead = ~token_live
    assert not y_t[dead].any() and not grads_t[0][dead].any() and not grads_t[1][dead].any()
    np.testing.assert_allclose(y_t, y_j, **Y_TOL[dtype])
    for name, got, want in zip(NAMES, grads_t, grads_j):
        assert got.shape == want.shape and np.isfinite(got).all(), name
        if dtype == torch.float32:
            np.testing.assert_allclose(got, want, err_msg=name, **GRAD_TOL)
        else:
            assert _rel(got, want) <= BF16_GRAD_REL, (name, _rel(got, want))


def test_dropout_reaches_every_site():
    """With a seed the dropped output differs from the undropped one, another
    seed gives other bits, and the same seed the same output."""
    x, attn, params, _, _, _ = _inputs(2, 8, 64, 256, None)
    args = [torch.from_numpy(a) for a in (x, attn, *params)]
    run = lambda seed, rate: ftt.fused_layer_tail_train(
        *args, eps=EPS, compute_dtype=torch.float32, dropout_rate=rate, seed=seed)
    base, a, b = run(SEED, 0.0), run(SEED, 0.25), run(SEED + 1, 0.25)
    assert not torch.allclose(a, base) and not torch.allclose(a, b)
    torch.testing.assert_close(run(SEED, 0.25), a, atol=0, rtol=0)


@pytest.mark.parametrize("clip_frames,fused", [(255, False), (256, True), (0, False), (513, True)])
def test_layer_dispatches_on_the_clip_length(monkeypatch, clip_frames, fused):
    """A train-mode layer runs the fused op from TAIL_TRAIN_MIN_FRAMES = 256
    frames on (JAX's gate), the plain chain below it; eval never."""
    assert ftt.TAIL_TRAIN_MIN_FRAMES == 256
    calls = []
    real = ftt.fused_layer_tail_train
    monkeypatch.setattr(ftt, "fused_layer_tail_train",
                        lambda *a, **k: calls.append(k["seed"]) or real(*a, **k))
    layer = TransformerEncoderLayer(64, 4, 256, activation="gelu", layer_norm_eps=EPS,
                                    dtype=torch.float32, generator=torch.Generator().manual_seed(0),
                                    dropout_rate=0.1).train()
    x = torch.randn(2, 8, 64, generator=torch.Generator().manual_seed(1))
    y = layer(x, seeds=(7, 9), clip_frames=clip_frames)
    assert calls == ([9] if fused else [])
    assert y.shape == x.shape and torch.isfinite(y).all()
    layer.eval()
    layer(x, clip_frames=clip_frames)
    assert len(calls) == (1 if fused else 0)


@pytest.mark.parametrize("tokens", [8224, 65792])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_jax_fit_predicate_holds_at_every_kernel_width(tokens, itemsize):
    """JAX's VMEM-fit predicate, which the port drops, is true at every
    width the port's kernels take (FF = 4H) at the long-clip train shapes
    (the temporal and the spatial stage's tokens), so both packages' gates
    agree."""
    for w in fe._KERNEL_WIDTHS:
        H = 64 * w
        assert jftt.tail_train_fits(tokens // 8, 8, H, 4 * H, itemsize), H
        for frames in (17, 255, 256, 257, 513):
            assert jftt.tail_train_wants(tokens // 8, 8, H, 4 * H, itemsize, frames) == \
                ftt.tail_train_wants(frames)


def _record_launches(monkeypatch, dtype):
    """Run every launcher on CPU tensors of ``dtype`` with the launch
    recorded, not run (no GPU here): the recorded (name, args) and the input
    launcher's scratch."""
    seen = []
    monkeypatch.setattr(_kernels, "launch", lambda name, *args: seen.append((name, args)))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(ftt, "_stream", lambda x: 0)
    ftt.reset_launches()
    tokens, H, FF = 40, 64, 256
    x, attn, params, g, _, _ = _inputs(5, 8, H, FF, None)
    x, attn, g = (torch.from_numpy(a).reshape(tokens, H).to(dtype) for a in (x, attn, g))
    weights = [torch.from_numpy(p) for p in params]
    live = torch.arange(tokens) < 30
    cfg = ftt.TailConfig(EPS, "gelu", False, 0.1, SEED)
    ftt._launch_tail_train(x, attn, weights, cfg, live)
    ftt._launch_bwd_row(x, g, weights[6], cfg, live)
    *_, scratch = ftt._launch_bwd_input(x, attn, x, weights, cfg, live)
    ftt._launch_bwd_weight(scratch)
    assert [name for name, _ in seen] == ["fused_layer_tail", "fused_tail_train_bwd_row",
                                           "fused_tail_train_bwd_input",
                                           "fused_tail_train_bwd_weight"]
    for name, args in seen:
        _, argtypes = _kernels.SIGNATURES[name]
        assert len(args) == len(argtypes), name
        for arg, argtype in zip(args, argtypes):
            argtype.from_param(arg)
        assert _kernels.source(name) + ".cu" in {p.name for p in _kernels.CSRC.glob("*.cu")}
    assert ftt.LAUNCHES == dict.fromkeys(ftt.LAUNCHES, 1)
    return seen, scratch, tokens, H, FF


def test_launchers_pass_what_the_entry_points_declare(monkeypatch):
    """Each launcher hands its C entry point as many arguments as
    ``_kernels.SIGNATURES`` declares, each one ctypes converts, and counts one
    launch. f32: the scratch rows are the tokens' own, padded with zeros to
    a whole 32-token step, one db1 partial a 16-token block, no packed rows
    or du scratch."""
    seen, scratch, tokens, H, FF = _record_launches(monkeypatch, torch.float32)
    assert scratch["u"].shape == (64, H) and not scratch["dh1"][tokens:].any()
    assert scratch["count"] is None and scratch["partial_b1"].shape == (3, FF)
    inp = dict(seen)["fused_tail_train_bwd_input"]
    assert inp[15] is None and inp[16] is None and inp[-3] == 3  # du, rows; blocks


def test_bf16_launchers_pass_the_packed_scratch(monkeypatch):
    """In bf16 the input launcher hands over the packed-row scratch: u, dh2,
    dh1, h1d with one row a token (no padding: the GEMMs' TMA maps fill past
    the last row), an f32 du, the packed rows and their count, one db1
    partial a 128-token tile; the weight launcher passes that count."""
    seen, scratch, tokens, H, FF = _record_launches(monkeypatch, torch.bfloat16)
    assert scratch["u"].shape == (tokens, H) and scratch["dh1"].shape == (tokens, FF)
    assert scratch["partial_b1"].shape == (1, FF) and scratch["count"].shape == (1,)
    calls = dict(seen)
    inp, wgt = calls["fused_tail_train_bwd_input"], calls["fused_tail_train_bwd_weight"]
    assert inp[15] is not None and inp[16] == scratch["count"].data_ptr() - 4 * tokens
    assert inp[-3] == 1 and wgt[4] == scratch["count"].data_ptr()  # LN1 blocks; the live count


@pytest.mark.parametrize("tokens", [40, 4096, 4100, 8224, 65792])
def test_launchers_split_the_tokens_without_gap(monkeypatch, tokens):
    """The row kernel's blocks and the weight kernel's token splits cover
    every token once, with no empty block or split, in chunks of whole k
    steps (32 tokens in f32, 64 in bf16), chosen from the token count alone:
    at the main path's 65,792 tokens 264 row blocks of 250 and 8 splits of
    8,256 (bf16). The launch is recorded, not run."""
    seen = {}
    monkeypatch.setattr(_kernels, "launch", lambda name, *args: seen.setdefault(name, args))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(ftt, "_stream", lambda x: 0)
    H, FF = 64, 128
    r2 = torch.zeros(tokens, H)
    ftt._launch_bwd_row(r2, r2, torch.ones(H), ftt.TailConfig(EPS))
    blocks, chunk = seen["fused_tail_train_bwd_row"][-4:-2]
    assert blocks <= ftt._ROW_BLOCKS and (blocks - 1) * chunk < tokens <= blocks * chunk
    for dtype, step in ((torch.float32, 32), (torch.bfloat16, 64)):
        rows = -(-tokens // 32) * 32 if dtype == torch.float32 else tokens
        scratch = {name: torch.zeros(rows, width, dtype=dtype)
                   for name, width in (("u", H), ("dh2", H), ("dh1", FF), ("h1d", FF))}
        scratch.update(partial_b1=torch.zeros(1, FF), count=None)
        seen.pop("fused_tail_train_bwd_weight", None)
        ftt._launch_bwd_weight(scratch)
        got_rows, chunk, splits = seen["fused_tail_train_bwd_weight"][-7:-4]
        assert got_rows == rows and chunk % step == 0 and splits <= ftt._WEIGHT_MAX_SPLITS
        assert (splits - 1) * chunk < rows <= splits * chunk
        if tokens == 65792 and dtype == torch.bfloat16:
            assert (blocks, chunk, splits) == (264, 8256, 8)


@pytest.mark.parametrize("variant", sorted(bwd_tolerance.MUTATIONS))
def test_tolerance_faults_still_apply(variant):
    """Each fault that ``utils/bwd_tolerance.py`` plants to set the bf16
    limits edits text that the kernel sources still hold exactly once."""
    for source, old, new in bwd_tolerance.MUTATIONS[variant][1]:
        assert (_kernels.CSRC / source).read_text().count(old) == 1, (variant, source)
        assert new != old


def test_every_counted_kernel_names_its_source():
    """Every launch-count name (the kernels ``chip_smoke.py`` reports) maps to
    a source in csrc/."""
    sources = {p.stem for p in _kernels.CSRC.glob("*.cu")}
    for name in [*fe.LAUNCHES, *flash.LAUNCHES, *ftt.LAUNCHES]:
        assert _kernels.source(name) in sources, name
