"""Paired device times of the attention forwards (rows 6 and 8) in every mode,
for one tree of the port: each case the median of five windows of five
launches (CUDA events), on inputs drawn from a fixed seed, so that two
trees (a checkout of a parent commit and this one) see the same inputs. To
compare two trees on one card, run them in turns in one call (parent,
change, change, parent)::

    python stlt_tpu_torch/utils/attention_ab.py PATH_TO_TREE LABEL

PATH_TO_TREE is the directory that holds the tree's ``stlt_tpu_torch``; the
script builds that tree's two attention forward sources and prints one line
``AB {json}``: the label, the card's name and each case's milliseconds.
"""
import json
import sys


def median_ms(fn, iters: int = 5, windows: int = 5) -> float:
    """Median over ``windows`` windows of the mean device time of ``iters``
    launches of ``fn`` (CUDA events), after warmup."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[windows // 2]


def main(tree: str, label: str) -> dict:
    sys.path.insert(0, tree)
    import torch
    from stlt_tpu_torch.ops import _kernels, flash, masks

    _kernels.build_all(names=["flash_attention", "blockwise_attention"])
    dev = "cuda"
    g = torch.Generator().manual_seed(0)

    def heads(B, T, dtype=torch.bfloat16, D=64):
        H = 768
        qkv = torch.randn(B, T, 3 * H, generator=g).to(dev, dtype)
        return [qkv[..., i * H:(i + 1) * H].unflatten(-1, (H // D, D)) for i in range(3)]

    def cpb(lengths, T):
        pad = torch.arange(T)[None, :] >= lengths[:, None]
        return (masks.causal_bias(T) + masks.key_padding_bias(pad)).to(dev)

    def keep(B, T, S):
        return (torch.rand(B, 12, T, S, generator=g) >= 0.1).to(dev)

    fused, blockwise = flash.fused_attention, flash.blockwise_attention
    drop = dict(dropout_rate=0.1, dropout_seed=5)
    cases = {}
    q, k, v = heads(64, 257)
    bias = cpb(torch.full((64,), 257), 257)
    cases["row6 T257 B64"] = lambda: fused(q, k, v, bias)
    q2, k2, v2 = heads(32, 257)
    bias2 = cpb(torch.full((32,), 257), 257)
    m2 = keep(32, 257, 257)
    cases["row6 T257 B32 dropout lse"] = lambda: fused(q2, k2, v2, bias2, with_lse=True, **drop)
    cases["row6 T257 B32 mask lse"] = lambda: fused(q2, k2, v2, bias2, with_lse=True, dropout_mask=m2,
                                                    dropout_rate=0.1)
    f32 = [x.float() for x in (q2, k2, v2)]
    cases["row6 T257 B32 f32"] = lambda: fused(*f32, bias2)
    d32 = heads(32, 257, D=32)
    cases["row6 T257 B32 bf16 D32"] = lambda: fused(*d32, bias2)
    q3, k3, v3 = heads(32, 513)
    full3 = torch.full((32,), 513, device=dev)
    ragged3 = torch.randint(33, 258, (32,), generator=g).to(dev)
    cases["row8 lengths T513 B32"] = lambda: blockwise(q3, k3, v3, kv_lengths=full3, causal=True)
    cases["row8 lengths T513 B32 ragged 33-257"] = lambda: blockwise(q3, k3, v3, kv_lengths=ragged3,
                                                                     causal=True)
    q4, k4, v4 = heads(16, 513)
    full4 = torch.full((16,), 513, device=dev)
    m4 = keep(16, 513, 513)
    cases["row8 lengths T513 B16 dropout"] = lambda: blockwise(q4, k4, v4, kv_lengths=full4, causal=True,
                                                               **drop)
    cases["row8 lengths T513 B16 mask"] = lambda: blockwise(q4, k4, v4, kv_lengths=full4, causal=True,
                                                            dropout_mask=m4, dropout_rate=0.1)
    lengths4 = torch.randint(1, 514, (16,), generator=g)
    lengths4[0] = 513
    bias4 = cpb(lengths4, 513)
    cases["row8 dense 513x513 B16"] = lambda: blockwise(q4, k4, v4, bias=bias4)
    cases["row8 dense 513x513 B16 flag"] = lambda: blockwise(q4, k4, v4, bias=bias4, causal=True)
    cases["row8 dense 513x513 B16 mask"] = lambda: blockwise(q4, k4, v4, bias=bias4, dropout_mask=m4,
                                                             dropout_rate=0.1)
    ctx = heads(16, 33)
    padding4 = masks.key_padding_bias(torch.arange(513)[None, :] >= lengths4[:, None]).to(dev)
    cases["row8 dense 513x33 B16"] = lambda: blockwise(q4, ctx[1], ctx[2])
    cases["row8 dense 33x513 B16 key padding"] = lambda: blockwise(ctx[0], k4, v4, bias=padding4)
    q5, k5, v5 = heads(32, 257)
    lengths5 = torch.randint(33, 514, (32,), generator=g).to(dev)
    m5 = (torch.rand(32, 12, 257, 514, generator=g) >= 0.1).to(dev)[..., :257]  # the chunk's column view
    ring = dict(kv_lengths=lengths5, causal=True, offsets=(257, 0))
    cases["row8 offsets (257,0) B32"] = lambda: blockwise(q5, k5, v5, **ring)
    cases["row8 offsets (257,0) B32 dropout"] = lambda: blockwise(q5, k5, v5, **ring, **drop)
    cases["row8 offsets (257,0) B32 mask"] = lambda: blockwise(q5, k5, v5, **ring, dropout_mask=m5,
                                                               dropout_rate=0.1)
    res = {"pkg": label, **{name: median_ms(fn) for name, fn in cases.items()}}
    res["card"] = torch.cuda.get_device_name(0)
    return res


if __name__ == "__main__":
    print("AB " + json.dumps(main(sys.argv[1], sys.argv[2])), flush=True)
