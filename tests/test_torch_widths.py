"""The CUDA kernels' domain, held by the wrappers' shape checks on the CPU
(ROADMAP.md §C 1): H any multiple of 64 up to 1024 for the width kernels
(rows 1-5, 11-14), head dim 32, 64 or 128 for every kernel that attends
(rows 1, 3-10). Inside it every check passes; outside it each raises in its
own words. The checks read shapes, dtypes and strides only, so they run on
CPU tensors (broadcast views stand in for the weights); the kernels
themselves are held against their plain versions at these widths by
``tests/test_torch_cuda.py`` on the card.
"""

import pytest
import torch

from stlt_tpu_torch.ops import flash
from stlt_tpu_torch.ops import fused_encoder as fe

DOMAIN = [(H, H // D) for H in range(64, 1025, 64) for D in (32, 64, 128) if H % D == 0]
OUTSIDE = [(32, 1), (96, 3), (1088, 17), (1088, 34), (64, 8), (256, 1), (192, 4), (1024, 2),
           (320, 3)]


def _view(*shape):
    return torch.zeros(()).expand(*shape)


@pytest.mark.parametrize("H,N", DOMAIN + OUTSIDE)
def test_kernel_checks_take_the_domain_and_refuse_the_rest(H, N):
    width_ok = H % 64 == 0 and 64 <= H <= 1024
    D = H // N if H % N == 0 else None
    head_ok = D in (32, 64, 128)
    f32 = torch.float32
    x = torch.zeros(2, 17, H)

    def check(ok, words, fn, *args):
        if ok:
            fn(*args)
        else:
            with pytest.raises(ValueError, match=words):
                fn(*args)

    check(width_ok, "H in 64", fe._check_kernel_width, "op", H)
    proj = (x, _view(H, 3 * H), _view(3 * H), _view(H, H), N, f32)
    check(width_ok and head_ok, "H in 64" if not width_ok else "head dim in",
          fe._check_proj_kernel, "op", *proj)
    cross = (x, torch.zeros(2, 33, H), _view(H, H), _view(H), _view(H, 2 * H), _view(2 * H),
             _view(H, H), _view(H), N, f32)
    check(width_ok and head_ok, "H in 64" if not width_ok else "head dim in",
          fe._check_cross_kernel, "op", *cross)
    if D is not None:
        q = torch.zeros(2, 40, N, D)
        check(head_ok, "head dim in", flash._check_heads, "op", q, q, q)
    assert (H, N) in DOMAIN or not (width_ok and head_ok)
