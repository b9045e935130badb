"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA Hopper GPU and nvcc; everywhere else each test skips. On the
card: `python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py`
(`--noconftest`: the repo's conftest imports jax, which the card's machine
does not have)."""

import os
import sys

import numpy as np
import pytest
import torch

from markushgrapher_torch.ops import _build, bias_build, flash_attention
from markushgrapher_torch.ops import mxu_decode

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's Hopper kernels)")
    return torch.device("cuda")


def test_main_path_shapes(dev):
    """Each kernel at the main path's shapes, with chip_smoke's tolerances."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    res = chip_smoke.check_kernels(dev)
    assert set(res) == {"bias_build_i8", "flash_i8", "decode_int4"}


def test_bias_builder_packed_positions(dev):
    rng = np.random.RandomState(0)
    B, L, H = 2, 320, 16
    tabs = [torch.tensor(rng.randn(32, H), dtype=torch.float32, device=dev)
            for _ in range(3)]
    bbox = torch.tensor(rng.rand(B, L, 4), dtype=torch.float32, device=dev)
    pos = torch.tensor(np.stack([np.sort(rng.permutation(3 * L)[:L])
                                 for _ in range(B)]), device=dev)
    args = (*tabs, bbox, None, L, 32, 128, 100, 100)
    got, s = bias_build.encoder_position_bias_kernel_i8(*args, positions=pos)
    ref, s_ref = bias_build.plain(*args, positions=pos)
    assert torch.equal(got, ref) and torch.equal(s, s_ref)


def test_flash_ragged_length(dev):
    """L = 200 is no multiple of the 64-row tiles: the edges are masked."""
    rng = np.random.RandomState(1)
    B, L, H, D = 1, 200, 4, 64
    q, k, v = (torch.tensor(rng.randn(B, L, H, D) * 0.3, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    bias = torch.tensor(rng.randint(-127, 128, (B, H, L, L)),
                        dtype=torch.int8, device=dev)
    scales = torch.full((H,), 0.02, device=dev)
    mask = torch.ones((B, L), dtype=torch.int32, device=dev)
    mask[:, 150:] = 0
    got = flash_attention.flash_attention_bias_i8(q, k, v, bias, scales, mask)
    ref = flash_attention.plain(q, k, v, bias, scales, mask)
    torch.testing.assert_close(got.float(), ref.float(), atol=1e-3,
                               rtol=1.6e-2)


def test_decode_small_heads(dev):
    """Tiny head dim (D = 4, H = 8) and a [1, 1, K] bias broadcast."""
    rng = np.random.RandomState(2)
    B, H, D, K = 3, 8, 4, 256
    q = torch.tensor(rng.randn(B, H, D), dtype=torch.float32, device=dev)
    kq, vq = (mxu_decode.pack_int4(torch.tensor(
        rng.randint(-7, 8, (B, K, H * D)), dtype=torch.int8, device=dev))
        for _ in range(2))
    ks, vs = (torch.tensor(rng.rand(B, H, K) * 0.2, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    bias = torch.zeros((1, 1, K), device=dev)
    got = mxu_decode.cross_decode_mxu_int4(q, kq, ks, vq, vs, bias)
    ref = mxu_decode.plain(q, kq, ks, vq, vs, bias)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, ref, atol=2e-3, rtol=2e-2)


def test_wrappers_count_and_refuse(dev):
    _build.reset_launches()
    q = torch.zeros((1, 64, 2, 32), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="head dim 64"):
        flash_attention.flash_attention_bias_i8(
            q, q, q, torch.zeros((1, 2, 64, 64), dtype=torch.int8,
                                 device=dev),
            torch.ones(2, device=dev), torch.ones((1, 64), device=dev))
    assert _build.LAUNCHES["flash_i8"] == 0
