"""The CUDA kernels of the port against their plain PyTorch versions, on the
card.  Each test skips on a host without one (a CUDA kernel has no CPU
mode).  This file imports no jax, so it runs on a machine that has only
the port's dependencies:

  PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerance rtol 1e-4, atol 1e-5 in f32: the kernel sums in another order
than the plain version (strided K partials, then a tree reduction), at
K up to 4096.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.lora_matmul import (grouped_lora_delta,
                                             resolve_grouped_kernel)


def _case(seed, M, K, R, N, G):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K), dtype=np.float32)
    a = rng.standard_normal((G, K, R), dtype=np.float32) / np.float32(K ** 0.5)
    b = rng.standard_normal((G, R, N), dtype=np.float32) / np.float32(R ** 0.5)
    gidx = rng.integers(0, G, size=M).astype(np.int32)
    return x, a, b, gidx


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _port(kernel, x, a, b, gidx, scale, device="cpu"):
    t = [torch.from_numpy(v).to(device) for v in (x, a, b, gidx)]
    return grouped_lora_delta(*t, scale, kernel=kernel)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,R,N,G", [
    (1, 4096, 16, 4096, 4), (8, 4096, 16, 512, 4), (130, 4096, 16, 50, 4),
    (7, 24, 5, 50, 3), (9, 300, 64, 257, 2), (3, 100, 33, 1000, 5)])
def test_grouped_cuda_kernel_matches_plain(M, K, R, N, G):
    _need_card()
    x, a, b, gidx = _case(M + N, M, K, R, N, G)
    kern = resolve_grouped_kernel("grouped_pallas")
    before = kern.launches
    got = _port("grouped_pallas", x, a, b, gidx, 1.7, device="cuda")
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = _port("grouped_ref", x, a, b, gidx, 1.7, device="cuda")
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_grouped_cuda_kernel_validates_inputs():
    _need_card()
    x, a, b, gidx = (torch.from_numpy(v).cuda() for v in _case(1, 4, 24, 65, 50, 3))
    kern = resolve_grouped_kernel("grouped_pallas")
    with pytest.raises(ValueError, match="rank 65"):
        kern.delta(x, a, b, gidx, 1.0)
    with pytest.raises(TypeError, match="int32"):
        kern.delta(x, a[..., :8].contiguous(), b[:, :8].contiguous(),
                   gidx.long(), 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        kern.delta(x, a[..., :8], b[:, :8].contiguous(), gidx, 1.0)


@pytest.mark.cuda
def test_grouped_cuda_kernel_rank_padding_is_exact():
    # zero-padded rank components add exact zeros: bit-equal to the unpadded
    _need_card()
    x, a, b, gidx = _case(4, 6, 4096, 2, 512, 1)
    a4 = np.pad(a, ((0, 0), (0, 0), (0, 14)))
    b4 = np.pad(b, ((0, 0), (0, 14), (0, 0)))
    got = _port("grouped_pallas", x, a4, b4, gidx, 2.0, device="cuda")
    want = _port("grouped_pallas", x, a, b, gidx, 2.0, device="cuda")
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_tensors_resolve_to_the_kernel():
    # kernel=None on CUDA tensors launches the kernel, with leading dims
    _need_card()
    x, a, b, _ = _case(5, 6, 64, 8, 96, 3)
    gidx = np.asarray([0, 2], np.int32)
    kern = resolve_grouped_kernel("grouped_pallas")
    before = kern.launches
    got = _port(None, x.reshape(2, 3, -1), a, b, gidx, 1.0, device="cuda")
    assert kern.launches == before + 1 and tuple(got.shape) == (2, 3, 96)
    want = _port("grouped_gather", x.reshape(2, 3, -1), a, b, gidx, 1.0)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                               rtol=1e-4, atol=1e-5)
