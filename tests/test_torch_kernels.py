"""Grouped multi-adapter LoRA delta: the port's registry and plain versions
against the reference's.  Inputs are made with numpy from a seed and fed to
both packages.

Tolerance rtol = atol = 1e-6: torch's and XLA's CPU dots sum in different
orders.  The CUDA kernel's own tests are in tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lora_matmul import grouped_lora_delta as jax_delta
from repro_torch.kernels.lora_matmul import (CudaGroupedKernel,
                                             grouped_lora_delta,
                                             registered_grouped_kernels,
                                             resolve_grouped_kernel)

TOL = dict(rtol=1e-6, atol=1e-6)


def _case(seed, M, K=24, R=5, N=50, G=3):
    # fan-in scaled pages, as adapters are initialised: the delta is O(1),
    # so the absolute tolerance means the same thing at every K and R
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K), dtype=np.float32)
    a = rng.standard_normal((G, K, R), dtype=np.float32) / np.float32(K ** 0.5)
    b = rng.standard_normal((G, R, N), dtype=np.float32) / np.float32(R ** 0.5)
    gidx = rng.integers(0, G, size=M).astype(np.int32)
    return x, a, b, gidx


def _port(kernel, x, a, b, gidx, scale, device="cpu"):
    t = [torch.from_numpy(v).to(device) for v in (x, a, b, gidx)]
    return grouped_lora_delta(*t, scale, kernel=kernel)


def test_grouped_registry_names_and_resolution():
    assert registered_grouped_kernels() == (
        "grouped_gather", "grouped_pallas", "grouped_ref")
    assert resolve_grouped_kernel(None, "cpu").name == "grouped_gather"
    # resolution is by device and needs no card: CUDA tensors get the kernel
    assert resolve_grouped_kernel(None, "cuda").name == "grouped_pallas"
    assert isinstance(resolve_grouped_kernel("grouped_pallas"),
                      CudaGroupedKernel)
    with pytest.raises(ValueError, match="device"):
        resolve_grouped_kernel(None)
    with pytest.raises(KeyError, match="known"):
        resolve_grouped_kernel("grouped_nope")


@pytest.mark.parametrize("M", [1, 7, 130])
def test_grouped_plain_versions_match_jax(M):
    x, a, b, gidx = _case(M, M)
    want = np.asarray(jax_delta(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b),
                                jnp.asarray(gidx), 1.7, kernel="grouped_ref"))
    pal = np.asarray(jax_delta(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b),
                               jnp.asarray(gidx), 1.7,
                               kernel="grouped_pallas"))   # interpret mode
    np.testing.assert_array_equal(pal, want)
    for kern in ("grouped_ref", "grouped_gather"):
        got = _port(kern, x, a, b, gidx, 1.7)
        assert got.dtype == torch.float32 and got.shape == (M, 50)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the CPU default is the gather path
    np.testing.assert_array_equal(_port(None, x, a, b, gidx, 1.7).numpy(),
                                  _port("grouped_gather", x, a, b, gidx,
                                        1.7).numpy())


def test_grouped_delta_leading_dims():
    # (B, T, K) activations with one adapter per batch row
    x, a, b, _ = _case(5, 6)
    gidx = np.asarray([0, 2], np.int32)
    xbt = x.reshape(2, 3, -1)
    want = np.asarray(jax_delta(jnp.asarray(xbt), jnp.asarray(a),
                                jnp.asarray(b), jnp.asarray(gidx), 1.0,
                                kernel="grouped_gather"))
    out = _port("grouped_gather", xbt, a, b, gidx, 1.0)
    assert tuple(out.shape) == (2, 3, b.shape[-1])
    np.testing.assert_allclose(out.numpy(), want, **TOL)
    flat = _port("grouped_gather", x, a, b, np.repeat(gidx, 3), 1.0)
    np.testing.assert_array_equal(out.reshape(6, -1).numpy(), flat.numpy())


@pytest.mark.parametrize("kernel", ["grouped_ref", "grouped_gather"])
def test_grouped_rank_zero_padding_is_exact(kernel):
    # a rank-2 adapter zero-padded to the rank-4 pool contributes exactly its
    # rank-2 delta (the padded b rows are zero)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 16), dtype=np.float32)
    a2 = rng.standard_normal((16, 2), dtype=np.float32)
    b2 = rng.standard_normal((2, 20), dtype=np.float32)
    pool_a = np.stack([np.pad(a2, ((0, 0), (0, 2))),
                       rng.standard_normal((16, 4), dtype=np.float32)])
    pool_b = np.stack([np.pad(b2, ((0, 2), (0, 0))),
                       rng.standard_normal((4, 20), dtype=np.float32)])
    gidx = np.zeros(6, np.int32)
    got = _port(kernel, x, pool_a, pool_b, gidx, 2.0)
    want = _port(kernel, x, a2[None], b2[None], gidx, 2.0)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_grouped_pallas_refuses_cpu_tensors():
    x, a, b, gidx = _case(0, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _port("grouped_pallas", x, a, b, gidx, 1.0)
