"""The CUDA kernels of the port against their plain PyTorch versions, on the
card.  Each test skips on a host without one (a CUDA kernel has no CPU
mode).  This file imports no jax, so it runs on a machine that has only
the port's dependencies:

  PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

The grouped LoRA delta holds to rtol 1e-4, atol 1e-5 in f32: the kernel
sums in another order than the plain version (strided K partials, then a
tree reduction), at K up to 4096.  The transport kernels hold bitwise.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import quantization as qz
from repro_torch.core import selectors as sel
from repro_torch.kernels import fused_transport as ft
from repro_torch.kernels import topk_mask as tm
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


# ---------------------------------------------------------------------------
# the Top-K transport kernels (csrc/transport.cu) against their plain
# versions: bitwise.  Counts and bins are integer sums (order-free), absmax
# a max, and the masked / quantized values elementwise f32 chains with the
# same IEEE ops, so nothing may differ in a single bit.
# ---------------------------------------------------------------------------

def _bits(t):
    return t.contiguous().view(torch.int32).cpu()


def _rows(seed, B, n, kind="normal"):
    rng = np.random.default_rng(seed)
    if kind == "zeros":
        x = np.zeros((B, n), np.float32)
    elif kind == "ties":
        x = rng.integers(-3, 4, (B, n)).astype(np.float32) * np.float32(0.25)
    else:
        x = rng.standard_normal((B, n), dtype=np.float32)
    u = rng.random((B, n), dtype=np.float32)
    return torch.from_numpy(x).cuda(), torch.from_numpy(u).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 50, 4096, 70001, 1_000_003])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("kind", ["normal", "ties", "zeros"])
def test_transport_kernels_match_plain_bitwise(n, B, kind):
    _need_card()
    x, u = _rows(n + B, B, n, kind)
    hi0 = ft.absmax(x)
    assert torch.equal(_bits(hi0), _bits(ft.absmax_plain(x)))
    t = hi0 * 0.3
    assert torch.equal(tm.threshold_count(x, t),
                       tm.threshold_count_plain(x, t))
    got, cnt = tm.topk_mask(x, t)
    want, wcnt = tm.topk_mask_plain(x, t)
    assert torch.equal(_bits(got), _bits(want)) and torch.equal(cnt, wcnt)
    assert torch.equal(ft.bin_counts(x, hi0, 12),
                       ft.bin_counts_plain(x, hi0, 12))
    scale = torch.clamp_min(hi0 / 7.0, 1e-12)
    for bits in (0, 4, 8):
        for uu in (None, u):
            got, cnt = ft.fused_mask_quantize(x, t, scale, uu, bits)
            want, wcnt = ft.fused_mask_quantize_plain(
                x, t, scale, uu if bits else None, bits)
            torch.cuda.synchronize()
            assert torch.equal(_bits(got), _bits(want)), (bits, uu is None)
            assert torch.equal(cnt, wcnt)


@pytest.mark.cuda
def test_transport_kernels_unaligned_rows_and_counters():
    # a view starting one float in is not 16-byte aligned: the scalar path
    _need_card()
    x, u = _rows(3, 1, 4097)
    x1, u1 = x[0, 1:], u[0, 1:]
    before = {f.symbol: f.launches for f in (
        tm.THRESHOLD_COUNT, tm.TOPK_MASK, ft.ABSMAX, ft.BIN_COUNTS,
        ft.MASK_QUANTIZE)}
    hi0 = ft.absmax(x1)
    assert torch.equal(_bits(hi0), _bits(x1.abs().amax()))
    t = hi0 * 0.5
    assert int(tm.threshold_count(x1, t)) == int((x1.abs() >= t).sum())
    got, _ = tm.topk_mask(x1, t)
    assert torch.equal(_bits(got), _bits(torch.where(x1.abs() >= t, x1, 0.0)))
    assert torch.equal(ft.bin_counts(x1, hi0, 7),
                       ft.bin_counts_plain(x1[None], hi0[None], 7)[0])
    got, _ = ft.fused_mask_quantize(x1, t, hi0 / 7.0, u1, 4)
    want, _ = ft.fused_mask_quantize_plain(x1[None], t[None], (hi0 / 7.0)[None],
                                           u1[None], 4)
    assert torch.equal(_bits(got), _bits(want[0]))
    after = {f.symbol: f.launches for f in (
        tm.THRESHOLD_COUNT, tm.TOPK_MASK, ft.ABSMAX, ft.BIN_COUNTS,
        ft.MASK_QUANTIZE)}
    assert all(after[k] == before[k] + 1 for k in after), (before, after)


@pytest.mark.cuda
def test_transport_kernels_validate_inputs():
    _need_card()
    x, _ = _rows(4, 2, 100)
    with pytest.raises(TypeError, match="f32"):
        ft.absmax(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        ft.absmax(x[:, ::2])
    with pytest.raises(ValueError, match="levels"):
        ft.bin_counts(x, ft.absmax(x), 13)
    with pytest.raises(ValueError, match="on cpu"):
        tm.topk_mask(x, torch.ones(2))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [50, 70001, 1_000_003])
def test_kernel_selectors_match_histogram_on_the_card(n):
    # FusedSelector(levels=L) == HistogramSelector(iters=L) and
    # PallasSelector(iters=L) == HistogramSelector(iters=L), per row with
    # per-row counts including k = 0 and k = n
    _need_card()
    x, u = _rows(n, 4, n, "ties" if n == 50 else "normal")
    k = torch.tensor([0, 1, n // 4, n], dtype=torch.int32, device="cuda")
    for kern, levels in ((sel.FusedSelector(levels=12), 12),
                         (sel.PallasSelector(iters=16), 16)):
        got, gn = kern.sparsify_by_count(x, k)
        want, wn = sel.HistogramSelector(iters=levels).sparsify_by_count(x, k)
        assert torch.equal(got, want) and torch.equal(gn, wn)
    got, gn = sel.FusedSelector().sparsify_quantized(x, count=k, bits=4, rng=u)
    v, wn = sel.HistogramSelector(iters=12).sparsify_by_count(x, k)
    want = qz.quantize_roundtrip(v, 4, u) * (k > 0)[:, None]
    assert torch.equal(got, want) and torch.equal(gn, wn)


# ---------------------------------------------------------------------------
# the two pack kernels (csrc/transport.cu) against their plain versions:
# bitwise.  Counts and offsets are integer sums, slots are positions, and
# kernel 7 quantizes with mask_quantize's device code.
# ---------------------------------------------------------------------------

def _sparse(seed, B, n, kind):
    """(B, n) rows for the pack: 25% nonzero normal draws, with -0.0 and a
    NaN mixed in, tied, or all zeros."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, n), dtype=np.float32)
    x = np.where(rng.random((B, n)) < 0.25, x, np.float32(0.0))
    if kind == "negzero":
        x = np.where(rng.random((B, n)) < 0.2, np.float32(-0.0), x)
        x[0, n // 2] = np.nan
    elif kind == "ties":
        x = np.where(x != 0, np.sign(x) * np.float32(0.5), x)
    elif kind == "zeros":
        x[:] = 0.0
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 50, 4096, 70001, 1_000_003])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("kind", ["normal", "negzero", "ties", "zeros"])
def test_pack_batch_kernel_matches_plain_bitwise(n, B, kind):
    _need_card()
    x = _sparse(n + B, B, n, kind)
    for cap in (max(n // 3, 1), n // 64, n + 5):    # fits, overflows, spare
        got = ft.pack_values_batch(x, cap)
        want = ft.pack_rows_plain(x, x != 0, cap, n)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]), cap
        assert torch.equal(_bits(got[1]), _bits(want[1])), cap
        assert torch.equal(got[2], want[2]), cap


@pytest.mark.cuda
@pytest.mark.parametrize("n", [50, 70001, 1_000_003])
@pytest.mark.parametrize("B", [1, 4])
def test_mask_quantize_pack_kernel_matches_plain_bitwise(n, B):
    _need_card()
    x, u = _rows(n + 7, B, n)
    x[0, n // 3] = 100.0                # other survivors round to zero
    hi0 = ft.absmax(x)
    for frac in (0.3, 0.0):             # 0.0: every entry survives
        t = torch.clamp_min(hi0 * frac, 1e-30)
        for bits in (0, 4, 8):
            scale = qz.scale_of(hi0, bits) if bits else torch.ones_like(hi0)
            for uu in ((None, u) if bits else (None,)):
                for cap in (n // 2, n // 50 + 1):
                    got = ft.fused_mask_quantize_pack(x, t, scale, uu, bits,
                                                      cap)
                    want = ft.fused_mask_quantize_pack_plain(
                        x, t, scale, uu, bits, cap, n)
                    torch.cuda.synchronize()
                    what = (frac, bits, uu is None, cap)
                    assert torch.equal(_bits(got[0]), _bits(want[0])), what
                    assert torch.equal(got[1], want[1]), what
                    assert torch.equal(_bits(got[2]), _bits(want[2])), what
                    assert torch.equal(got[3], want[3]), what


@pytest.mark.cuda
def test_pack_kernels_count_launches_and_validate():
    _need_card()
    x = _sparse(5, 2, 10_000, "normal")
    before = (ft.PACK_BATCH.launches, ft.MASK_QUANTIZE_PACK.launches)
    ft.pack_values_batch(x, 3000)
    ft.fused_mask_quantize_pack(x, torch.full((2,), 0.5, device="cuda"),
                                torch.ones(2, device="cuda"), None, 0, 3000)
    assert (ft.PACK_BATCH.launches, ft.MASK_QUANTIZE_PACK.launches) == (
        before[0] + 1, before[1] + 1)
    with pytest.raises(TypeError, match="f32"):
        ft.pack_values_batch(x.double(), 10)
    with pytest.raises(ValueError, match="contiguous"):
        ft.pack_values_batch(x[:, ::2], 10)


@pytest.mark.cuda
def test_packed_selector_and_accumulate_on_the_card():
    # the packed entry point on the card equals the same call on the CPU
    # (plain versions), and the flat and edge accumulates agree bitwise
    _need_card()
    x, u = _rows(11, 1, 1_000_003)
    k = 250_000
    for bits, uu in ((0, None), (4, u[0])):
        got = sel.FusedSelector().sparsify_quantized_packed(
            x[0], count=k, bits=bits, rng=uu, cap=281_250)
        want = sel.FusedSelector().sparsify_quantized_packed(
            x[0].cpu(), count=k, bits=bits,
            rng=None if uu is None else uu.cpu(), cap=281_250)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    rows = _sparse(12, 4, 1_000_003, "normal")   # no NaN: its payload
    idx, val, _ = ft.pack_values_batch(rows, 300_000)  # differs by device
    flat = ft.sparse_accumulate(idx, val, 1_000_003)
    for edges in (1, 4, 7):
        assert torch.equal(_bits(ft.hierarchical_accumulate(
            idx, val, 1_000_003, edges)), _bits(flat))
    assert torch.equal(_bits(flat.cpu()), _bits(ft.sparse_accumulate(
        idx.cpu(), val.cpu(), 1_000_003)))
