"""The CUDA kernels of the port against their plain PyTorch versions, on the
card.  Each test skips on a host without one (a CUDA kernel has no CPU
mode).  This file imports no jax, so it runs on a machine that has only
the port's dependencies:

  PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

The grouped LoRA delta holds to rtol 1e-4, atol 1e-5 in f32: the kernel
sums in another order than the plain version (K slices over a cluster's
blocks, strided partials, tree reductions), at K up to 4097; two launches
on the same inputs are bitwise equal.  The transport kernels hold
bitwise.  The flash kernel holds to 2e-6 in f32 and 2e-2 in bf16, the
fused LoRA matmul to 1e-5 in f32 and 5e-2 in bf16: the tolerances of the
reference's own kernel tests (tests/test_kernels.py).  Those tests draw
short rows, whose outputs are about 0.1; over a thousand keys they are
about 0.05, so bf16 attention is also held row by row: each output row
(one query, one head) to 2e-2 of its own largest value, and to 4e-3 of it
against an f64 attention on the same inputs (the bf16 output's own
rounding allows 2^-8 = 3.9e-3; a p rounded to bf16 before the second
product gives 5e-3 to 6e-3).
"""
import _torch_threads  # noqa: F401  (this process's share of the cores)
import math

import numpy as np
import pytest
import torch

from _bin_rows import KINDS as BIN_KINDS, bin_rows
from repro_torch.core import quantization as qz
from repro_torch.core import selectors as sel
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_transport as ft
from repro_torch.kernels import lora_matmul as lm
from repro_torch.kernels import ops
from repro_torch.kernels import ref
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


# the decode shapes and ragged ones, every rank bucket of the kernel
@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 8, 16, 64])
@pytest.mark.parametrize("N", [4096, 512, 50])
@pytest.mark.parametrize("M", [1, 8, 130])
def test_grouped_cluster_kernel_matches_ref(M, N, R):
    _need_card()
    x, a, b, gidx = _case(M * N + R, M, 4096, R, N, 4)
    got = _port("grouped_pallas", x, a, b, gidx, 1.3, device="cuda")
    want = _port("grouped_ref", x, a, b, gidx, 1.3, device="cuda")
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)


# K that is not a multiple of 4 or of the cluster's 8 slices (a slice is
# rounded up to 4, so the last blocks get a short slice or none)
@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 6, 30, 4094, 4097])
@pytest.mark.parametrize("M,R,N", [(8, 16, 4096), (130, 5, 257)])
def test_grouped_cluster_kernel_ragged_k(K, M, R, N):
    _need_card()
    x, a, b, gidx = _case(K + M, M, K, R, N, 3)
    got = _port("grouped_pallas", x, a, b, gidx, 0.7, device="cuda")
    want = _port("grouped_ref", x, a, b, gidx, 0.7, device="cuda")
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)


# all rows on one page (130 rows: three clusters of up to 64), pages that
# no row uses, and indices outside [0, G), which the kernel clamps
@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["one_page", "unused_pages", "clamped"])
def test_grouped_cluster_kernel_page_layouts(layout):
    _need_card()
    M, G = 130, 5
    x, a, b, _ = _case(11, M, 4096, 16, 512, G)
    rng = np.random.default_rng(12)
    gidx = {"one_page": np.full(M, 3),
            "unused_pages": rng.choice([1, 4], M),
            "clamped": rng.integers(-4, G + 4, M)}[layout].astype(np.int32)
    got = _port("grouped_pallas", x, a, b, gidx, 1.0, device="cuda")
    want = _port("grouped_ref", x, a, b, np.clip(gidx, 0, G - 1), 1.0,
                 device="cuda")
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,R,N", [(8, 4096, 16, 4096), (130, 4097, 33, 50)])
def test_grouped_cluster_kernel_is_deterministic(M, K, R, N):
    # every sum has a fixed order (no float atomics): two launches on the
    # same inputs give the same bits
    _need_card()
    x, a, b, gidx = (torch.from_numpy(v).cuda()
                     for v in _case(13, M, K, R, N, 4))
    kern = resolve_grouped_kernel("grouped_pallas")
    first = kern.delta(x, a, b, gidx, 1.5)
    again = kern.delta(x, a, b, gidx, 1.5)
    assert torch.equal(first.view(torch.int32), again.view(torch.int32))


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


# the row kinds of the bisection-bin search (tests/_bin_rows.py) that the
# other four kernels do not take: non-finite and denormal values, and a hi0
# that is no absmax.  bin_counts alone runs on them, at their own hi0.
BIN_ONLY = tuple(k for k in BIN_KINDS if k not in ("normal", "ties", "zeros"))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 50, 4096, 70001, 1_000_003])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("kind", ("normal", "ties", "zeros") + BIN_ONLY)
def test_transport_kernels_match_plain_bitwise(n, B, kind):
    _need_card()
    if kind in BIN_ONLY:
        for levels in (1, 5, 12):
            x, h = (torch.from_numpy(v).cuda() for v in
                    bin_rows(kind, B, n, levels, seed=n + B + levels))
            got = ft.bin_counts(x, h, levels)
            assert torch.equal(got, ft.bin_counts_plain(x, h, levels)), levels
            assert bool((got.sum(-1) == n).all()), levels
        return
    x, u = _rows(n + B, B, n, kind)
    hi0 = ft.absmax(x)
    assert torch.equal(_bits(hi0), _bits(ft.absmax_plain(x)))
    t = hi0 * 0.3
    assert torch.equal(tm.threshold_count(x, t),
                       tm.threshold_count_plain(x, t))
    got, cnt = tm.topk_mask(x, t)
    want, wcnt = tm.topk_mask_plain(x, t)
    assert torch.equal(_bits(got), _bits(want)) and torch.equal(cnt, wcnt)
    for levels in (1, 5, 12):
        assert torch.equal(ft.bin_counts(x, hi0, levels),
                           ft.bin_counts_plain(x, hi0, levels)), levels
    scale = torch.clamp_min(hi0 / 7.0, 1e-12)
    for bits in (0, 4, 8):
        for uu in (None, u):
            got, cnt = ft.fused_mask_quantize(x, t, scale, uu, bits)
            want, wcnt = ft.fused_mask_quantize_plain(
                x, t, scale, uu if bits else None, bits)
            torch.cuda.synchronize()
            assert torch.equal(_bits(got), _bits(want)), (bits, uu is None)
            assert torch.equal(cnt, wcnt)


def _same_nan(got, want):
    """NaN at the same places, every other element bit for bit."""
    g, w = got.contiguous().cpu(), want.contiguous().cpu()
    nan = torch.isnan(w)
    return (torch.equal(torch.isnan(g), nan) and
            torch.equal(g.view(torch.int32)[~nan], w.view(torch.int32)[~nan]))


# rows that hold +-inf (their scale is inf: a kept +-inf quantizes to inf /
# inf = NaN, which the clip must keep) or NaN elements (masked out), at the
# rows' own scale and at a finite one (a kept +-inf clips to a bound)
@pytest.mark.cuda
@pytest.mark.parametrize("n", [50, 70001, 1_000_003])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("kind", ["inf_hi0", "nan"])
def test_mask_quantize_kernels_keep_nan_bitwise(n, B, kind):
    _need_card()
    xs, hs = bin_rows(kind, B, n, 12, seed=n + B + 3)
    x, h = (torch.from_numpy(a).cuda() for a in (xs, hs))
    u = torch.from_numpy(np.random.default_rng(n + B).random(
        (B, n), dtype=np.float32)).cuda()
    finite = torch.where(torch.isfinite(x), x.abs(), 0.0).amax(-1)
    t = finite * 0.3
    for scale in (qz.scale_of(h, 4), qz.scale_of(finite, 4)):
        for uu in (None, u):
            what = (bool(torch.isinf(scale).any()), uu is None)
            got, cnt = ft.fused_mask_quantize(x, t, scale, uu, 4)
            want, wcnt = ft.fused_mask_quantize_plain(x, t, scale, uu, 4)
            torch.cuda.synchronize()
            assert _same_nan(got, want) and torch.equal(cnt, wcnt), what
            cap = n // 3 + 1
            got = ft.fused_mask_quantize_pack(x, t, scale, uu, 4, cap)
            want = ft.fused_mask_quantize_pack_plain(x, t, scale, uu, 4, cap, n)
            torch.cuda.synchronize()
            assert _same_nan(got[0], want[0]), what
            assert torch.equal(got[1], want[1]), what
            assert _same_nan(got[2], want[2]), what
            assert torch.equal(got[3], want[3]), what
    if kind == "inf_hi0":       # the case the clip must keep: NaN out
        got, _ = ft.fused_mask_quantize(x, t, qz.scale_of(h, 4), None, 4)
        assert bool(torch.isnan(got[torch.isinf(x)]).all())


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
@pytest.mark.parametrize("case", ["yi9b_b4", "unaligned", "ragged", "cap0",
                                  "overflow"])
def test_pack_batch_kernel_edge_cases_bitwise(case):
    # yi9b_b4: four rows of the Yi-9B LoRA vector, 2,400 tiles a row, more
    # than are resident at once, so tiles wait on their look-back; then a
    # view one float in (no 16-byte loads), n % 4 != 0, cap 0, and a cap
    # every row overflows.  Each call counts one launch; two calls agree.
    _need_card()
    n, B, cap = {"yi9b_b4": (9_830_400, 4, 2_764_800),
                 "unaligned": (70_001, 2, 30_000),
                 "ragged": (1_000_003, 3, 300_000),
                 "cap0": (70_001, 2, 0),
                 "overflow": (1_000_003, 2, 10_000)}[case]
    if case == "unaligned":     # a contiguous view one float in
        x = _sparse(n + B, 1, B * n + 1, "negzero")[0, 1:].view(B, n)
        assert x.data_ptr() % 16
    else:
        x = _sparse(n + B + cap, B, n, "negzero")
    want = ft.pack_rows_plain(x, x != 0, cap, n)
    before = ft.PACK_BATCH.launches
    got = ft.pack_values_batch(x, cap)
    again = ft.pack_values_batch(x, cap)
    torch.cuda.synchronize()
    assert ft.PACK_BATCH.launches == before + 2
    for g, a in ((got, want), (again, got)):
        assert torch.equal(g[0], a[0]) and torch.equal(g[2], a[2])
        assert torch.equal(_bits(g[1]), _bits(a[1]))
    if case == "overflow":
        assert bool((got[2] > cap).all())


@pytest.mark.cuda
@pytest.mark.parametrize("bits,stochastic", [(0, False), (4, False),
                                             (4, True)])
@pytest.mark.parametrize("case", ["yi9b_b4", "unaligned", "ragged", "cap0",
                                  "overflow", "nonfinite"])
def test_mask_quantize_pack_kernel_edge_cases_bitwise(case, bits, stochastic):
    # the one-pass scan on what test_pack_batch_kernel_edge_cases_bitwise
    # holds pack_batch to: four Yi-9B rows (tiles wait on their look-back),
    # x and u one float in (no 16-byte loads), n % 4 != 0, cap 0, a cap
    # every row overflows; and rows holding +-inf and NaN (NaN dropped,
    # +-inf kept; the first row at the inf scale such a row gets, its
    # survivors NaN).  Each call counts one launch; two calls agree.
    _need_card()
    n, B, cap = {"yi9b_b4": (9_830_400, 4, 2_764_800),
                 "unaligned": (70_001, 2, 30_000),
                 "ragged": (1_000_003, 3, 300_000),
                 "cap0": (70_001, 2, 0),
                 "overflow": (1_000_003, 2, 10_000),
                 "nonfinite": (70_001, 3, 30_000)}[case]
    if case == "unaligned":     # contiguous views one float in
        x, u = (t[0, 1:].view(B, n) for t in _rows(n + B, 1, B * n + 1))
        assert x.data_ptr() % 16 and u.data_ptr() % 16
    else:
        x, u = _rows(n + B + cap, B, n)
    hi0 = ft.absmax(x)
    t = hi0 * 0.3
    scale = qz.scale_of(hi0, bits) if bits else torch.ones_like(hi0)
    if case == "nonfinite":
        x[:, 3::1001] = float("inf")
        x[:, 5::1003] = float("-inf")
        x[:, 7::997] = float("nan")
        scale[0] = float("inf")
    uu = u if stochastic else None
    want = ft.fused_mask_quantize_pack_plain(x, t, scale, uu, bits, cap, n)
    before = ft.MASK_QUANTIZE_PACK.launches
    got = ft.fused_mask_quantize_pack(x, t, scale, uu, bits, cap)
    again = ft.fused_mask_quantize_pack(x, t, scale, uu, bits, cap)
    torch.cuda.synchronize()
    assert ft.MASK_QUANTIZE_PACK.launches == before + 2
    for g, a in ((got, want), (again, got)):
        assert _same_nan(g[0], a[0])
        assert torch.equal(g[1], a[1]) and torch.equal(g[3], a[3])
        assert _same_nan(g[2], a[2])
    if case == "overflow":
        assert bool((got[3] > cap).all())
    if case == "nonfinite":
        kept = got[1][0] < n
        assert bits == 0 or bool(torch.isnan(got[2][0][kept]).all())
        assert not bool(torch.isnan(got[0][1:]).any())


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


# ---------------------------------------------------------------------------
# flash attention and the fused LoRA matmul (csrc/flash_attention.cu,
# csrc/lora_matmul.cu) against their plain versions
# ---------------------------------------------------------------------------

ATTN_TOL = {torch.float32: 2e-6, torch.bfloat16: 2e-2}
LORA_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}


F64_ROW_TOL = 4e-3       # bf16 output rows against an f64 attention


def _row_err(got, want):
    """The worst output row's largest |got - want| over its largest |want|."""
    d = (got.double() - want.double()).abs().amax(-1)
    return (d / want.double().abs().amax(-1).clamp_min(1e-30)).max().item()


def _attn_f64(q, k, v, scale, causal, window=None):
    """Attention of the same inputs in f64 (GQA: query head h reads kv head
    h // (H // KV)), not rounded; under `causal`, a window W keeps the keys
    t with s - W < t <= s."""
    S, H = q.shape[1], q.shape[2]
    T, G = k.shape[1], H // k.shape[2]
    kd, vd = (t.double().repeat_interleave(G, 2) for t in (k, v))
    s = torch.einsum("bshd,bthd->bhst", q.double(), kd) * scale
    if causal:
        t_ = torch.arange(T, device=q.device)[None, :]
        s_ = torch.arange(S, device=q.device)[:, None]
        keep = t_ <= s_
        if window is not None:
            keep &= t_ > s_ - window
        s = torch.where(keep, s, -1e30)
    return torch.einsum("bhst,bthd->bshd", torch.softmax(s, -1), vd)


def _assert_attn_close(got, want, dtype):
    tol = ATTN_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        assert _row_err(got, want) <= tol


def _attn(seed, B, S, T, H, KV, hd, dtype):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
               .to("cuda", dtype) for shape in
               ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd)))
    return q, k, v


def _route_launches(fn, route):
    return fn.launches, fn.launches_by_route.get(route, 0)


def _assert_lse_and_repeat(q, k, v, causal, scale, out, window=None):
    """The forward with lse: its out equals `out` bit for bit (a second
    launch, lse asked for) and its lse is within 1e-4 of the plain
    version's in f64 on the same inputs."""
    w = fa._check_window(window, causal, q.shape[1], k.shape[1])
    again, lse = fa._forward(q, k, v, causal, scale, want_lse=True, window=w)
    assert torch.equal(again, out)
    _, l64 = fa.flash_attention_plain(*(t.double() for t in (q, k, v)),
                                      causal=causal, scale=scale,
                                      window=window, return_lse=True)
    assert (lse.double() - l64).abs().max().item() <= 1e-4


# hd 128 in bf16 takes the wgmma kernel (ragged S and T, B = 2, H / KV in
# {1, 2, 4, 8}, a last query tile of one row past a 128-row tile, keys one
# past a 128-key tile; at S 1000 the last block's second consumer
# warpgroup holds 40 rows, at S 1025 none); hd 32 and 64 in bf16 the
# mma.sync kernel; hd 256 in bf16 the hd-256 wgmma kernel (64-key tiles,
# 128-row blocks: S and T of 1, 63, 64, 65, 127, 128, 129, 1000 / 1100 and
# 1025 / 1100, 16 / 16 and 8 / 2 heads); f32 the FMA kernel.  Each call is
# also bitwise equal to a second launch that writes lse, and that lse is
# the plain version's
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,T,H,KV,hd", [
    (1, 1, 1, 1, 1, 32), (2, 64, 64, 4, 2, 32), (1, 1000, 1000, 8, 2, 64),
    (1, 100, 37, 4, 4, 128), (2, 37, 100, 6, 3, 128), (1, 257, 257, 32, 4, 128),
    (1, 1, 1, 1, 1, 128), (2, 1000, 1100, 32, 4, 128),
    (2, 1025, 1100, 32, 4, 128), (2, 129, 300, 8, 8, 128),
    (1, 300, 129, 16, 4, 128), (2, 256, 256, 8, 1, 128),
    (1, 1, 1, 1, 1, 256), (2, 1000, 1100, 4, 4, 256),
    (1, 257, 257, 8, 2, 256), (1, 300, 129, 4, 4, 256),
    (1, 63, 63, 16, 16, 256), (2, 64, 64, 8, 2, 256),
    (1, 65, 65, 16, 16, 256), (1, 127, 129, 8, 2, 256),
    (2, 128, 128, 16, 16, 256), (1, 129, 127, 8, 2, 256),
    (1, 1, 65, 8, 2, 256), (2, 1000, 1100, 8, 2, 256),
    (2, 1025, 1100, 16, 16, 256)])
def test_flash_kernel_matches_plain(B, S, T, H, KV, hd, causal, dtype):
    _need_card()
    q, k, v = _attn(S + T + hd, B, S, T, H, KV, hd, dtype)
    scale = hd ** -0.5
    route = fa.flash_route(dtype, hd)
    n, nr = _route_launches(fa.FLASH, route)
    got = fa.flash_attention(q, k, v, causal=causal, scale=scale)
    torch.cuda.synchronize()
    assert _route_launches(fa.FLASH, route) == (n + 1, nr + 1)
    want = fa.flash_attention_plain(q, k, v, causal=causal, scale=scale)
    assert got.dtype == dtype and got.shape == q.shape
    _assert_attn_close(got, want, dtype)
    if dtype == torch.bfloat16:
        # p kept to f32 precision (a hi + lo pair of bf16) on the bf16 routes
        assert _row_err(got, _attn_f64(q, k, v, scale, causal)) <= F64_ROW_TOL
    _assert_lse_and_repeat(q, k, v, causal, scale, got)


# at hd 128 in bf16 the wgmma kernel, whose two consumer warpgroups take
# turns at the tensor cores: the last block's second warpgroup holds 40 rows
# (S 1000) or none (S 1025) and still takes every turn
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,T,H,KV,hd", [
    (2, 130, 130, 8, 2, 64), (2, 1000, 1100, 32, 4, 128),
    (2, 1025, 1100, 32, 4, 128)])
def test_flash_kernel_gqa_equals_prebroadcast_and_oracle(B, S, T, H, KV, hd,
                                                         causal, dtype):
    # two calls give the same bits; ops.flash_attention on K, V repeated per
    # query head gives the GQA call bit for bit; both hold to the
    # reference's oracle
    _need_card()
    q, k, v = _attn(3 + S, B, S, T, H, KV, hd, dtype)
    gqa = fa.flash_attention(q, k, v, causal=causal, scale=1 / math.sqrt(hd))
    again = fa.flash_attention(q, k, v, causal=causal,
                               scale=1 / math.sqrt(hd))
    assert torch.equal(gqa, again)
    kb, vb = (t.repeat_interleave(H // KV, dim=2) for t in (k, v))
    pre = ops.flash_attention(q, kb, vb, causal=causal)
    assert torch.equal(gqa, pre)
    want = ref.flash_attention_ref(q, kb, vb, causal=causal)
    _assert_attn_close(pre, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 1024, 8, 2, 128), (2, 768, 32, 4, 128), (2, 512, 8, 1, 64),
    (1, 1024, 16, 16, 256)])
def test_flash_kernel_bf16_matches_chunked_attention(B, S, H, KV, hd, causal):
    # chunked_attention, the model's plain path, keeps the probabilities in
    # f32, as the bf16 kernels do (a hi + lo pair of bf16)
    _need_card()
    from repro_torch.models.attention import chunked_attention
    q, k, v = _attn(5, B, S, S, H, KV, hd, torch.bfloat16)
    route = fa.flash_route(torch.bfloat16, hd)
    nr = fa.FLASH.launches_by_route.get(route, 0)
    got = fa.flash_attention(q, k, v, causal=causal, scale=hd ** -0.5)
    assert fa.FLASH.launches_by_route[route] == nr + 1
    want = chunked_attention(q, k, v, hd ** -0.5, causal=causal, cq=256,
                             ckv=256)
    _assert_attn_close(got, want, torch.bfloat16)
    exact = _attn_f64(q, k, v, hd ** -0.5, causal)
    assert _row_err(got, exact) <= F64_ROW_TOL


# a causal sliding window on every route (wgmma, mma_sync at hd 32 and 64,
# hd256 at 4 / 4 and 8 / 2 heads, fma at hd 64, 128 and 256): W of 1 (each
# row sees its own key), 37 and 100 (not multiples of a tile: the lowest
# visited tile holds no key of some rows' windows, and comes first for
# them), 4096 and 8192 over 9000 tokens, and W >= S (no effect: bitwise
# the call without a window); T past S and (with W 200) S past T; S and T
# of 65, 127, 128 and 129 around the 64-key tiles.  The lse a second launch
# writes is the plain version's.
WINDOW_ROUTES = [(torch.bfloat16, 128, 8, 2), (torch.bfloat16, 64, 8, 2),
                 (torch.bfloat16, 32, 4, 4), (torch.bfloat16, 256, 4, 4),
                 (torch.bfloat16, 256, 8, 2),
                 (torch.float32, 128, 4, 1), (torch.float32, 64, 4, 2),
                 (torch.float32, 256, 2, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd,H,KV", WINDOW_ROUTES)
@pytest.mark.parametrize("B,S,T,W", [
    (2, 1000, 1100, 1), (2, 1000, 1100, 37), (2, 1000, 1100, 100),
    (1, 300, 129, 200), (2, 1000, 1100, 1100), (1, 9000, 9000, 4096),
    (1, 9000, 9000, 8192), (1, 65, 65, 37), (2, 129, 128, 100),
    (1, 127, 128, 1), (1, 128, 128, 128)])
def test_flash_kernel_window_matches_plain(B, S, T, W, dtype, hd, H, KV):
    _need_card()
    q, k, v = _attn(S + W + hd, B, S, T, H, KV, hd, dtype)
    scale = hd ** -0.5
    route = fa.flash_route(dtype, hd)
    n, nr = _route_launches(fa.FLASH, route)
    nw = fa.FLASH.launches_by_tag.get("window", 0)
    got = fa.flash_attention(q, k, v, causal=True, scale=scale, window=W)
    again = fa.flash_attention(q, k, v, causal=True, scale=scale, window=W)
    torch.cuda.synchronize()
    assert _route_launches(fa.FLASH, route) == (n + 2, nr + 2)
    assert fa.FLASH.launches_by_tag["window"] == nw + 2
    assert torch.equal(got, again)
    want = fa.flash_attention_plain(q, k, v, causal=True, scale=scale,
                                    window=W)
    _assert_attn_close(got, want, dtype)
    if dtype == torch.bfloat16:
        assert _row_err(got, _attn_f64(q, k, v, scale, True, W)) \
            <= F64_ROW_TOL
    if W >= S:
        assert torch.equal(got, fa.flash_attention(q, k, v, causal=True,
                                                   scale=scale))
    _assert_lse_and_repeat(q, k, v, True, scale, got, W)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd,window", [
    (torch.bfloat16, 128, 64), (torch.bfloat16, 64, 5),
    (torch.float32, 32, 7), (torch.bfloat16, 256, None),
    (torch.float32, 256, 64)])
def test_flash_under_autograd_refuses_a_window_and_hd_256(dtype, hd, window):
    # no backward kernels for either yet: the forward refuses by name before
    # it launches, and runs under no_grad
    _need_card()
    q, k, v = _attn(8, 1, 100, 100, 2, 2, hd, dtype)
    n = fa.FLASH.launches
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        fa.flash_attention(q.clone().requires_grad_(), k, v, scale=0.1,
                           window=window)
    assert fa.FLASH.launches == n
    with torch.no_grad():
        out = fa.flash_attention(q.clone().requires_grad_(), k, v, scale=0.1,
                                 window=window)
    assert fa.FLASH.launches == n + 1 and not out.requires_grad


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_cannot_run():
    _need_card()
    q, k, v = _attn(4, 1, 16, 16, 2, 1, 64, torch.float32)
    # an input that requires a gradient no longer raises: the output
    # carries the backward kernels, which one backward pass launches once
    n_fwd, n_bwd = fa.FLASH.launches, fa.FLASH_BWD.launches
    out = fa.flash_attention(q.clone().requires_grad_(), k, v, scale=0.125)
    assert out.requires_grad and fa.FLASH.launches == n_fwd + 1
    out.sum().backward()
    torch.cuda.synchronize()
    assert fa.FLASH_BWD.launches_by_route.get("fma", 0) >= 1
    assert fa.FLASH_BWD.launches == n_bwd + 1
    with pytest.raises(ValueError, match="head size"):
        fa.flash_attention(q[..., :48], k[..., :48], v[..., :48], scale=0.125)
    with pytest.raises(TypeError, match="bf16 or f32"):
        fa.flash_attention(q.half(), k.half(), v.half(), scale=0.125)
    with pytest.raises(TypeError, match="k is"):
        fa.flash_attention(q, k.bfloat16(), v, scale=0.125)
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention(q, k, v, causal=False, scale=0.125, window=4)
    with pytest.raises(ValueError, match="see no key"):
        fa.flash_attention(q, k[:, :4], v[:, :4], scale=0.125, window=4)
    # the C entry point makes the same checks: a window without causal, and
    # rows that no key reaches, are refused before a launch
    out, n = torch.empty_like(q), fa.FLASH.launches
    for causal, T, window in ((0, 16, 4), (1, 4, 4), (1, 16, -1)):
        with pytest.raises(RuntimeError, match="launch failed"):
            fa.FLASH(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), None, 1, 16, T, 2, 1, 64, 1, causal,
                     0.125, fa.ROUTES["fma"], window, route="fma")
    assert fa.FLASH.launches == n


# the flash backward (csrc/flash_attention_bwd.cu) against its plain
# version in f64 on the same inputs (q, k, v, out, lse, dout): each row of
# dq, dk and dv within BWD_ROW_TOL of that row's largest |value| (bf16: the
# contract; f32: the kernels' f32 sums against exact ones), a row's largest
# value floored at BWD_ROW_FLOOR of the tensor's (the first query row under
# causal masking has an exact dq of 0: a softmax over one key)
BWD_ROW_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
BWD_ROW_FLOOR = 1e-2


def _bwd_case(seed, B, S, T, H, KV, hd, dtype, causal):
    """q, k, v, dout on the card; the kernel's out and lse (forward with
    lse); the plain backward in f64 on those inputs."""
    q, k, v = _attn(seed, B, S, T, H, KV, hd, dtype)
    dout = _attn(seed + 1, B, S, S, H, H, hd, dtype)[0]
    out, lse = fa._forward(q, k, v, causal, hd ** -0.5, want_lse=True)
    want = fa.flash_attention_bwd_plain(
        *(t.double() for t in (q, k, v, out, lse, dout)), causal=causal,
        scale=hd ** -0.5)
    return (q, k, v, dout, out, lse), want


def _grad_rows_ok(got, want, dtype):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        d = (g.double() - w).abs().amax(-1)
        m = w.abs().amax(-1).clamp_min(BWD_ROW_FLOOR * w.abs().max().item())
        err = (d / m.clamp_min(1e-300)).max().item()
        assert err <= BWD_ROW_TOL[dtype], (name, err)


# ragged S and T (one past a tile, one short of one, T past S and S past
# T; S 2 against T 3, whose first causal row has an exact dq of 0), H ==
# KV and GQA, B 2; hd 128 in bf16 takes the wgmma kernels, hd 32 / 64 the
# mma.sync ones, f32 the FMA ones
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,T,H,KV,hd", [
    (1, 2, 3, 1, 1, 32), (2, 65, 65, 4, 4, 32), (1, 100, 37, 4, 2, 64),
    (2, 37, 100, 6, 3, 64), (1, 257, 257, 32, 4, 128),
    (2, 129, 300, 8, 8, 128), (1, 300, 129, 16, 4, 128),
    (2, 256, 256, 8, 1, 128)])
def test_flash_backward_matches_plain(B, S, T, H, KV, hd, causal, dtype):
    _need_card()
    (q, k, v, dout, out, lse), want = _bwd_case(S + T + hd, B, S, T, H, KV,
                                                hd, dtype, causal)
    route = fa.flash_bwd_route(dtype, hd)
    n, nr = _route_launches(fa.FLASH_BWD, route)
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                 scale=hd ** -0.5)
    torch.cuda.synchronize()
    assert _route_launches(fa.FLASH_BWD, route) == (n + 1, nr + 1)
    _grad_rows_ok(got, want, dtype)
    # the lse the forward wrote is the rows' log-sum-exp
    _, l64 = fa.flash_attention_plain(*(t.double() for t in (q, k, v)),
                                      causal=causal, scale=hd ** -0.5,
                                      return_lse=True)
    assert (lse.double() - l64).abs().max().item() <= 1e-4


# the wgmma route (bf16, hd 128) around its tiles: 64-key (dK, dV) and
# 128-row (dQ) blocks over 64-row steps, so S and T of 1, 63, 127, 129 and
# 191, S < T and S > T, H == KV and G = 8, B 2.  A query row that sees one
# key only has an exact dq of 0 (a softmax over one key), so S 1 runs
# without the causal mask and T is never 1.
@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,KV,causal", [
    (1, 1, 129, 8, 8, False), (1, 63, 191, 32, 4, True),
    (1, 191, 63, 32, 4, True), (2, 127, 129, 8, 1, True),
    (2, 129, 127, 4, 4, False), (1, 191, 191, 16, 2, True),
    (2, 127, 63, 8, 8, False)])
def test_flash_backward_wgmma_route_on_ragged_tiles(B, S, T, H, KV, causal):
    _need_card()
    (q, k, v, dout, out, lse), want = _bwd_case(B + S + T, B, S, T, H, KV,
                                                128, torch.bfloat16, causal)
    n, nr = _route_launches(fa.FLASH_BWD, "wgmma")
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                 scale=128 ** -0.5)
    again = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                   scale=128 ** -0.5)
    torch.cuda.synchronize()
    assert _route_launches(fa.FLASH_BWD, "wgmma") == (n + 2, nr + 2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _grad_rows_ok(got, want, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 128),
                                      (torch.bfloat16, 64),
                                      (torch.float32, 64)])
def test_flash_backward_is_deterministic_and_lse_leaves_out_unchanged(dtype,
                                                                      hd):
    # two backward calls give the same bits (no atomics); the forward's
    # out is the same bits with and without its lse output
    _need_card()
    (q, k, v, dout, out, lse), _ = _bwd_case(9, 2, 300, 300, 8, 2, hd, dtype,
                                             True)
    a = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=True,
                               scale=hd ** -0.5)
    b = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=True,
                               scale=hd ** -0.5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for causal in (True, False):
        with_lse, _ = fa._forward(q, k, v, causal, hd ** -0.5, want_lse=True)
        without, none = fa._forward(q, k, v, causal, hd ** -0.5,
                                    want_lse=False)
        assert none is None and torch.equal(with_lse, without)
        assert torch.equal(without, fa.flash_attention(q, k, v, causal=causal,
                                                        scale=hd ** -0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_gradient_gradcheck_style_f32(causal):
    # at a tiny f32 shape, the gradient through the kernels (autograd on
    # the card) against autograd of the plain version in f64, and its
    # directional derivatives against central differences of the plain
    # f64 forward
    _need_card()
    q, k, v = _attn(11, 1, 5, 7, 2, 1, 32, torch.float32)
    dout = _attn(12, 1, 5, 5, 2, 2, 32, torch.float32)[0]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    n = fa.FLASH_BWD.launches
    got = torch.autograd.grad(
        fa.flash_attention(*leaves, causal=causal, scale=0.2), leaves, dout)
    assert fa.FLASH_BWD.launches == n + 1
    ref = [t.double().requires_grad_(True) for t in (q, k, v)]

    def f(*xs):
        return fa.flash_attention_plain(*xs, causal=causal, scale=0.2)

    want = torch.autograd.grad(f(*ref), ref, dout.double())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.double().cpu().numpy(),
                                   w.cpu().numpy(), rtol=1e-5, atol=1e-6)
    gen = torch.Generator(device="cuda").manual_seed(13)
    x64 = [t.double() for t in (q, k, v)]
    for i in range(3):
        u = torch.randn(x64[i].shape, generator=gen, device="cuda",
                        dtype=torch.float64)
        eps = 1e-6
        plus = [x + eps * u if j == i else x for j, x in enumerate(x64)]
        minus = [x - eps * u if j == i else x for j, x in enumerate(x64)]
        fd = ((f(*plus) - f(*minus)) * dout.double()).sum() / (2 * eps)
        np.testing.assert_allclose((got[i].double() * u).sum().item(),
                                   fd.item(), rtol=1e-5, atol=1e-6)


def _lora(seed, M, K, N, r, dtype):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(
        rng.standard_normal(shape, dtype=np.float32) * np.float32(0.1))
        .to("cuda", dtype) for shape in ((M, K), (K, N), (K, r), (r, N)))


# in bf16, K % 8 == 0 < K and N % 8 == 0 take the wgmma kernel (ragged M,
# N not a multiple of the 256-column tile, K not of the 64-deep slab, r
# over 16 ranks in several mma.sync steps), other shapes the mma.sync
# kernel; f32 the FMA kernel
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,r", [
    (100, 300, 200, 5), (128, 256, 128, 8), (256, 512, 256, 64), (1, 1, 1, 1),
    (65, 33, 70, 17), (3, 0, 5, 2), (7, 40, 9, 0), (512, 4096, 512, 16),
    (8191, 4096, 512, 16), (300, 1000, 264, 16), (1, 8, 8, 1),
    (129, 72, 520, 40), (200, 136, 4096, 0)])
def test_lora_matmul_kernel_matches_plain(M, K, N, r, dtype):
    _need_card()
    x, w, a, b = _lora(M + K + N + r, M, K, N, r, dtype)
    route = lm.lora_route(dtype, K, N)
    n, nr = _route_launches(lm.LORA_MATMUL, route)
    got = ops.lora_matmul(x, w, a, b, 2.0)
    torch.cuda.synchronize()
    assert _route_launches(lm.LORA_MATMUL, route) == (n + 1, nr + 1)
    want = lm.lora_matmul_plain(x, w, a, b, 2.0)
    assert got.dtype == dtype and got.shape == (M, N)
    tol = LORA_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_lora_matmul_kernel_validates_inputs():
    _need_card()
    x, w, a, b = _lora(1, 8, 16, 8, 2, torch.float32)
    with pytest.raises(TypeError, match="w is"):
        lm.lora_matmul(x, w.bfloat16(), a, b, 1.0)
    with pytest.raises(TypeError, match="bf16 or f32"):
        lm.lora_matmul(x.half(), w.half(), a.half(), b.half(), 1.0)
    with pytest.raises(ValueError, match="chain"):
        lm.lora_matmul(x, w, a, b.T, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 128, "mma_sync"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 128, "fma"), (torch.float32, 128, "wgmma"),
    (torch.float32, 64, "mma_sync"), (torch.bfloat16, 256, "mma_sync"),
    (torch.bfloat16, 256, "wgmma"), (torch.bfloat16, 128, "hd256"),
    (torch.float32, 256, "hd256")])
def test_flash_entry_point_refuses_a_route_the_shape_does_not_select(
        dtype, hd, route):
    # the route is a function of dtype and hd: the C entry point launches
    # no other kernel, whatever its caller asks for
    _need_card()
    q, k, v = _attn(6, 1, 64, 64, 2, 1, hd, dtype)
    out = torch.empty_like(q)
    n = fa.FLASH.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        fa.FLASH(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), None, 1, 64, 64, 2, 1, hd, fa.DTYPES[dtype],
                 1, hd ** -0.5, fa.ROUTES[route], 0, route=route)
    assert fa.FLASH.launches == n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,K,N,route", [
    (torch.bfloat16, 256, 256, "mma_sync"), (torch.bfloat16, 300, 256, "wgmma"),
    (torch.bfloat16, 256, 256, "fma"), (torch.float32, 256, 256, "wgmma"),
    (torch.float32, 300, 200, "mma_sync")])
def test_lora_entry_point_refuses_a_route_the_shape_does_not_select(
        dtype, K, N, route):
    _need_card()
    x, w, a, b = _lora(7, 64, K, N, 4, dtype)
    xa = lm.lora_xa(x, a)
    y = torch.empty(64, N, dtype=dtype, device="cuda")
    n = lm.LORA_MATMUL.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        lm.LORA_MATMUL(x.device, x.data_ptr(), w.data_ptr(), xa.data_ptr(),
                       b.data_ptr(), y.data_ptr(), 64, K, N, 4,
                       lm.LORA_DTYPES[dtype], 1.0, lm.LORA_ROUTES[route],
                       route=route)
    assert lm.LORA_MATMUL.launches == n


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 70001])
def test_ops_transport_wrappers_equal_their_plain_loops(n):
    _need_card()
    x, _ = _rows(n, 1, n)
    x = x[0]
    before = tm.THRESHOLD_COUNT.launches
    got = ops.histogram_threshold(x, 0.25, iters=20)
    assert tm.THRESHOLD_COUNT.launches == before + 20
    want = ops.histogram_threshold_plain(x, 0.25, iters=20)
    assert torch.equal(_bits(got.reshape(1)), _bits(want.reshape(1)))
    masked, nnz = ops.topk_mask(x, got)
    assert torch.equal(_bits(masked), _bits(ref.topk_mask_ref(x, got)))
    assert int(nnz) == int(ref.threshold_count_ref(x, got))


# the smoke config in f32 (hd 32: the FMA kernel), and in bf16 at Yi-9B's
# head size (hd 128, 32 / 4 heads: the wgmma kernel) and gemma-7b's (hd 256,
# MHA: the hd256 kernel; f32 the FMA kernel), with and without a sliding
# window, where the card's and the CPU's bf16 projections and the kernel's
# bf16 probabilities differ by a few bf16 steps: held to the bf16 attention
# tolerance of each output row's largest value
@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 20])
@pytest.mark.parametrize("dtype,hd,heads", [
    (torch.float32, None, None), (torch.bfloat16, 128, (32, 4)),
    (torch.bfloat16, 256, (4, 4)), (torch.bfloat16, 256, (8, 2)),
    (torch.float32, 256, (4, 4))])
def test_long_prompt_gqa_forward_runs_the_flash_kernel(dtype, hd, heads,
                                                       window):
    # at a lowered threshold the model's attention takes the kernel on the
    # card and chunked_attention on the CPU; both hold the chunk contract
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.models import attention as A
    from repro_torch.models.layers import init_params
    _need_card()
    cfg = dataclasses.replace(get_config("yi-9b", smoke=True),
                              chunked_attn_threshold=32, attn_chunk_q=16,
                              attn_chunk_kv=16)
    if hd is not None:
        cfg = dataclasses.replace(cfg, head_dim=hd, num_heads=heads[0],
                                  num_kv_heads=heads[1])
    params = {k: v.to(dtype) for k, v in
              init_params(A.gqa_spec(cfg), 0, device="cpu").items()}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 48, cfg.d_model), dtype=np.float32)).to(dtype)
    want = A.gqa_forward(params, x, cfg, window=window)
    cuda_params = {k: v.cuda() for k, v in params.items()}
    route = fa.flash_route(dtype, cfg.hd)
    n, nr = _route_launches(fa.FLASH, route)
    with torch.no_grad():
        got = A.gqa_forward(cuda_params, x.cuda(), cfg, window=window)
    assert _route_launches(fa.FLASH, route) == (n + 1, nr + 1)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5)
    else:
        d = (got.float().cpu() - want.float()).abs().amax(-1)
        assert (d / want.float().abs().amax(-1)).max().item() <= 2e-2
    with pytest.raises(ValueError, match="S % cq"):
        A.gqa_forward(cuda_params, x[:, :40].cuda(), cfg)


def _task_run(task, device, strategy, rounds, **spec):
    from repro_torch.federated import Experiment
    from repro_torch.models.config import FederatedConfig
    return (Experiment(task, federation=FederatedConfig(
                n_clients=4, local_steps=2, local_batch=4, client_lr=5e-3,
                server_lr=5e-3), device=device)
            .with_strategy(strategy, **spec)
            .with_model(d_model=32, num_layers=2, num_heads=4, d_ff=64)
            .with_lora(rank=4)
            .with_training(rounds=rounds, eval_every=1, pretrain_steps=3)
            .run())


@pytest.mark.cuda
def test_task_experiment_runs_the_transport_kernels_on_the_card():
    """`Experiment(task)` defaults to the card: pretraining, FLASC rounds and
    evaluation run there, each round launches the fused transport kernels
    (download mask 1, absmax 2, bin_counts 2, mask_quantize 1) and dense
    LoRA none.  (The CPU comparison is `test_pretrain_and_evaluate_stay_on_
    the_card`: weights drawn on the card differ from the CPU's.)"""
    _need_card()
    from repro_torch.data import make_synth_image
    task = make_synth_image(n_examples=128, n_clients=8, n_patches=6, dim=32,
                            n_eval=128, seed=1)
    fns = {"topk_mask": tm.TOPK_MASK, "absmax": ft.ABSMAX,
           "bin_counts": ft.BIN_COUNTS, "mask_quantize": ft.MASK_QUANTIZE,
           "threshold_count": tm.THRESHOLD_COUNT}
    per_round = {"topk_mask": 1, "absmax": 2, "bin_counts": 2,
                 "mask_quantize": 1, "threshold_count": 0}
    spec = dict(selector="fused", quant_bits_up=4)
    for f in fns.values():
        f.launches = 0
    res = _task_run(task, None, "flasc", 3, **spec)
    assert {k: f.launches for k, f in fns.items()} == \
        {k: 3 * v for k, v in per_round.items()}
    assert all(np.isfinite(h["loss"]) and 0.0 <= h["acc"] <= 1.0
               for h in res.history)
    for f in fns.values():
        f.launches = 0
    dense = _task_run(task, None, "lora", 2)
    assert all(f.launches == 0 for f in fns.values())
    assert res.ledger.up_coded_bytes < dense.ledger.up_coded_bytes


@pytest.mark.cuda
def test_pretrain_and_evaluate_stay_on_the_card():
    """`pretrain` and `evaluate` run on the params' device and agree with
    the CPU: the loss after 3 steps to rtol 1e-4, the accuracy up to
    near ties (at most 2 of 128 predictions)."""
    _need_card()
    from repro_torch.core import fedround as tfr
    from repro_torch.data import make_synth_text
    from repro_torch.federated import evaluate, model_for_task, pretrain
    from repro_torch.models import lora as tlora
    from repro_torch.models import model as TM
    from repro_torch.models.config import LoRAConfig
    from repro_torch.models.layers import init_params, tree_leaves
    task = make_synth_text(n_examples=64, n_clients=4, vocab=64, length=10,
                           n_eval=128, seed=2)
    cfg = model_for_task(task, d_model=32, num_layers=2, num_heads=4, d_ff=64)
    out = {}
    base = init_params(TM.model_spec(cfg), 0, device="cpu")
    lcfg = LoRAConfig(rank=4)
    lora0 = tlora.init_lora(cfg, lcfg, 1, device="cpu")
    for dev in ("cpu", "cuda"):
        params, loss = pretrain(_to(base, dev), cfg, task, 3, batch_size=8)
        assert all(p.device.type == dev for p in tree_leaves(params))
        tree = {"lora": _to(lora0, dev)}
        meta = tfr.FlatMeta.of(tree)
        acc = evaluate(params, cfg, tree, meta, task, lcfg.scale,
                       meta.flatten(tree))
        out[dev] = (loss, acc)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    assert abs(out["cuda"][1] - out["cpu"][1]) * 128 <= 2


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.cuda
def test_dropped_serving_engine_frees_its_weights():
    """With the cycle collector off, dropping a `ServingEngine` after a
    short trace frees its weights: `memory_allocated` falls back to where
    it was before the engine was built (a warm-up engine first, so lazy
    library workspaces are not counted)."""
    _need_card()
    import gc
    import weakref
    from repro_torch.launch import serve
    args = serve.parse_args(["--arch", "yi-9b", "--smoke", "--requests", "4"])

    def serve_once():
        eng, trace, _, _ = serve.build(args)
        rep = eng.run(trace)
        assert len(rep.completions) == rep.requests == len(trace)
        return weakref.ref(eng)

    serve_once()
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    gc.disable()
    try:
        ref_ = serve_once()
        torch.cuda.synchronize()
        assert ref_() is None, "the engine is held by a reference cycle"
        assert torch.cuda.memory_allocated() == before
    finally:
        gc.enable()


def _align_signs(q_ref, q):
    """Per-column signs that turn `q` into `q_ref` (QR is unique up to
    them)."""
    return torch.sign((q_ref * q).sum(-2, keepdim=True))


@pytest.mark.cuda
def test_two_stage_ortho_fold_on_the_card_matches_the_cpu():
    """`_ortho_lora_pairs` (cuSOLVER QR on the card, LAPACK on the CPU) on
    a stacked LoRA tree: Q orthonormal on the card, Q and R·B equal to the
    CPU's up to each column's sign, and every product A·B kept, to 1e-4."""
    _need_card()
    from repro_torch.core import strategies as st
    g = torch.Generator().manual_seed(3)
    tree = {"g0": {"attn": {k: {"a": torch.randn(12, 768, 16, generator=g),
                                "b": torch.randn(12, 16, 768, generator=g)
                                * 0.01} for k in ("wq", "wv")}}}
    cpu = st._ortho_lora_pairs(tree)
    gpu = st._ortho_lora_pairs(_to(tree, "cuda"))
    for k in ("wq", "wv"):
        (qc, rbc), (qg, rbg) = ((t["g0"]["attn"][k]["a"],
                                 t["g0"]["attn"][k]["b"]) for t in (cpu, gpu))
        qg, rbg = qg.cpu(), rbg.cpu()
        eye = torch.eye(16).expand(12, 16, 16)
        assert (qg.transpose(-1, -2) @ qg - eye).abs().max().item() < 1e-4
        s = _align_signs(qc, qg)
        assert (qg * s - qc).abs().max().item() < 1e-4
        assert (rbg * s.transpose(-1, -2) - rbc).abs().max().item() < 1e-4
        want = tree["g0"]["attn"][k]["a"] @ tree["g0"]["attn"][k]["b"]
        rel = (qg @ rbg - want).abs().max() / want.abs().max()
        assert rel.item() < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["random", "learned"])
def test_lowrank_stage_on_the_card_matches_the_cpu(mode, monkeypatch):
    """The `lowrank` stage on 8 rows of 30,000 (a 174 x 173 embedding),
    rank 8: the reconstruction on the card equals the CPU's to 1e-4
    relative per row (random mode with one Q injected on both devices:
    the devices' generators draw different numbers).  Each row is a rank-8
    matrix plus 1% noise, so the truncation has a spectral gap at the
    rank: on Gaussian rows sigma_8 and sigma_9 lie about 1% apart, and
    cuSOLVER's and LAPACK's f32 rank-8 subspaces differed there by 3.2e-4
    of the reconstruction.  The card's own projection is orthonormal, the
    same for the same seed and fold, and another for another fold."""
    _need_card()
    from repro_torch.core import transport as tp
    rows, cols = tp._factor_dims(30_000)
    g = torch.Generator().manual_seed(4)
    m = (torch.randn(8, rows, 8, generator=g)
         @ torch.randn(8, 8, cols, generator=g)
         + 0.01 * torch.randn(8, rows, cols, generator=g))
    x = m.reshape(8, -1)[:, :30_000].contiguous()
    stage = tp.LowRankCompress(rank=8, mode=mode, seed=2, fold=5)
    if mode == "random":
        q_card = stage._projection(cols, "cuda")
        eye = torch.eye(8, device="cuda")
        assert (q_card.T @ q_card - eye).abs().max().item() < 1e-5
        assert torch.equal(q_card, stage._projection(cols, "cuda"))
        other = tp.LowRankCompress(rank=8, seed=2, fold=6)
        assert not torch.allclose(q_card, other._projection(cols, "cuda"))
        q = q_card.cpu()
        monkeypatch.setattr(tp.LowRankCompress, "_projection",
                            lambda self, c, device: q.to(device))
    cpu = stage(tp.Message.dense(x))
    gpu = stage(tp.Message.dense(x.cuda()))
    assert gpu.values.is_cuda and torch.equal(gpu.nnz.cpu(), cpu.nnz)
    rel = ((gpu.values.cpu() - cpu.values).norm(dim=-1)
           / cpu.values.norm(dim=-1))
    assert rel.max().item() < 1e-4


@pytest.mark.cuda
def test_prefetcher_stages_one_pinned_copy_per_cohort():
    """Each cohort's rows reach the card as one copy from a pinned slab
    (two slabs, alternating), equal to the store's rows; an overlapping
    next cohort is gathered after the commit."""
    _need_card()
    from repro_torch.federated import population as popn
    rng = np.random.default_rng(0)
    store = popn.PopulationStore(population=1000, row_len=4099, chunk=3)
    store.scatter(np.arange(0, 1000, 7),
                  rng.standard_normal((143, 4099), dtype=np.float32))
    samp = popn.resolve_sampler("uniform", population=1000, cohort=8, seed=1)
    pre = popn.CohortPrefetcher(store, samp, "cuda")
    ids, rows = pre.take(0)
    assert pre.h2d_puts == 1 and rows.is_cuda
    assert all(s.is_pinned() for s in pre._slabs) and len(pre._slabs) == 2
    assert torch.equal(rows.cpu(), torch.from_numpy(store.gather(ids)))
    for r in range(1, 6):
        pre.prefetch(r, exclude=ids)
        store.scatter(ids, rows.cpu().numpy() + 1.0)    # round r-1's commit
        ids, rows = pre.take(r)
        assert pre.h2d_puts == r + 1
        assert torch.equal(rows.cpu(), torch.from_numpy(store.gather(ids)))
    everyone = popn.resolve_sampler("uniform", population=8, cohort=8)
    small = popn.PopulationStore(population=8, row_len=5, chunk=2)
    pre = popn.CohortPrefetcher(small, everyone, "cuda")
    ids, rows = pre.take(0)
    pre.prefetch(1, exclude=ids)            # the same 8 clients: deferred
    assert pre.h2d_puts == 1
    small.scatter(ids, np.ones((8, 5), np.float32))
    _, rows = pre.take(1)
    assert pre.h2d_puts == 2 and bool((rows == 1).all())


@pytest.mark.cuda
def test_population_prefetch_on_equals_off_on_the_card():
    _need_card()
    from repro_torch.data import make_synth_image
    from repro_torch.federated import Experiment
    task = make_synth_image(n_examples=128, n_clients=8, n_patches=4, dim=16,
                            seed=0, n_eval=128)
    flats = {}

    def run(prefetch):
        class Keep:
            def on_round_end(self, ev):
                flats[prefetch] = ev.state.flatP.clone()

            def on_eval(self, ev):
                pass
        exp = (Experiment(task, device="cuda")
               .with_strategy("flasc", selector="fused", quant_bits_up=4)
               .with_federation(n_clients=4, local_batch=4, local_steps=2)
               .with_model(d_model=16, num_layers=1, num_heads=2, d_ff=32)
               .with_lora(rank=4)
               .with_training(rounds=4, pretrain_steps=2, eval_every=2)
               .with_population(64, sampler="fraction", participation=0.5,
                                prefetch=prefetch)
               .with_callbacks(Keep()))
        res = exp.run()
        assert exp._population_bundle.last_prefetcher.h2d_puts == 4
        return [{k: v for k, v in h.items() if k != "phase_ms"}
                for h in res.history]
    assert run(True) == run(False)
    assert flats[True].is_cuda
    assert torch.equal(flats[True].view(torch.int32),
                       flats[False].view(torch.int32))
