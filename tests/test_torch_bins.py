"""The search of the `bin_counts` kernel (csrc/transport.cu,
`bin_partial_kernel<L>`), transcribed into plain torch and held BITWISE to
the bisection replay it replaces, on the CPU.

The kernel's algorithm, step for step (`table_leaves` below):
  1. the edge table: the tree's 2^L - 1 midpoints in order, built level by
     level from edge[0] = 0 and edge[2^L] = hi0 with the replay's own ops;
  2. the guess g = floor(|x| * (2^L / hi0)), clamped, taken as it is where
     hi0 lies in [2^-100, 2^126] and the guess lies more than
     (L + 4) * 2^(L-24) of a bin from a grid line;
  3. else the check edge[g] <= |x| < edge[g + 1], one bin's correction
     toward the side that failed and the check again, where hi0 is not
     negative (the table is sorted);
  4. else the walk down the table: the replay with its mids read, not
     recomputed.
Every row kind of tests/_bin_rows.py goes through it at L in {1, 7, 12}
against `bisection_bins` (the port's plain version, itself held to the
reference's Pallas kernel in tests/test_torch_transport.py), and, for the
kinds XLA's CPU computes as IEEE does (it flushes denormals), against the
reference's `bin_counts_pallas` in interpret mode directly.
"""
import _torch_threads  # noqa: F401  (this process's share of the cores)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _bin_rows import KINDS, XLA_KINDS, bin_rows, edge_table
from repro.kernels import fused_transport as jft
from repro_torch.kernels import fused_transport as tft

N = 65_536


def table_leaves(a: torch.Tensor, hi0: torch.Tensor, levels: int):
    """(B, n) |x| and (B,) hi0 -> ((B, n) int64 leaves, {path: elements
    that ended there}), by the kernel's steps with its f32 ops."""
    top = (1 << levels) - 1
    eps = (levels + 4) * 2.0 ** (levels - 24)       # exact in f32
    edge = torch.from_numpy(edge_table(hi0.numpy(), levels))
    scale = torch.tensor(float(1 << levels), dtype=torch.float32) / hi0
    q = a * scale[:, None]
    m = torch.floor(q)
    f = q - m
    g = torch.where(torch.isnan(m), 0.0, m).clamp(0, top).long()  # fmaxf
    guess_ok = ((hi0 >= 2.0 ** -100) & (hi0 <= 2.0 ** 126))[:, None]
    fast = guess_ok & ((m == 0) | (f >= eps)) & ((m >= top) | (f <= 1 - eps))

    def check(g):
        lo_ok = (g == 0) | (edge.gather(1, g) <= a)
        hi_ok = (g == top) | (a < edge.gather(1, g + 1))
        return lo_ok, hi_ok

    lo_ok, hi_ok = check(g)
    g2 = torch.where(lo_ok != hi_ok, g + torch.where(lo_ok, 1, -1), g)
    lo_ok, hi_ok = check(g2)
    checked = ~(hi0 < 0)[:, None] & lo_ok & hi_ok

    pos = torch.full(a.shape, 1 << (levels - 1), dtype=torch.int64)
    walk = torch.zeros(a.shape, dtype=torch.int64)
    for d in range(levels):
        up = a >= edge.gather(1, pos)
        walk = 2 * walk + up
        half = (1 << levels) >> (d + 2)
        pos = pos + torch.where(up, half, -half)

    leaves = torch.where(fast, g, torch.where(checked, g2, walk))
    paths = {"guess": int(fast.sum()), "check": int((~fast & checked).sum()),
             "walk": int((~fast & ~checked).sum())}
    return leaves, paths


def _rows(kind, levels, B=2, n=N):
    x, hi0 = bin_rows(kind, B, n, levels, seed=levels * 31 + KINDS.index(kind))
    return torch.from_numpy(x).abs(), torch.from_numpy(hi0)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("levels", [1, 7, 12])
def test_edge_search_matches_bisection_bitwise(levels, kind):
    a, hi0 = _rows(kind, levels)
    got, paths = table_leaves(a, hi0, levels)
    want = tft.bisection_bins(a, hi0, levels)
    assert torch.equal(got, want), paths
    assert sum(paths.values()) == a.numel()
    # the table is sorted where hi0 is not negative (NaN compares unordered)
    edge = torch.from_numpy(edge_table(hi0.numpy(), levels))[:, 1:-1]
    assert not bool((edge[:, 1:] < edge[:, :-1]).any()) or kind == "neg_hi0"
    # each kind reaches the paths the design sends it down
    if kind in ("denormal", "huge", "inf_hi0", "nan_hi0", "neg_hi0", "zeros"):
        assert paths["guess"] == 0, paths        # hi0 outside [2^-100, 2^126]
    if kind in ("neg_hi0", "nan_hi0"):
        assert paths["check"] == 0, paths
    if kind == "normal" and levels == 12:
        assert paths["guess"] > 0.98 * a.numel(), paths
    if kind == "edges":
        assert paths["check"] > 0, paths
    if kind in ("nan", "nan_hi0", "neg_hi0"):
        assert paths["walk"] > 0, paths


@pytest.fixture(scope="module")
def pallas_bins():
    """The reference's bin_counts_pallas in interpret mode, one row."""
    def run(a, hi0, levels):
        return np.asarray(jft.bin_counts_pallas(
            jnp.asarray(a), jnp.asarray(hi0), levels, block=1024,
            interpret=True))
    return run


@pytest.mark.parametrize("kind", XLA_KINDS)
@pytest.mark.parametrize("levels", [1, 7, 12])
def test_edge_search_matches_pallas_bitwise(pallas_bins, levels, kind):
    a, hi0 = _rows(kind, levels, B=1, n=4096)
    got, _ = table_leaves(a, hi0, levels)
    hist = torch.zeros(1 << levels, dtype=torch.int32).scatter_add_(
        0, got[0], torch.ones(a.shape[1], dtype=torch.int32))
    np.testing.assert_array_equal(
        hist.numpy(), pallas_bins(a[0].numpy(), hi0[0].numpy(), levels))
    assert torch.equal(hist, tft.bin_counts(a, hi0, levels)[0])
