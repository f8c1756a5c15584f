"""Rows for the bisection-bin search (`bin_counts`), from a seed, in numpy.

The kernel of `bin_counts` finds each |x|'s leaf by a guess, a check
against the sorted table of the tree's midpoints and, failing both, a walk
down that table.  These rows reach every one of those paths: ordinary
draws, ties, zeros, a denormal row, a row whose lo + hi overflows, an
infinite, a NaN and a negative hi0, NaN elements, magnitudes spanning sixty
decades, and elements on and beside the table's edges.  Shared by the CPU
test of the search (tests/test_torch_bins.py), the card's tests
(tests/test_torch_cuda.py) and `chip_smoke.py`; it imports neither jax nor
torch.
"""
import numpy as np

KINDS = ("normal", "ties", "zeros", "denormal", "huge", "inf_hi0", "nan",
         "nan_hi0", "neg_hi0", "decades", "edges")
# the kinds XLA's CPU runs as the card does (it flushes denormals to zero)
XLA_KINDS = tuple(k for k in KINDS if k != "denormal")


def edge_table(hi0: np.ndarray, levels: int) -> np.ndarray:
    """(B,) hi0 -> (B, 2^levels + 1) f32: edge[0] = 0, edge[2^levels] =
    hi0, and edge[j] the midpoint of bisection node j in order, level by
    level: node j at depth d (span s = 2^(levels-1-d)) is
    0.5 * (edge[j - s] + edge[j + s]), the replay's own operands."""
    hi0 = np.asarray(hi0, np.float32)
    edge = np.zeros((hi0.shape[0], (1 << levels) + 1), np.float32)
    edge[:, -1] = hi0
    with np.errstate(over="ignore", invalid="ignore"):
        for d in range(levels):
            s = 1 << (levels - 1 - d)
            j = np.arange(1 << d) * 2 * s + s
            edge[:, j] = np.float32(0.5) * (edge[:, j - s] + edge[:, j + s])
    return edge


def bin_rows(kind: str, B: int, n: int, levels: int, seed: int):
    """(x (B, n) f32, hi0 (B,) f32) of one kind.  hi0 is max |x| per row,
    NaN elements left out, except for the nan_hi0 and neg_hi0 kinds."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, n), dtype=np.float32)
    sign = np.where(rng.random((B, n)) < 0.5, np.float32(-1), np.float32(1))
    hi0 = None
    if kind == "ties":
        x = rng.integers(-3, 4, (B, n)).astype(np.float32) * np.float32(0.5)
    elif kind == "zeros":
        x = np.zeros((B, n), np.float32)
    elif kind == "denormal":        # hi0 about 4e-42: every mid denormal
        x = x * np.float32(1e-42)
    elif kind == "huge":            # hi0 = 3.4e38: lo + hi overflows to inf
        x = x / np.abs(x).max(axis=1, keepdims=True) * np.float32(3.4e38)
    elif kind == "inf_hi0":
        x[:, ::97] = sign[:, ::97] * np.float32(np.inf)
    elif kind == "nan":
        x[:, 5::89] = np.float32(np.nan)
    elif kind == "nan_hi0":
        hi0 = np.full(B, np.nan, np.float32)
    elif kind == "neg_hi0":         # not an absmax: the table is not sorted
        hi0 = -np.abs(x).max(axis=1)
    elif kind == "decades":
        x = sign * (np.float32(10.0) ** rng.uniform(-30, 30, (B, n))
                    ).astype(np.float32)
    elif kind == "edges":           # on an edge, or one ulp either side
        top = np.abs(x).max(axis=1)
        edge = edge_table(top, levels)
        j = rng.integers(1, 1 << levels, (B, n))
        e = np.take_along_axis(edge, j, axis=1)
        step = rng.integers(0, 3, (B, n))
        e = np.where(step == 1, np.nextafter(e, np.float32(0)), e)
        e = np.where(step == 2, np.nextafter(e, np.float32(np.inf)), e)
        x = sign * e
        x[:, 0] = top
        hi0 = top
    elif kind != "normal":
        raise ValueError(f"unknown row kind {kind!r}")
    if hi0 is None:
        hi0 = np.nanmax(np.abs(x), axis=1) if kind == "nan" else \
            np.abs(x).max(axis=1)
    return np.ascontiguousarray(x, np.float32), np.asarray(hi0, np.float32)
