"""Global Top-K magnitude sparsification (the heart of FLASC).

The port of `src/repro/core/sparsity.py`: the two reference threshold
implementations and the masks built on them.

* exact: rank selection by a **stable** descending sort of |x|, so ties
  break by position as in the reference's `jnp.argsort(-|x|)`.
* histogram: fixed-depth bisection on |x|, `iters` count-compare halvings
  (`threshold_histogram_count`), whose `count_fn` hook lets the `pallas`
  selector swap in the CUDA count pass without touching the float math.

Every function takes a vector (n,) or a batch of rows (..., n); each row is
selected independently, with its own count.  Keep counts are int32 tensors
on the vector's device, so nothing here syncs with the host.

Keep-count contract (clamped in ONE place, `clamp_count`): `k` is clipped
to [0, n]; `k == 0` keeps nothing on every selector; `k == n` keeps every
entry the selector can keep (the histogram family never keeps exact zeros:
its mask is `|x| >= max(thr, TINY)`).  Density-based entry points keep at
least one entry (`k = max(round(n*d), 1)`).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

# smallest normal f32: the threshold floor that keeps exact zeros out of
# histogram-family masks.  (The reference needs a normal literal because
# XLA's CPU flushes subnormals to zero; CUDA and torch's CPU do not, but
# the floor is part of the mask's contract either way.)
TINY = float(np.finfo(np.float32).tiny)


def clamp_count(k, n: int, device=None) -> torch.Tensor:
    """THE keep-count contract: int32 `k` clipped to [0, n], as a tensor on
    `device` (a tensor `k` stays where it is)."""
    if isinstance(k, torch.Tensor):
        return k.to(torch.int32).clamp(0, n)
    return torch.full((), min(max(int(k), 0), n), dtype=torch.int32,
                      device=device)


def density_count(n: int, density: float) -> int:
    """Static density -> keep-count: the whole vector at density >= 1,
    otherwise `max(round(n*density), 1)`."""
    if density >= 1.0:
        return n
    return max(int(round(n * density)), 1)


def _count_guard(mask: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """k == 0 keeps nothing (the bisection cannot express an empty keep-set:
    its threshold converges to the max and still keeps the argmax)."""
    keep = k > 0
    return mask & (keep[..., None] if keep.ndim else keep)


def threshold_exact(flat_abs: torch.Tensor, density: float) -> torch.Tensor:
    """|x| threshold keeping ~density fraction per row."""
    n = flat_abs.shape[-1]
    k = density_count(n, density)
    if k >= n:
        return torch.zeros(flat_abs.shape[:-1], dtype=flat_abs.dtype,
                           device=flat_abs.device)
    return torch.sort(flat_abs, dim=-1).values[..., n - k]


def threshold_histogram(flat_abs: torch.Tensor, density: float,
                        iters: int = 24) -> torch.Tensor:
    """Bisection threshold: keep-fraction(|x| >= t) ~= density."""
    k = density_count(flat_abs.shape[-1], density)
    return threshold_histogram_count(flat_abs, k, iters)


def threshold_histogram_count(flat_abs: torch.Tensor, k, iters: int = 24,
                              count_fn: Optional[Callable] = None
                              ) -> torch.Tensor:
    """Bisection threshold keeping ~k entries per row; `k` is an int or an
    int32 tensor, scalar or one per row.

    The canonical loop shared by the `histogram` and `pallas` selectors:
    `count_fn(mid) -> int32 count of |x| >= mid` (per row) swaps the torch
    count for the CUDA count pass (`kernels/topk_mask.threshold_count`)
    without touching the lo/hi float math.  Returns `lo`, the largest
    probed threshold whose count exceeds k."""
    k = clamp_count(k, flat_abs.shape[-1], flat_abs.device)
    if count_fn is None:
        def count_fn(mid):
            return (flat_abs >= mid[..., None]).sum(-1, dtype=torch.int32)
    hi = flat_abs.amax(-1)
    lo = torch.zeros_like(hi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        up = count_fn(mid) > k              # too many kept -> raise threshold
        lo = torch.where(up, mid, lo)
        hi = torch.where(up, hi, mid)
    return lo


def _rank_mask(a: torch.Tensor, k) -> torch.Tensor:
    """The first k entries of the stable descending |x| order, per row."""
    order = torch.argsort(-a, dim=-1, stable=True)      # descending by |x|
    if isinstance(k, torch.Tensor) and k.ndim:
        k = k[..., None]                                 # one count per row
    keep = torch.arange(a.shape[-1], device=a.device) < k
    return torch.zeros(a.shape, dtype=torch.bool, device=a.device).scatter_(
        -1, order, keep.expand(a.shape))


def topk_mask(flat: torch.Tensor, density: float, *, exact: bool = True,
              iters: int = 24) -> torch.Tensor:
    """Boolean mask of the top `density` fraction by |x| per row.

    exact=True selects exactly k entries by rank (ties broken by position).
    exact=False uses the histogram threshold (approximately k, never
    rank-inverted)."""
    if density >= 1.0:
        return torch.ones_like(flat, dtype=torch.bool)
    a = flat.float().abs()
    if exact:
        return _rank_mask(a, density_count(a.shape[-1], density))
    thr = threshold_histogram(a, density, iters)
    return a >= torch.clamp_min(thr, TINY)[..., None]


def topk_mask_by_count(flat: torch.Tensor, k, *, exact: bool = True,
                       iters: int = 24) -> torch.Tensor:
    """`topk_mask` with a keep-count `k` (int, or int32 tensor: scalar or
    one per row).  The exact form equals `topk_mask(exact=True)` when `k`
    is the static count; both honor `clamp_count` (k = 0 keeps nothing)."""
    a = flat.float().abs()
    k = clamp_count(k, a.shape[-1], a.device)
    if exact:
        return _rank_mask(a, k)
    thr = threshold_histogram_count(a, k, iters)
    return _count_guard(a >= torch.clamp_min(thr, TINY)[..., None], k)


def sparsify(flat: torch.Tensor, density: float, *, exact: bool = True
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (masked vector, int32 nnz per row)."""
    m = topk_mask(flat, density, exact=exact)
    return apply_mask(flat, m), m.sum(-1, dtype=torch.int32)


def sparsify_by_count(flat: torch.Tensor, k, *, exact: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`sparsify` with a keep-count (see `topk_mask_by_count`)."""
    m = topk_mask_by_count(flat, k, exact=exact)
    return apply_mask(flat, m), m.sum(-1, dtype=torch.int32)


def apply_mask(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """`values * mask` for a boolean mask as the reference computes it
    under jit (XLA rewrites a multiply by a converted predicate into a
    select): masked-out entries are +0.0, never -0.0."""
    if mask.dtype != torch.bool:
        return values * mask
    return torch.where(mask, values, torch.zeros((), dtype=values.dtype,
                                                 device=values.device))


def density_of(flat: torch.Tensor) -> torch.Tensor:
    return (flat != 0).float().mean(-1)
