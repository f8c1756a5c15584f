"""Public wrappers for the kernels, as `src/repro/kernels/ops.py` has them.

The same four functions with the same signatures and returns.  On CUDA
tensors each one always launches its hand-written kernel (the reference's
shape gates, which route untiled shapes to its oracles, are not carried
over: the CUDA kernels mask ragged tails).  On CPU tensors each one runs
the plain version of its kernel.

  - `topk_mask(x, threshold)` -> (masked, nnz): `kernels/topk_mask.py`.
  - `histogram_threshold(x, density, iters=24)`: the reference's bisection
    for the Top-K threshold, one `threshold_count` launch per step;
    `histogram_threshold_plain` is the same loop on `threshold_count_ref`.
  - `lora_matmul(x, w, a, b, scale)`: `kernels/lora_matmul.py`.
  - `flash_attention(q, k, v, causal=True)`: pre-broadcast K and V (one KV
    head per query head), scale 1/sqrt(hd): `kernels/flash_attention.py`.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lora_matmul as lm
from repro_torch.kernels import ref
from repro_torch.kernels import topk_mask as tm


def topk_mask(x: torch.Tensor, threshold):
    """Magnitude-threshold mask of a flat vector. Returns (masked, nnz)."""
    return tm.topk_mask(x, threshold)


def _bisect(x: torch.Tensor, density: float, iters: int,
            count: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]):
    """The reference's loop, op for op in f32: k = max(round(n density), 1),
    mid = 0.5 (lo + hi), move lo up while more than k entries survive."""
    n = x.shape[0]
    a = x.abs()
    k = torch.tensor(max(int(round(n * density)), 1), dtype=torch.float32,
                     device=x.device)
    hi = a.max()
    lo = torch.zeros_like(hi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        c = count(a, mid).to(torch.float32)
        lo = torch.where(c > k, mid, lo)
        hi = torch.where(c > k, hi, mid)
    return lo


def histogram_threshold(x: torch.Tensor, density: float, iters: int = 24):
    """Bisection Top-K threshold using the streaming count kernel."""
    return _bisect(x, density, iters, tm.threshold_count)


def histogram_threshold_plain(x: torch.Tensor, density: float,
                              iters: int = 24):
    """`histogram_threshold` counting with `ref.threshold_count_ref`."""
    return _bisect(x, density, iters, ref.threshold_count_ref)


def lora_matmul(x, w, a, b, scale: float):
    """Fused y = x @ w + scale * (x @ a) @ b."""
    return lm.lora_matmul(x, w, a, b, scale)


def flash_attention(q, k, v, causal: bool = True):
    """q (B, S, H, hd); k, v (B, T, H, hd) (kv heads pre-broadcast)."""
    return fa.flash_attention(q, k, v, causal=causal,
                              scale=1.0 / math.sqrt(q.shape[-1]))
