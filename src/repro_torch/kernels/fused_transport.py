"""One-pass transport: absmax, bisection-path bins, fused mask + quantize.

The three streaming passes of the `fused` selector and the
`fused_topk_quantize` stage (`src/repro/kernels/fused_transport.py`):

  pass 1  `absmax`              max |x| per row: `hi0`, the bisection's
                                upper bound and the quantizer's scale
                                numerator.  Replaces `absmax_pallas`.
  pass 2  `bin_counts`          every element replays the `levels`-step
                                bisection path `mid = 0.5 * (lo + hi)` from
                                (0, hi0) against its own |x| and is counted
                                in the 2^levels-bin histogram of its leaf.
                                Replaces `bin_counts_pallas`.
          `threshold_from_bins` replays the canonical bisection over bin
                                suffix sums: bit-identical to
                                `sparsity.threshold_histogram_count(iters=
                                levels)`.  Plain torch on (B, 2^L) bins, on
                                the device; not a kernel.
  pass 3  `fused_mask_quantize` mask at the threshold, quantize the
                                survivors (the float ops of
                                `quantization.quantize`), count them.
                                Replaces `fused_mask_quantize_pallas`.

All three kernels live in `csrc/transport.cu`.  Inputs are (n,) or (B, n)
f32, one row per message, with per-row thresholds, bounds and scales, and
a (B, n) input runs as ONE launch.  On CUDA tensors each wrapper launches
its kernel or raises; on CPU tensors it runs its plain PyTorch version
(`*_plain`).  The CUDA kernel masks the ragged tail where the Pallas
kernel pads with zeros into bin 0; `threshold_from_bins` never reads bin 0
(every probe index is >= 1), so thresholds agree either way.

The pack and sparse-accumulate functions of the reference module
(`fused_mask_quantize_pack_pallas`, `pack_values_batched_pallas`,
`sparse_accumulate`) are not ported yet (ROADMAP, slice 3).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import CudaFunction
from repro_torch.kernels.topk_mask import as_rows, check_cuda, per_row

LEVELS = 12          # default bisection depth: 2^12 magnitude bins (16 KiB)
MAX_LEVELS = 12      # the CUDA kernel's shared histogram holds up to 2^12 bins

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

ABSMAX = CudaFunction("transport", "absmax_f32", [_P, _P, _LL, _I])
BIN_COUNTS = CudaFunction("transport", "bin_counts_f32",
                          [_P, _P, _P, _LL, _I, _I])
MASK_QUANTIZE = CudaFunction("transport", "mask_quantize_f32",
                             [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I])


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def absmax_plain(x: torch.Tensor) -> torch.Tensor:
    """(B, n) -> (B,) max |x|."""
    return x.abs().amax(-1)


def bisection_bins(a: torch.Tensor, hi0: torch.Tensor,
                   levels: int) -> torch.Tensor:
    """(B, n) |x| -> (B, n) int64 leaf index of each element's `levels`-step
    bisection path from (0, hi0[b]) (the reference's `_bin_kernel`)."""
    lo = torch.zeros_like(a)
    hi = hi0[:, None].expand_as(a)
    idx = torch.zeros(a.shape, dtype=torch.int64, device=a.device)
    for _ in range(levels):
        mid = 0.5 * (lo + hi)
        up = a >= mid
        idx = idx * 2 + up
        lo = torch.where(up, mid, lo)
        hi = torch.where(up, hi, mid)
    return idx


def bin_counts_plain(x: torch.Tensor, hi0: torch.Tensor,
                     levels: int) -> torch.Tensor:
    """(B, n), (B,) -> (B, 2^levels) int32 histogram of bisection leaves."""
    idx = bisection_bins(x.abs(), hi0, levels)
    hist = torch.zeros((x.shape[0], 1 << levels), dtype=torch.int32,
                       device=x.device)
    return hist.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))


def quantized(x: torch.Tensor, u: Optional[torch.Tensor], bits: int,
              scale: torch.Tensor) -> torch.Tensor:
    """The reference's `_quantized`: y = x / scale, floor(y + u) or round
    (half to even), clip to [-qmax - 1, qmax], rescale.  scale (B,)."""
    qmax = float(2 ** (bits - 1) - 1)
    s = scale[:, None]
    y = x / s
    y = torch.floor(y + u) if u is not None else torch.round(y)
    return torch.clamp(y, -qmax - 1.0, qmax) * s


def fused_mask_quantize_plain(x, t, scale, u, bits: int):
    """(B, n) x, (B,) t and scale, (B, n) u or None -> (masked quantized
    survivors, (B,) int32 count)."""
    keep = x.abs() >= t[:, None]
    q = quantized(x, u, bits, scale) if bits else x
    return torch.where(keep, q, 0.0), keep.sum(-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def absmax(x: torch.Tensor) -> torch.Tensor:
    """max |x| per row: () for (n,), (B,) for (B, n).  Bitwise equal to
    `x.abs().amax(-1)` (a max is order-free)."""
    x2, lead = as_rows(x)
    if not x2.is_cuda:
        return absmax_plain(x2).reshape(lead)
    check_cuda("absmax", x=x2)
    B, n = x2.shape
    out = torch.zeros(B, dtype=torch.float32, device=x2.device)
    if n:
        ABSMAX(x2.device, x2.data_ptr(), out.data_ptr(), n, B)
    return out.reshape(lead)


def bin_counts(x: torch.Tensor, hi0, levels: int = LEVELS) -> torch.Tensor:
    """(..., 2^levels) int32 histogram of bisection-path leaves of |x| per
    row, the path starting from (0, hi0)."""
    if not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"levels must be in [1, {MAX_LEVELS}], got {levels}")
    x2, lead = as_rows(x)
    h = per_row(hi0, x2.shape[0], x2, torch.float32, "hi0")
    if not x2.is_cuda:
        return bin_counts_plain(x2, h, levels).reshape(lead + (1 << levels,))
    check_cuda("bin_counts", x=x2, hi0=h)
    B, n = x2.shape
    hist = torch.zeros((B, 1 << levels), dtype=torch.int32, device=x2.device)
    if n:
        BIN_COUNTS(x2.device, x2.data_ptr(), h.data_ptr(), hist.data_ptr(), n,
                   B, levels)
    return hist.reshape(lead + (1 << levels,))


def threshold_from_bins(hist: torch.Tensor, hi0: torch.Tensor, k,
                        levels: int = LEVELS) -> torch.Tensor:
    """Replay the canonical bisection over the bin histogram (..., 2^L).

    Carries (lo, hi, node prefix p) per row; step d's probe count is the
    suffix sum of bins >= (2p + 1) << (L - 1 - d), exactly the count
    `sparsity.threshold_histogram_count` gets from a streaming pass, and
    lo/hi update with the same float ops, so the threshold is
    bit-identical to `threshold_histogram_count(|x|, k, iters=levels)`.
    `k` (int32, () or per row) must already honor `clamp_count`.  Plain
    torch on the histogram's device; no host sync."""
    if hist.shape[-1] != 1 << levels:
        raise ValueError(f"histogram of {hist.shape[-1]} bins for {levels} "
                         "levels")
    lead = tuple(hist.shape[:-1])
    h2 = hist.reshape(-1, 1 << levels)
    B = h2.shape[0]
    suffix = torch.flip(torch.cumsum(torch.flip(h2, (-1,)), -1,
                                     dtype=torch.int32), (-1,))
    kk = per_row(k, B, h2, torch.int32, "k")
    hi = per_row(hi0, B, h2, torch.float32, "hi0")
    lo = torch.zeros_like(hi)
    p = torch.zeros(B, dtype=torch.int64, device=h2.device)
    for d in range(levels):
        mid = 0.5 * (lo + hi)
        probe = (2 * p + 1) << (levels - 1 - d)
        cnt = suffix.gather(1, probe[:, None])[:, 0]
        up = cnt > kk
        lo = torch.where(up, mid, lo)
        hi = torch.where(up, hi, mid)
        p = 2 * p + up
    return lo.reshape(lead)


def fused_mask_quantize(x: torch.Tensor, threshold, scale,
                        u: Optional[torch.Tensor], bits: int):
    """Mask at `threshold`, quantize the survivors at `scale` to `bits`
    bits, count them: one streaming pass.  `u` is the stochastic-rounding
    uniform draw shaped like x (None = round to nearest, half to even);
    bits == 0 is mask and count only.  Returns (values, int32 count)."""
    if bits < 0 or bits == 1 or bits > 8:
        raise ValueError(f"bits must be 0 or in [2, 8], got {bits}")
    x2, lead = as_rows(x)
    B = x2.shape[0]
    t = per_row(threshold, B, x2, torch.float32, "threshold")
    s = per_row(scale, B, x2, torch.float32, "scale")
    u2 = None
    if bits and u is not None:
        if tuple(u.shape) != tuple(x.shape):
            raise ValueError(f"u {tuple(u.shape)} must be shaped like x "
                             f"{tuple(x.shape)}")
        u2 = u.reshape(x2.shape)
    if not x2.is_cuda:
        out, cnt = fused_mask_quantize_plain(x2, t, s, u2, bits)
        return out.reshape(x.shape), cnt.reshape(lead)
    tensors = dict(x=x2, threshold=t, scale=s)
    if u2 is not None:
        tensors["u"] = u2
    check_cuda("fused_mask_quantize", **tensors)
    n = x2.shape[1]
    out = torch.empty_like(x2)
    cnt = torch.zeros(B, dtype=torch.int32, device=x2.device)
    if n:
        MASK_QUANTIZE(x2.device, x2.data_ptr(),
                      None if u2 is None else u2.data_ptr(), t.data_ptr(),
                      s.data_ptr(), out.data_ptr(), cnt.data_ptr(), n, B, bits,
                      int(u2 is not None))
    return out.reshape(x.shape), cnt.reshape(lead)
