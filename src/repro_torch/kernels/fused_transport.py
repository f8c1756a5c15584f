"""One-pass transport: absmax, bisection-path bins, fused mask + quantize.

The three streaming passes of the `fused` selector and the
`fused_topk_quantize` stage (`src/repro/kernels/fused_transport.py`):

  pass 1  `absmax`              max |x| per row: `hi0`, the bisection's
                                upper bound and the quantizer's scale
                                numerator.  Replaces `absmax_pallas`.
  pass 2  `bin_counts`          the 2^levels-bin histogram of the leaf each
                                |x| reaches on the `levels`-step bisection
                                path `mid = 0.5 * (lo + hi)` from (0, hi0).
                                The plain version replays the path; the
                                kernel searches the sorted table of the
                                tree's midpoints, to the same leaf.
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

          `fused_mask_quantize_pack` pass 3 that also packs the coded
                                wire form: ascending survivor indices and
                                values in a (cap,) buffer.  Replaces
                                `fused_mask_quantize_pack_pallas`.

The codec and the server side (`pack_values`, `unpack_values`,
`sparse_accumulate`, `hierarchical_accumulate`) and the engines' batched
cohort pack `pack_values_batch`, which replaces
`pack_values_batched_pallas`.

All kernels live in `csrc/transport.cu`.  Inputs are (n,) or (B, n) f32,
one row per message, with per-row thresholds, bounds and scales, and a
(B, n) input runs as ONE launch.  On CUDA tensors each wrapper launches
its kernel or raises; on CPU tensors it runs its plain PyTorch version
(`*_plain`).  The CUDA kernels mask the ragged tail where the Pallas
kernels pad with zeros: pad zeros land in bin 0, which
`threshold_from_bins` never reads (every probe index is >= 1), and a
packed buffer's empty slots hold the unpadded length `n` directly.
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
                          [_P, _P, _P, _P, _LL, _I, _I])
BIN_PARTS = 132      # partial histograms a row of bin_counts keeps (csrc)
MASK_QUANTIZE = CudaFunction("transport", "mask_quantize_f32",
                             [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I])
MASK_QUANTIZE_PACK = CudaFunction(
    "transport", "mask_quantize_pack_f32",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I])
PACK_BATCH = CudaFunction("transport", "pack_batch_f32",
                          [_P, _P, _P, _P, _P, _LL, _I, _I, _I])
PACK_TILE = 4096     # elements per tile of the pack kernels (csrc)


def pack_batch_scratch_words(B: int, n: int) -> int:
    """64-bit words of the scratch of both pack kernels (`pack_batch_f32`,
    `mask_quantize_pack_f32`): a ticket per row and a status word per tile,
    one to a 128-byte line (csrc zeroes them on the stream)."""
    return B * (16 * -(-n // PACK_TILE) + 1)


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


def pack_rows_plain(values: torch.Tensor, keep: torch.Tensor, cap: int,
                    sentinel: int):
    """(B, n) values and keep mask -> (idx (B, cap) int32, val (B, cap) f32,
    nnz (B,) int32), each row on its own.  A survivor goes to slot
    `cumsum(keep) - 1`; slots past `cap` are dropped but still counted in
    nnz (nnz > cap flags overflow); empty slots hold (sentinel, 0.0)."""
    B, n = values.shape
    dev = values.device
    kept = keep.to(torch.int32)
    pos = torch.cumsum(kept, -1, dtype=torch.int32) - 1
    # slot `cap` of a (cap + 1)-wide buffer takes every dropped entry
    pos = torch.where(keep, pos, cap).clamp_max(cap).long()
    src = torch.arange(n, dtype=torch.int32, device=dev).expand(B, n)
    idx = torch.full((B, cap + 1), sentinel, dtype=torch.int32, device=dev)
    val = torch.zeros((B, cap + 1), dtype=torch.float32, device=dev)
    idx.scatter_(1, pos, src)
    val.scatter_(1, pos, values.float())
    return (idx[:, :cap].contiguous(), val[:, :cap].contiguous(),
            kept.sum(-1, dtype=torch.int32))


def fused_mask_quantize_pack_plain(x, t, scale, u, bits: int, cap: int,
                                   sentinel: int):
    """`fused_mask_quantize_plain` plus the pack of its survivors: the keep
    rule is the threshold mask |x| >= t, so a survivor that quantized to
    zero still takes a slot (with value 0).  -> (masked, idx, val, count)."""
    out, cnt = fused_mask_quantize_plain(x, t, scale, u, bits)
    idx, val, _ = pack_rows_plain(out, x.abs() >= t[:, None], cap, sentinel)
    return out, idx, val, cnt


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
    if not n:
        return torch.zeros(lead + (1 << levels,), dtype=torch.int32,
                           device=x2.device)
    hist = torch.empty((B, 1 << levels), dtype=torch.int32, device=x2.device)
    parts = torch.empty(B * BIN_PARTS << levels, dtype=torch.int32,
                        device=x2.device)
    BIN_COUNTS(x2.device, x2.data_ptr(), h.data_ptr(), hist.data_ptr(),
               parts.data_ptr(), n, B, levels)
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


def _mask_quantize_args(kernel: str, x: torch.Tensor, threshold, scale,
                        u: Optional[torch.Tensor], bits: int):
    """The checked operands of the mask + quantize passes: (x2 (B, n),
    leading shape, per-row threshold and scale, u2 (B, n) or None)."""
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
    if x2.is_cuda:
        tensors = dict(x=x2, threshold=t, scale=s)
        if u2 is not None:
            tensors["u"] = u2
        check_cuda(kernel, **tensors)
    return x2, lead, t, s, u2


def fused_mask_quantize(x: torch.Tensor, threshold, scale,
                        u: Optional[torch.Tensor], bits: int):
    """Mask at `threshold`, quantize the survivors at `scale` to `bits`
    bits, count them: one streaming pass.  `u` is the stochastic-rounding
    uniform draw shaped like x (None = round to nearest, half to even);
    bits == 0 is mask and count only.  Returns (values, int32 count)."""
    x2, lead, t, s, u2 = _mask_quantize_args("fused_mask_quantize", x,
                                             threshold, scale, u, bits)
    if not x2.is_cuda:
        out, cnt = fused_mask_quantize_plain(x2, t, s, u2, bits)
        return out.reshape(x.shape), cnt.reshape(lead)
    B, n = x2.shape
    out = torch.empty_like(x2)
    cnt = torch.zeros(B, dtype=torch.int32, device=x2.device)
    if n:
        MASK_QUANTIZE(x2.device, x2.data_ptr(),
                      None if u2 is None else u2.data_ptr(), t.data_ptr(),
                      s.data_ptr(), out.data_ptr(), cnt.data_ptr(), n, B, bits,
                      int(u2 is not None))
    return out.reshape(x.shape), cnt.reshape(lead)


def fused_mask_quantize_pack(x: torch.Tensor, threshold, scale,
                             u: Optional[torch.Tensor], bits: int, cap: int,
                             sentinel: Optional[int] = None):
    """`fused_mask_quantize` that also packs the coded wire form: the
    survivors' ascending indices and values in a (cap,) buffer per row,
    empty slots at index `sentinel` (default n) with value 0.  Returns
    (masked like x, idx (..., cap) int32, val (..., cap) f32, total kept
    (...) int32); total > cap means overflow, and the buffer then holds
    the first `cap` survivors."""
    x2, lead, t, s, u2 = _mask_quantize_args("fused_mask_quantize_pack", x,
                                             threshold, scale, u, bits)
    B, n = x2.shape
    if not 0 <= cap < 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"cap {cap} and n {n} must fit int32")
    sentinel = n if sentinel is None else int(sentinel)
    if not x2.is_cuda:
        out, idx, val, tot = fused_mask_quantize_pack_plain(
            x2, t, s, u2, bits, cap, sentinel)
    else:
        dev = x2.device
        out = torch.empty_like(x2)
        if n:   # the kernels write every slot and the totals
            idx = torch.empty((B, cap), dtype=torch.int32, device=dev)
            val = torch.empty((B, cap), dtype=torch.float32, device=dev)
            tot = torch.empty(B, dtype=torch.int32, device=dev)
            scratch = torch.empty(pack_batch_scratch_words(B, n),
                                  dtype=torch.int64, device=dev)
            MASK_QUANTIZE_PACK(
                dev, x2.data_ptr(), None if u2 is None else u2.data_ptr(),
                t.data_ptr(), s.data_ptr(), out.data_ptr(), idx.data_ptr(),
                val.data_ptr(), tot.data_ptr(), scratch.data_ptr(), n, B,
                bits, int(u2 is not None), cap, sentinel)
        else:
            idx = torch.full((B, cap), sentinel, dtype=torch.int32,
                             device=dev)
            val = torch.zeros((B, cap), dtype=torch.float32, device=dev)
            tot = torch.zeros(B, dtype=torch.int32, device=dev)
    return (out.reshape(x.shape), idx.reshape(lead + (cap,)),
            val.reshape(lead + (cap,)), tot.reshape(lead))


# ---------------------------------------------------------------------------
# the codec and the server-side accumulate
# ---------------------------------------------------------------------------

def pack_values(values: torch.Tensor, cap: int, mask=None):
    """Reference pack of one (n,) dense-embedded sparse vector -> (idx
    (cap,) int32 ascending, val (cap,) f32, nnz () int32).  `mask`
    defaults to `values != 0`; empty slots carry index n; entries past
    `cap` are dropped from the buffer but still counted in nnz."""
    n = values.shape[-1]
    keep = values != 0 if mask is None else mask
    idx, val, nnz = pack_rows_plain(values.reshape(1, n), keep.reshape(1, n),
                                    cap, n)
    return idx[0], val[0], nnz[0]


def pack_values_batch(values: torch.Tensor, cap: int):
    """The engines' batched cohort pack: each row of (B, n) f32 `values`
    packed on its own, keep rule `x != 0` (so -0.0 is dropped and NaN
    kept).  -> (idx (B, cap) int32, val (B, cap) f32, nnz (B,) int32),
    bit-identical to `pack_values` row by row, which is what a CPU tensor
    runs; a CUDA tensor runs the pack kernel (one launch)."""
    x2, lead = as_rows(values, "values")
    B, n = x2.shape
    if not 0 <= cap < 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"cap {cap} and n {n} must fit int32")
    if not x2.is_cuda:
        idx, val, nnz = pack_rows_plain(x2, x2 != 0, cap, n)
    else:
        check_cuda("pack_values_batch", values=x2)
        dev = x2.device
        if n:   # the kernels write every slot and the totals
            idx = torch.empty((B, cap), dtype=torch.int32, device=dev)
            val = torch.empty((B, cap), dtype=torch.float32, device=dev)
            nnz = torch.empty(B, dtype=torch.int32, device=dev)
            scratch = torch.empty(pack_batch_scratch_words(B, n),
                                  dtype=torch.int64, device=dev)
            PACK_BATCH(dev, x2.data_ptr(), idx.data_ptr(), val.data_ptr(),
                       nnz.data_ptr(), scratch.data_ptr(), n, B, cap, n)
        else:   # n == 0: every slot empty, sentinel n == 0
            idx = torch.zeros((B, cap), dtype=torch.int32, device=dev)
            val = torch.zeros((B, cap), dtype=torch.float32, device=dev)
            nnz = torch.zeros(B, dtype=torch.int32, device=dev)
    return (idx.reshape(lead + (cap,)), val.reshape(lead + (cap,)),
            nnz.reshape(lead))


def unpack_values(idx: torch.Tensor, val: torch.Tensor, n: int):
    """Densify one packed message; sentinel slots (index >= n) drop."""
    out = torch.zeros(n + 1, dtype=val.dtype, device=val.device)
    out.scatter_(0, idx.clamp_max(n).long(), val)
    return out[:n]


def sparse_accumulate(idx: torch.Tensor, val: torch.Tensor, n: int):
    """Sum packed messages (..., cap) into a dense (n,) vector without
    densifying them; sentinel slots (index >= n) drop.

    The f32 adds of each coordinate associate in row-major order from 0.0,
    as the reference's one flattened scatter-add applies them: each row's
    indices are unique, so one `index_add_` per row into an (n + 1,)
    buffer (the extra slot takes the sentinels) adds each coordinate at
    most once per call, in row order.  One `index_add_` over all rows at
    once would race its atomics on the card and lose that order."""
    cap = idx.shape[-1]
    idx2, val2 = idx.reshape(-1, cap), val.reshape(-1, cap)
    acc = torch.zeros(n + 1, dtype=val.dtype, device=val.device)
    for r in range(idx2.shape[0]):
        acc.index_add_(0, idx2[r].clamp_max(n), val2[r])
    return acc[:n]


def hierarchical_accumulate(idx: torch.Tensor, val: torch.Tensor, n: int,
                            edges: int):
    """Two-level edge -> server reduction of packed messages, bitwise equal
    to `sparse_accumulate`: edge e owns the index range [e*n//edges,
    (e+1)*n//edges), scatter-adds only the pairs in its range (the rest go
    to its local sentinel), and the server concatenates the disjoint
    partials.  Every coordinate is added at exactly one edge, in the flat
    form's row order."""
    if edges < 1:
        raise ValueError(f"edges must be >= 1, got {edges}")
    parts = []
    for e in range(edges):
        lo, hi = e * n // edges, (e + 1) * n // edges
        eidx = torch.where((idx >= lo) & (idx < hi), idx - lo, hi - lo)
        parts.append(sparse_accumulate(eidx, val, hi - lo))
    return torch.cat(parts) if len(parts) > 1 else parts[0]
