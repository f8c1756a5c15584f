"""Magnitude-threshold masking (FLASC's sparsifier): wrappers, plain versions.

`x * (|x| >= t)` over the flattened adapter vector, on download and on
every client's upload, plus the kept count that drives the bisection of
the `pallas` selector (`core/selectors.py`).  Two TPU kernels of
`src/repro/kernels/topk_mask.py` map onto one CUDA kernel body with a
compile-time store switch (`csrc/transport.cu::mask_count_kernel`):

  - `threshold_count` replaces `threshold_count_pallas`: count of
    `|x| >= t` (one bisection probe).
  - `topk_mask` replaces `topk_mask_pallas`: the masked vector and its
    kept count.

Inputs are (n,) or (B, n) f32 with a per-row threshold of shape () or
(B,); a (B, n) input runs as ONE launch over all rows.  Counts are int32.
On CUDA tensors each wrapper launches its kernel or raises; on CPU
tensors it runs the plain PyTorch version beside it (`*_plain`), which
is what the tests hold against the reference.  Unlike the Pallas kernels
no block padding is needed: the CUDA kernel masks the ragged tail.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels._build import CudaFunction

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

THRESHOLD_COUNT = CudaFunction("transport", "threshold_count_f32",
                               [_P, _P, _P, _LL, _I])
TOPK_MASK = CudaFunction("transport", "topk_mask_f32",
                         [_P, _P, _P, _P, _LL, _I])


# ---------------------------------------------------------------------------
# shared argument checks for the transport kernels
# ---------------------------------------------------------------------------

def as_rows(x: torch.Tensor, name: str = "x") -> Tuple[torch.Tensor, tuple]:
    """(n,) or (B, n) -> ((B, n) view, leading shape () or (B,))."""
    if x.ndim not in (1, 2):
        raise ValueError(f"{name} must be (n,) or (B, n), got {tuple(x.shape)}")
    lead = tuple(x.shape[:-1])
    return x.reshape(-1, x.shape[-1]), lead


def per_row(v, rows: int, like: torch.Tensor, dtype: torch.dtype,
            name: str) -> torch.Tensor:
    """A scalar or (rows,) per-row operand as a contiguous (rows,) tensor
    of `dtype` on `like`'s device."""
    if not isinstance(v, torch.Tensor):
        return torch.full((rows,), v, dtype=dtype, device=like.device)
    if v.numel() not in (1, rows):
        raise ValueError(f"{name} has {v.numel()} entries for {rows} rows")
    if v.device != like.device:
        raise ValueError(f"{name} is on {v.device}, x on {like.device}")
    return v.to(dtype).reshape(-1).expand(rows).contiguous()


def check_cuda(kernel: str, **tensors: torch.Tensor) -> None:
    """The CUDA kernels take f32 (int32 where named so), contiguous tensors
    on one CUDA device."""
    dev = None
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{kernel}: {name} is on {t.device}; the CUDA "
                             "kernel takes CUDA tensors")
        if dev is not None and t.device != dev:
            raise ValueError(f"{kernel}: {name} is on {t.device}, not {dev}")
        dev = t.device
        if t.dtype != torch.float32:
            raise TypeError(f"{kernel} takes f32 {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel} needs a contiguous {name}")
    rows = next(iter(tensors.values())).shape[0]
    if rows > 65535:
        raise ValueError(f"{kernel}: {rows} rows exceed the grid's 65535")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def threshold_count_plain(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(B, n), (B,) -> (B,) int32 count of |x| >= t."""
    return (x.abs() >= t[:, None]).sum(-1, dtype=torch.int32)


def topk_mask_plain(x: torch.Tensor, t: torch.Tensor):
    """(B, n), (B,) -> (x where |x| >= t else 0, (B,) int32 kept count)."""
    keep = x.abs() >= t[:, None]
    return torch.where(keep, x, 0.0), keep.sum(-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def threshold_count(x: torch.Tensor, threshold) -> torch.Tensor:
    """Count of |x| >= threshold per row: () for (n,), (B,) for (B, n)."""
    x2, lead = as_rows(x)
    t = per_row(threshold, x2.shape[0], x2, x2.dtype, "threshold")
    if not x2.is_cuda:
        return threshold_count_plain(x2, t).reshape(lead)
    check_cuda("threshold_count", x=x2, threshold=t)
    B, n = x2.shape
    cnt = torch.zeros(B, dtype=torch.int32, device=x2.device)
    if n:
        THRESHOLD_COUNT(x2.device, x2.data_ptr(), t.data_ptr(), cnt.data_ptr(),
                        n, B)
    return cnt.reshape(lead)


def topk_mask(x: torch.Tensor, threshold):
    """(x * (|x| >= threshold), kept count) per row."""
    x2, lead = as_rows(x)
    t = per_row(threshold, x2.shape[0], x2, x2.dtype, "threshold")
    if not x2.is_cuda:
        masked, cnt = topk_mask_plain(x2, t)
        return masked.reshape(x.shape), cnt.reshape(lead)
    check_cuda("topk_mask", x=x2, threshold=t)
    B, n = x2.shape
    out = torch.empty_like(x2)
    cnt = torch.zeros(B, dtype=torch.int32, device=x2.device)
    if n:
        TOPK_MASK(x2.device, x2.data_ptr(), t.data_ptr(), out.data_ptr(),
                  cnt.data_ptr(), n, B)
    return out.reshape(x.shape), cnt.reshape(lead)
