"""Mamba's selective scan: the coefficients, the recurrence and the readout.

`selective_scan(u, w_dt, dt_bias, A_log, D_skip, Bc, Cc, h0)` computes, for
u (B, S, di) in the compute dtype and the f32 rest,

    dt = softplus(u w_dt + dt_bias)                     (B, S, di)
    h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t            A = -exp(A_log)
    y_t = sum_n h_t C_t + D_skip u_t

and returns (y (B, S, di) f32, h_last (B, di, N) f32), h_{-1} = h0 (zeros
when None).  It is what `src/repro/models/ssm.py` computes with
`_ssm_coeffs`, `_chunk_scan` (an `associative_scan` over (B, S, di, N) f32
decay and drive tensors, which XLA fuses) and the readout of
`mamba_forward_state` / `mamba_decode`; `Bc` and `Cc` (u's projections) are
plain matmuls and stay outside.  No Pallas kernel stands behind it: it is
the port's own kernel, as the flash backward is, because eager PyTorch has
no associative scan and a loop over t launches about six kernels a token a
layer.

On CUDA tensors it launches the hand-written kernels of
`csrc/selective_scan.cu` or raises; `SCAN.launches` counts the launches of
its entry point, and `SCAN.launches_by_tag["chunked"]` those at S > `CHUNK`.
A chunked scan: chunks of `CHUNK` steps, each chunk's end state from zero,
the chunks' start states carried in order from h0, then every chunk
rescanned from its start with the readout (three kernels, one thread per
channel holding its N = 8 or 16 states in registers; the (B, S, di, N)
tensors are never written).  At S <= `CHUNK` (decode is the same call at
S = 1) only the last kernel runs, from h0, the lane's state.  The kernels have no backward yet:
training the recurrent families is ROADMAP queue 1 item 12, so a CUDA
call that autograd records raises `NotImplementedError`.  On CPU tensors
it runs `selective_scan_plain`, the same coefficients in a Python loop
over t, which autograd differentiates.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels._build import CudaFunction, aligned

STATE_SIZES = (8, 16)
DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# steps a chunk of the kernels' scan: csrc/selective_scan.cu's kChunk
CHUNK = 192

_P, _I = ctypes.c_void_p, ctypes.c_int
# (u, w_dt, dt_bias, A_log, D_skip, Bc, Cc, h0 or None, y, h_last, scratch
#  or None, B, S, di, N, dtype)
SCAN = CudaFunction("selective_scan", "selective_scan_fwd",
                    [_P] * 11 + [_I] * 5)


def scan_scratch(B: int, S: int, di: int, N: int,
                 device) -> Optional[torch.Tensor]:
    """The entry point's f32 scratch: None when S fits one chunk, else
    B * nc * di * (N + 1) floats for nc = ceil(S / CHUNK) chunks (each
    chunk's state, then its sum of dt)."""
    nc = -(-S // CHUNK)
    if nc == 1:
        return None
    return torch.empty(B * nc * di * (N + 1), dtype=torch.float32,
                       device=device)


def scan_coeffs(u, w_dt, dt_bias, A_log):
    """(u in f32, dt (B, S, di), A (di, N)): the reference's `_ssm_coeffs`
    up to the (B, S, di, N) decay and drive, which the scan forms a step
    at a time."""
    uf = u.float()
    dt = F.softplus(uf * w_dt[:, 0] + dt_bias)
    return uf, dt, -torch.exp(A_log)


def selective_scan_plain(u, w_dt, dt_bias, A_log, D_skip, Bc, Cc, h0=None):
    """The kernel's function in plain PyTorch: a Python loop over t, each
    step the reference's decode recurrence `a h + bu` and readout."""
    uf, dt, A = scan_coeffs(u, w_dt, dt_bias, A_log)
    B, S, di = u.shape
    h = h0 if h0 is not None else torch.zeros(
        B, di, A.shape[-1], dtype=torch.float32, device=u.device)
    dtu = dt * uf
    ys = []
    for t in range(S):
        a = torch.exp(dt[:, t, :, None] * A)
        h = a * h + dtu[:, t, :, None] * Bc[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cc[:, t]))
    y = torch.stack(ys, dim=1) + D_skip * uf
    return y, h


def _check(u, w_dt, dt_bias, A_log, D_skip, Bc, Cc, h0) -> Tuple[int, ...]:
    if u.ndim != 3:
        raise ValueError(f"selective_scan: u is (B, S, di), got "
                         f"{tuple(u.shape)}")
    B, S, di = u.shape
    N = A_log.shape[-1]
    want = {"w_dt": (w_dt, (di, 1)), "dt_bias": (dt_bias, (di,)),
            "A_log": (A_log, (di, N)), "D_skip": (D_skip, (di,)),
            "Bc": (Bc, (B, S, N)), "Cc": (Cc, (B, S, N))}
    if h0 is not None:
        want["h0"] = (h0, (B, di, N))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"selective_scan: {name} is {tuple(t.shape)}, "
                             f"expected {shape}")
    return B, S, di, N


def selective_scan(u, w_dt, dt_bias, A_log, D_skip, Bc, Cc,
                   h0: Optional[torch.Tensor] = None,
                   out_state: Optional[torch.Tensor] = None):
    """-> (y (B, S, di) f32, h_last (B, di, N) f32).  `out_state`, a
    contiguous f32 (B, di, N), receives h_last and is returned as it
    (it may be h0 itself: the decode state updated in place)."""
    B, S, di, N = _check(u, w_dt, dt_bias, A_log, D_skip, Bc, Cc, h0)
    if not u.is_cuda:
        y, h = selective_scan_plain(u, w_dt, dt_bias, A_log, D_skip, Bc, Cc,
                                    h0)
        if out_state is not None:
            out_state.copy_(h)
            h = out_state
        return y, h
    ins = (u, w_dt, dt_bias, A_log, D_skip, Bc, Cc) + (
        () if h0 is None else (h0,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        raise NotImplementedError(
            "selective_scan: the CUDA kernel has no backward yet (training "
            "the recurrent families is ROADMAP queue 1 item 12); run it "
            "under torch.no_grad()")
    if u.dtype not in DTYPES:
        raise TypeError(f"selective_scan: the CUDA kernel takes bf16 or f32 "
                        f"u, got {u.dtype}")
    if N not in STATE_SIZES:
        raise ValueError(f"selective_scan: the CUDA kernel takes a state "
                         f"size in {STATE_SIZES}, got {N}")
    for name, t in zip(("w_dt", "dt_bias", "A_log", "D_skip", "Bc", "Cc",
                        "h0"), ins[1:]):
        if t.device != u.device:
            raise ValueError(f"selective_scan: {name} is on {t.device}, u on "
                             f"{u.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"selective_scan: {name} must be f32, got "
                            f"{t.dtype}")
    if out_state is None:
        out_state = torch.empty(B, di, N, dtype=torch.float32, device=u.device)
    elif (tuple(out_state.shape) != (B, di, N) or not out_state.is_contiguous()
          or out_state.dtype != torch.float32
          or out_state.device != u.device):
        raise ValueError("selective_scan: out_state must be a contiguous f32 "
                         f"(B, di, N) = {(B, di, N)} on {u.device}")
    u, w_dt, dt_bias, A_log, D_skip = (
        t.contiguous() for t in (u, w_dt, dt_bias, A_log, D_skip))
    Bc, Cc = aligned(Bc), aligned(Cc)          # staged 16 bytes at a time
    h0 = None if h0 is None else h0.contiguous()
    y = torch.empty(B, S, di, dtype=torch.float32, device=u.device)
    scratch = scan_scratch(B, S, di, N, u.device)
    SCAN(u.device, u.data_ptr(), w_dt.data_ptr(), dt_bias.data_ptr(),
         A_log.data_ptr(), D_skip.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
         None if h0 is None else h0.data_ptr(), y.data_ptr(),
         out_state.data_ptr(), None if scratch is None else scratch.data_ptr(),
         B, S, di, N, DTYPES[u.dtype],
         tag="chunked" if scratch is not None else None)
    return y, out_state
