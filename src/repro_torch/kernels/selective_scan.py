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
S = 1) only the last kernel runs, from h0, the lane's state.

Whenever autograd records, the call goes through `_SelectiveScan`: its
forward is the same launch, which keeps the chunks' start states (the
forward's scratch) for the backward; its backward is one launch of
`selective_scan_bwd` (`SCAN_BWD`, five kernels: the adjoint's chunks from
zero, their carry in reverse order, a rescan of every chunk that forms the
gradients, and two fixed-order sums; bitwise from run to run).  On CPU
tensors the forward is `selective_scan_plain`, a Python loop over t, and
the backward `selective_scan_bwd_plain`, a reverse loop over t, so the CPU
tests exercise the same Function.
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
# (u, w_dt, dt_bias, A_log, D_skip, Bc, Cc, h0 or None, the forward's
#  scratch or None, dy, dh_last or None, du, dBc, dCc, dh0 or None, dw_dt,
#  ddt_bias, dA_log, dD_skip (all four or None), scratch, B, S, di, N,
#  dtype)
SCAN_BWD = CudaFunction("selective_scan", "selective_scan_bwd",
                        [_P] * 20 + [_I] * 5)
# states a block of the backward's rescan holds: csrc/selective_scan.cu's
# kThreads threads of four (its dBc / dCc partials are per block)
BWD_STATES = 512


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


def scan_bwd_scratch(B: int, S: int, di: int, N: int,
                     device) -> torch.Tensor:
    """The backward entry point's f32 scratch: B * nc * di * (N + 4) floats
    (each chunk's adjoint, then its dA, its sum of dt and its dw_dt,
    ddt_bias and dD_skip partials) and the dBc and dCc partials of every
    block of its rescan kernel, 2 * B * ceil(di N / BWD_STATES) * S * N."""
    nc = -(-S // CHUNK)
    blocks = -(-di * N // BWD_STATES)
    return torch.empty(B * nc * di * (N + 4) + 2 * B * blocks * S * N,
                       dtype=torch.float32, device=device)


def scan_coeffs(u, w_dt, dt_bias, A_log):
    """(u in f32 or wider, dt (B, S, di), A (di, N)): the reference's
    `_ssm_coeffs` up to the (B, S, di, N) decay and drive, which the scan
    forms a step at a time.  A bf16 or f32 u computes in f32, an f64 one in
    f64 (the tests' exact arithmetic)."""
    uf = u.to(torch.promote_types(u.dtype, torch.float32))
    dt = F.softplus(uf * w_dt[:, 0] + dt_bias)
    return uf, dt, -torch.exp(A_log)


def selective_scan_plain(u, w_dt, dt_bias, A_log, D_skip, Bc, Cc, h0=None):
    """The kernel's function in plain PyTorch: a Python loop over t, each
    step the reference's decode recurrence `a h + bu` and readout."""
    uf, dt, A = scan_coeffs(u, w_dt, dt_bias, A_log)
    B, S, di = u.shape
    h = h0 if h0 is not None else torch.zeros(
        B, di, A.shape[-1], dtype=uf.dtype, device=u.device)
    dtu = dt * uf
    ys = []
    for t in range(S):
        a = torch.exp(dt[:, t, :, None] * A)
        h = a * h + dtu[:, t, :, None] * Bc[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cc[:, t]))
    y = torch.stack(ys, dim=1) + D_skip * uf
    return y, h


def selective_scan_bwd_plain(u, w_dt, dt_bias, A_log, D_skip, Bc, Cc, h0,
                             dy, dh_last=None):
    """The backward's function in plain PyTorch: the states h_t by the
    forward's loop, then the adjoint g_t = exp(dt_{t+1} A) g_{t+1} + C_t
    dy_t (from dh_last, zeros when None) by a reverse loop over t.
    Returns (du in u's dtype, dw_dt, ddt_bias, dA_log, dD_skip, dBc, dCc,
    dh0), the gradients of `selective_scan`'s inputs in their order (dh0
    None without h0)."""
    uf, dt, A = scan_coeffs(u, w_dt, dt_bias, A_log)
    f = uf.dtype
    B, S, di = u.shape
    N = A.shape[-1]
    Bc, Cc, dy = Bc.to(f), Cc.to(f), dy.to(f)
    h = h0.to(f) if h0 is not None else torch.zeros(B, di, N, dtype=f,
                                                    device=u.device)
    dtu = dt * uf
    hs = [h]
    for t in range(S):
        h = torch.exp(dt[:, t, :, None] * A) * h + dtu[:, t, :, None] * Bc[
            :, t, None, :]
        hs.append(h)
    g = dh_last.to(f) if dh_last is not None else torch.zeros_like(h)
    dBc, dCc = torch.empty_like(Bc), torch.empty_like(Cc)
    ddt, dus = torch.empty_like(uf), torch.empty_like(uf)
    dA = torch.zeros_like(A)
    for t in reversed(range(S)):
        g = g + Cc[:, t, None, :] * dy[:, t, :, None]        # g_t
        a = torch.exp(dt[:, t, :, None] * A)
        gB = (g * Bc[:, t, None, :]).sum(-1)
        q = g * a * hs[t]                                    # g a h_{t-1}
        dBc[:, t] = torch.einsum("bdn,bd->bn", g, dtu[:, t])
        dCc[:, t] = torch.einsum("bdn,bd->bn", hs[t + 1], dy[:, t])
        ddt[:, t] = (q * A).sum(-1) + uf[:, t] * gB
        dus[:, t] = gB
        dA += (dt[:, t, :, None] * q).sum(0)
        g = a * g                                            # onto h_{t-1}
    dx = ddt * torch.sigmoid(uf * w_dt[:, 0] + dt_bias)      # softplus'
    du = D_skip * dy + dt * dus + dx * w_dt[:, 0]
    return (du.to(u.dtype), (dx * uf).sum((0, 1))[:, None], dx.sum((0, 1)),
            dA * A, (dy * uf).sum((0, 1)), dBc, dCc,
            None if h0 is None else g)


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


def _check_cuda(u, others, N: int) -> None:
    """What the CUDA kernels take: u bf16 or f32, the rest f32 on u's
    device, N in STATE_SIZES."""
    if u.dtype not in DTYPES:
        raise TypeError(f"selective_scan: the CUDA kernel takes bf16 or f32 "
                        f"u, got {u.dtype}")
    if N not in STATE_SIZES:
        raise ValueError(f"selective_scan: the CUDA kernel takes a state "
                         f"size in {STATE_SIZES}, got {N}")
    for name, t in others:
        if t is None:
            continue
        if t.device != u.device:
            raise ValueError(f"selective_scan: {name} is on {t.device}, u on "
                             f"{u.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"selective_scan: {name} must be f32, got "
                            f"{t.dtype}")


def _forward(u, w_dt, dt_bias, A_log, D_skip, Bc, Cc, h0, out_state):
    """One launch of the forward entry point on CUDA tensors: (y, h_last,
    the scratch after the launch, the contiguous inputs)."""
    B, S, di = u.shape
    N = A_log.shape[-1]
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
    return y, out_state, scratch, (u, w_dt, dt_bias, A_log, D_skip, Bc, Cc, h0)


def selective_scan_bwd(u, w_dt, dt_bias, A_log, D_skip, Bc, Cc, h0,
                       fwd_scratch, dy, dh_last=None, *, params: bool = True):
    """The gradients of `selective_scan`'s inputs, in their order: (du in
    u's dtype, dw_dt, ddt_bias, dA_log, dD_skip, dBc, dCc, dh0), from the
    upstream dy (B, S, di) and dh_last (B, di, N) or None (zeros).
    `fwd_scratch` is the forward launch's scratch on the same inputs (None
    at S <= CHUNK); dh0 is None without h0, and the four parameter
    gradients are None unless `params`.  One launch of the backward entry
    point on CUDA tensors; raises on any other (the plain version is
    `selective_scan_bwd_plain`)."""
    B, S, di, N = _check(u, w_dt, dt_bias, A_log, D_skip, Bc, Cc, h0)
    if not u.is_cuda:
        raise ValueError(f"selective_scan_bwd: the kernel runs on CUDA "
                         f"tensors, u is on {u.device}")
    _check_cuda(u, (("w_dt", w_dt), ("dt_bias", dt_bias), ("A_log", A_log),
                    ("D_skip", D_skip), ("Bc", Bc), ("Cc", Cc), ("h0", h0),
                    ("dy", dy), ("dh_last", dh_last)), N)
    if tuple(dy.shape) != (B, S, di) or (
            dh_last is not None and tuple(dh_last.shape) != (B, di, N)):
        raise ValueError(f"selective_scan_bwd: dy {tuple(dy.shape)} must be "
                         f"{(B, S, di)} and dh_last (B, di, N)")
    want = scan_scratch(B, S, di, N, "meta")
    if (want is None) != (fwd_scratch is None) or (
            want is not None and fwd_scratch.numel() != want.numel()):
        raise ValueError("selective_scan_bwd: fwd_scratch must be the "
                         "forward's scratch at these shapes")
    u, w_dt, dt_bias, A_log, D_skip, dy = (
        t.contiguous() for t in (u, w_dt, dt_bias, A_log, D_skip, dy))
    Bc, Cc = aligned(Bc), aligned(Cc)
    h0, dh_last = (None if t is None else t.contiguous()
                   for t in (h0, dh_last))
    dev = u.device
    du = torch.empty_like(u)
    dBc = torch.empty(B, S, N, dtype=torch.float32, device=dev)
    dCc = torch.empty_like(dBc)
    dh0 = None if h0 is None else torch.empty_like(h0)
    grads = ((torch.empty_like(w_dt), torch.empty_like(dt_bias),
              torch.empty_like(A_log), torch.empty_like(D_skip)) if params
             else (None,) * 4)
    scratch = scan_bwd_scratch(B, S, di, N, dev)

    def ptr(t):
        return None if t is None else t.data_ptr()
    SCAN_BWD(dev, *(ptr(t) for t in (
        u, w_dt, dt_bias, A_log, D_skip, Bc, Cc, h0, fwd_scratch, dy, dh_last,
        du, dBc, dCc, dh0, *grads, scratch)), B, S, di, N, DTYPES[u.dtype],
        tag="chunked" if S > CHUNK else None)
    return (du, *grads, dBc, dCc, dh0)


class _SelectiveScan(torch.autograd.Function):
    """The scan with its gradient.  The forward runs the kernels (the plain
    loop on CPU tensors) and saves the inputs and the forward's scratch,
    the chunks' start states; the backward launches `selective_scan_bwd`
    once (`selective_scan_bwd_plain` on CPU tensors) and returns None where
    no gradient is needed.  An unused output's gradient arrives as None:
    dy is then zeros, dh_last none."""

    @staticmethod
    def forward(ctx, u, w_dt, dt_bias, A_log, D_skip, Bc, Cc, h0):
        ctx.set_materialize_grads(False)
        if u.is_cuda:
            y, h, scratch, ins = _forward(u, w_dt, dt_bias, A_log, D_skip,
                                          Bc, Cc, h0, None)
        else:
            y, h = selective_scan_plain(u, w_dt, dt_bias, A_log, D_skip, Bc,
                                        Cc, h0)
            scratch, ins = None, (u, w_dt, dt_bias, A_log, D_skip, Bc, Cc, h0)
        ctx.save_for_backward(*ins, scratch)
        return y, h

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dh_last):
        *ins, scratch = ctx.saved_tensors
        u = ins[0]
        if dy is None:
            dy = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
        need = ctx.needs_input_grad
        if u.is_cuda:
            grads = selective_scan_bwd(*ins, scratch, dy, dh_last,
                                       params=any(need[1:5]))
        else:
            grads = selective_scan_bwd_plain(*ins, dy, dh_last)
        return tuple(g if n else None for g, n in zip(grads, need))


def selective_scan(u, w_dt, dt_bias, A_log, D_skip, Bc, Cc,
                   h0: Optional[torch.Tensor] = None,
                   out_state: Optional[torch.Tensor] = None):
    """-> (y (B, S, di) f32, h_last (B, di, N) f32).  `out_state`, a
    contiguous f32 (B, di, N), receives h_last and is returned as it
    (it may be h0 itself: the decode state updated in place); it is refused
    while autograd records."""
    B, S, di, N = _check(u, w_dt, dt_bias, A_log, D_skip, Bc, Cc, h0)
    ins = (u, w_dt, dt_bias, A_log, D_skip, Bc, Cc) + (
        () if h0 is None else (h0,))
    if u.is_cuda:
        _check_cuda(u, zip(("w_dt", "dt_bias", "A_log", "D_skip", "Bc", "Cc",
                            "h0"), ins[1:]), N)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        if out_state is not None:
            raise ValueError("selective_scan: out_state (an in-place state "
                             "update) is refused while autograd records")
        return _SelectiveScan.apply(u, w_dt, dt_bias, A_log, D_skip, Bc, Cc,
                                    h0)
    if not u.is_cuda:
        y, h = selective_scan_plain(u, w_dt, dt_bias, A_log, D_skip, Bc, Cc,
                                    h0)
        if out_state is not None:
            out_state.copy_(h)
            h = out_state
        return y, h
    return _forward(u, w_dt, dt_bias, A_log, D_skip, Bc, Cc, h0,
                    out_state)[:2]
