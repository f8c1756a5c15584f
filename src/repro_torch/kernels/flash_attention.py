"""Flash attention (online-softmax tiling): wrapper, gradient, plain versions.

`flash_attention` replaces the TPU kernel
`src/repro/kernels/flash_attention.py::flash_attention_pallas` with the
hand-written CUDA kernel of `csrc/flash_attention.cu`: per (batch, query
head) and tile of query rows, KV tiles stream through shared memory while
a running max `m`, sum `l` and output `acc` are kept in f32; masked
scores are -1e30 where key > query; the output is acc / max(l, 1e-30) in
q.dtype.  Asked for it, the kernel also writes each row's log-sum-exp
`lse = m + log(max(l, 1e-30))` (f32, (B, H, S), natural log), which the
backward needs; `out` is the same with or without it.

It takes GQA directly: q (B, S, H, hd), k and v (B, T, KV, hd) with query
head h reading KV head h // (H // KV), so the KV heads are never repeated
H times (KV == H is the reference's pre-broadcast call).  Any S and T:
the kernel masks the ragged tiles.  hd in {32, 64, 128, 256}, bf16 or f32.

A sliding window (`window=W`, causal only) keeps key t for query s when
s - W < t <= s, as the reference's `causal_mask(..., window)`: W keys
including the query's own.  The kernels skip the key tiles wholly below
every row's window.  Every row must see a key, so S <= T + W - 1.

Four forward routes on four kernels behind one C entry point;
`flash_route` picks one from the dtype and hd alone, before the launch
(never as a retry):
  - "wgmma": bf16, hd 128 (Yi-9B, every long prompt) -- TMA loads into an
    mbarrier ring fed by a producer warpgroup, wgmma for both products;
  - "mma_sync": bf16, hd 32 and 64 -- the first version's `mma.sync`
    kernel;
  - "hd256": bf16, hd 256 (gemma-7b) -- the same design with 64-key tiles
    and P V as wgmma m64n256k16, its loads issued by one thread of the
    two warpgroups (producer warps would cap every thread at 168
    registers; the kernel uses 254);
  - "fma": f32 -- FMA, never TF32.
`FLASH.launches` counts every launch, `FLASH.launches_by_route` each
route's and `FLASH.launches_by_tag["window"]` those with a window.

The gradient.  Whenever autograd records (grad mode on and q, k or v
requiring a gradient), `flash_attention` on CUDA tensors runs as a
`torch.autograd.Function`: its forward launches the forward kernel with
`lse` and saves q, k, v, out and lse; its backward launches
`csrc/flash_attention_bwd.cu` (`FLASH_BWD`), three kernels behind one C
entry point: D = rowsum(dout * out), then dK and dV per (batch, KV head,
key tile) summing the G query heads of the group inside the block, then
dQ per (batch, query head, query tile), each recomputing P = exp(scale
q k^T - lse).  No atomics: the gradient is bitwise the same run to run.
The reference has no Pallas backward; this is the port's counterpart of
XLA's autodiff of `chunked_attention`, the reference's path at these
lengths.  `flash_bwd_route` picks the backward's kernels as
`flash_route` picks the forward's:
  - "wgmma": bf16, hd 128 (Yi-9B's long-sequence training) -- TMA loads
    into an mbarrier ring fed by a producer warpgroup, wgmma for all five
    products, P and dS entering theirs from registers;
  - "mma_sync": bf16, hd 32 and 64 -- the first version's `mma.sync`
    kernels;
  - "fma": f32 -- FMA, never TF32.
Neither a window nor hd 256 has backward kernels yet (ROADMAP queue 1
item 11): on CUDA tensors a call that autograd records with either
raises before it launches, and `flash_bwd_route` raises at hd 256.
`flash_bwd_scratch` allocates the f32 scratch, sized for the largest
route's need.
`flash_attention_bwd_plain` is the backward's function in plain PyTorch.

The probabilities stay in f32 in both dtypes, as in the Pallas kernel
(which promotes v to f32) and `chunked_attention`.  In bf16 the tensor
cores take bf16 operands, so the kernels split p (and, in the backward,
dS) into a hi + lo pair of bf16 and run the product on each half: they
keep about 16 bits.  The contracts in bf16: each output row within 4e-3
of its largest value of an f64 attention on the same inputs (the output's
own rounding to bf16 allows up to 2^-8 = 3.9e-3); each row of dq, dk and
dv within 1e-2 of its largest value of `flash_attention_bwd_plain` in f64
on the same q, k, v, out, lse and dout (a row's largest value floored at
1e-2 of the gradient's: a causal first row has an exact dq of 0).
`flash_attention_plain` is the forward's function; the reference's
oracle (`ref.flash_attention_ref`), which casts p to v.dtype first,
misses the forward's bound (5e-3 to 6e-3 at 512 keys).

On CUDA tensors the wrapper launches the kernels or raises; on CPU
tensors it runs `flash_attention_plain`, which autograd differentiates.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaFunction, aligned
from repro_torch.kernels.ref import NEG_INF

HEAD_DIMS = (32, 64, 128, 256)
DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# the C entry points' `route`
ROUTES = {"wgmma": 0, "mma_sync": 1, "fma": 2, "hd256": 3}
NO_BACKWARD = ("no flash backward kernel for a sliding window or hd 256 yet "
               "(ROADMAP queue 1 item 11)")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (q, k, v, out, lse or None, B, S, T, H, KV, hd, dtype, causal, scale, route,
#  window: 0 for none)
FLASH = CudaFunction("flash_attention", "flash_attention_fwd",
                     [_P] * 5 + [_I] * 8 + [_F, _I, _I])
# (q, k, v, out, lse, dout, dq, dk, dv, dsum scratch, B, S, T, H, KV, hd,
#  dtype, causal, scale, route)
FLASH_BWD = CudaFunction("flash_attention_bwd", "flash_attention_bwd",
                         [_P] * 10 + [_I] * 8 + [_F, _I])


def flash_route(dtype: torch.dtype, hd: int) -> str:
    """The forward kernel that serves (dtype, hd): "wgmma" for bf16 at hd
    128, "mma_sync" for bf16 at hd 32 or 64, "hd256" for bf16 at hd 256,
    "fma" for f32."""
    if dtype not in DTYPES:
        raise TypeError(f"flash_attention: the CUDA kernel takes bf16 or f32, "
                        f"got {dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the CUDA kernel takes head size "
                         f"{HEAD_DIMS}, got {hd}")
    if dtype == torch.float32:
        return "fma"
    return {128: "wgmma", 256: "hd256"}.get(hd, "mma_sync")


def flash_bwd_route(dtype: torch.dtype, hd: int) -> str:
    """The backward kernels that serve (dtype, hd): the forward's route,
    "wgmma" for bf16 at hd 128, "mma_sync" for bf16 at hd 32 or 64, "fma"
    for f32.  hd 256 raises: it has no backward kernels yet."""
    route = flash_route(dtype, hd)
    if hd == 256:
        raise NotImplementedError(f"flash_attention_bwd: {NO_BACKWARD}")
    return route


def flash_bwd_scratch(B: int, H: int, S: int, device) -> torch.Tensor:
    """The backward entry point's f32 scratch, 2 B H S_pad floats with
    S_pad = S rounded up to a multiple of 128: the "wgmma" route writes lse
    * log2 e and D there, 64 rows of each in turn (rows past S padded); the
    "mma_sync" and "fma" routes write D (B, H, S) into its first B H S."""
    rows = -(-S // 128) * 128 * 2
    return torch.empty(B, H, rows, dtype=torch.float32, device=device)


def _work_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 for bf16 and f32 inputs (the kernels' arithmetic); f64 stays
    f64, so that the plain versions give exact references."""
    return torch.promote_types(dtype, torch.float32)


def _keep(S: int, T: int, device, window=None):
    """(S, T) bool, key t <= query s and, given a window W, t > s - W: the
    causal mask."""
    t = torch.arange(T, device=device)[None, :]
    s = torch.arange(S, device=device)[:, None]
    keep = t <= s
    return keep if window is None else keep & (t > s - window)


def _check_window(window, causal: bool, S: int, T: int) -> int:
    """The window as the C entry point takes it (0 for none), after the
    checks it makes: a causal window of W >= 1 keys in which every query
    row sees at least one key (S <= T + W - 1)."""
    if window is None:
        return 0
    if not causal or int(window) < 1:
        raise ValueError(f"flash_attention: a window needs causal=True and "
                         f"W >= 1, got causal={causal}, window={window}")
    if S > T + int(window) - 1:
        raise ValueError(f"flash_attention: with window {window}, query rows "
                         f"past T + W - 1 = {T + int(window) - 1} see no key "
                         f"(S = {S})")
    return int(window)


def flash_attention_plain(q, k, v, *, causal: bool = True, scale: float,
                          window=None, return_lse: bool = False):
    """The kernel's function in plain PyTorch, as the Pallas `_kernel`
    computes it: f32 scores q k^T times `scale`, -1e30 above the diagonal
    (and, given a causal window W, at keys t <= s - W), f32 softmax, p @ v
    with v promoted to f32, the output cast once to q.dtype.  GQA in
    place: query head h reads kv head h // (H // KV).  One kv head's group
    of query heads at a time, so the (S, T) scores of only H / KV heads are
    held at once.  f64 inputs are computed in f64.
    return_lse=True also returns the rows' log-sum-exp (B, H, S), in f32
    (f64 for f64 inputs), as the kernel writes it."""
    S, H = q.shape[1], q.shape[2]
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    wt = _work_dtype(q.dtype)
    _check_window(window, causal, S, T)
    keep = _keep(S, T, q.device, window) if causal else None
    outs, lses = [], []
    for h in range(KV):
        s = torch.einsum("bsgd,btd->bgst", q[:, :, h * G:(h + 1) * G].to(wt),
                         k[:, :, h].to(wt)) * scale
        if keep is not None:
            s = torch.where(keep, s, NEG_INF)
        if return_lse:
            lses.append(torch.logsumexp(s, dim=-1))
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bgst,btd->bsgd", p, v[:, :, h].to(wt)))
    out = torch.cat(outs, dim=2).to(q.dtype)
    return (out, torch.cat(lses, dim=1)) if return_lse else out


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal: bool,
                              scale: float):
    """The backward kernels' function in plain PyTorch: with P = exp(scale
    q k^T - lse) (0 above the diagonal under `causal`) and D = rowsum(dout
    * out), dV = P^T dout, dS = P * (dout v^T - D), dQ = scale dS k and
    dK = scale dS^T q, the GQA sum over each KV head's G query heads taken
    per group.  f32 arithmetic (f64 for f64 inputs); returns (dq, dk, dv)
    in q's dtype.  lse (B, H, S) as `flash_attention_plain(...,
    return_lse=True)` or the forward kernel gives it."""
    S, H = q.shape[1], q.shape[2]
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    wt = _work_dtype(q.dtype)
    keep = _keep(S, T, q.device) if causal else None
    dsum = torch.einsum("bshd,bshd->bhs", dout.to(wt), out.to(wt))
    dqs, dks, dvs = [], [], []
    for h in range(KV):
        grp = slice(h * G, (h + 1) * G)
        qg, dog = q[:, :, grp].to(wt), dout[:, :, grp].to(wt)
        kh, vh = k[:, :, h].to(wt), v[:, :, h].to(wt)
        s = torch.einsum("bsgd,btd->bgst", qg, kh) * scale
        p = torch.exp(s - lse[:, grp, :, None].to(wt))
        if keep is not None:
            p = torch.where(keep, p, 0.0)
        dvs.append(torch.einsum("bgst,bsgd->btd", p, dog))
        dp = torch.einsum("bsgd,btd->bgst", dog, vh)
        ds = p * (dp - dsum[:, grp, :, None])
        dqs.append(scale * torch.einsum("bgst,btd->bsgd", ds, kh))
        dks.append(scale * torch.einsum("bgst,bsgd->btd", ds, qg))
    dt = q.dtype
    return (torch.cat(dqs, dim=2).to(dt), torch.stack(dks, dim=2).to(dt),
            torch.stack(dvs, dim=2).to(dt))


def _check_shapes(q, k, v) -> None:
    """Shapes the kernel takes (the plain version takes the same)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"flash_attention takes q (B, S, H, hd) and k, v "
                         f"(B, T, KV, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must both be (B={B}, T, KV, "
                         f"hd={hd})")
    KV = k.shape[2]
    if KV < 1 or H % KV:
        raise ValueError(f"flash_attention: {H} query heads do not group "
                         f"over {KV} kv heads")


def _check_cuda(q, *others) -> str:
    """Devices and dtypes the kernels take; returns the forward route."""
    for name, t in others:
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q "
                             f"on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is "
                            f"{q.dtype}")
    B, S, H, hd = q.shape
    route = flash_route(q.dtype, hd)
    if B * H > 2**31 - 1 or -(-S // 64) > 65535:
        raise ValueError(f"flash_attention: B * H = {B * H} or S = {S} "
                         "exceeds the kernel's grid")
    return route


def _forward(q, k, v, causal: bool, scale: float, want_lse: bool,
             window: int = 0):
    """Launch the forward kernel on aligned, contiguous q, k, v: (out, lse
    or None).  window as `_check_window` returns it."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    route = _check_cuda(q, ("k", k), ("v", v))
    out = torch.empty_like(q)
    lse = (torch.empty(B, H, S, dtype=torch.float32, device=q.device)
           if want_lse else None)
    if out.numel() == 0 or T == 0:
        if lse is not None:
            lse.fill_(NEG_INF)
        return (out.zero_() if T == 0 else out), lse
    FLASH(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
          None if lse is None else lse.data_ptr(), B, S, T, H, KV, hd,
          DTYPES[q.dtype], int(causal), float(scale), ROUTES[route], window,
          route=route, tag="window" if window else None)
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool,
                        scale: float):
    """(dq, dk, dv) of `flash_attention` at (q, k, v) for the output
    gradient `dout`, given the forward's `out` and `lse` (B, H, S) f32.  On
    CUDA tensors one launch of the backward entry point (three kernels);
    on CPU tensors `flash_attention_bwd_plain`."""
    _check_shapes(q, k, v)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)} and "
                         f"dout {tuple(dout.shape)} must be q's "
                         f"{tuple(q.shape)}")
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if lse.shape != (B, H, S):
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} must "
                         f"be (B, H, S) = {(B, H, S)}")
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                         causal=causal, scale=scale)
    _check_cuda(q, ("k", k), ("v", v), ("out", out), ("dout", dout))
    if lse.dtype != torch.float32 or lse.device != q.device:
        raise TypeError(f"flash_attention_bwd: lse must be f32 on "
                        f"{q.device}, got {lse.dtype} on {lse.device}")
    route = flash_bwd_route(q.dtype, hd)
    q, k, v, out, dout, lse = (aligned(t) for t in (q, k, v, out, dout, lse))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel() == 0 or T == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    dsum = flash_bwd_scratch(B, H, S, q.device)
    FLASH_BWD(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
              out.data_ptr(), lse.data_ptr(), dout.data_ptr(), dq.data_ptr(),
              dk.data_ptr(), dv.data_ptr(), dsum.data_ptr(), B, S, T, H, KV,
              hd, DTYPES[q.dtype], int(causal), float(scale), ROUTES[route],
              route=route)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The kernels with their gradient: the forward saves q, k, v, out and
    lse; the backward launches `flash_attention_bwd` once."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        q, k, v = aligned(q), aligned(k), aligned(v)
        out, lse = _forward(q, k, v, causal, scale, want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, scale: float,
                    window=None) -> torch.Tensor:
    """softmax(q k^T * scale, causal) v per query head, GQA layout, with an
    optional causal sliding window of `window` keys; returns (B, S, H, hd)
    in q.dtype.  On CUDA tensors, differentiable through the backward
    kernels whenever autograd records, except with a window or at hd 256,
    which raise there (no backward kernels yet)."""
    _check_shapes(q, k, v)
    w = _check_window(window, causal, q.shape[1], k.shape[1])
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     window=window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        _check_cuda(q, ("k", k), ("v", v))
        if w or q.shape[3] == 256:
            raise NotImplementedError(
                f"flash_attention under autograd: {NO_BACKWARD}; run the "
                "forward under torch.no_grad()")
        return _FlashAttention.apply(q, k, v, causal, float(scale))
    q, k, v = aligned(q), aligned(k), aligned(v)
    return _forward(q, k, v, causal, scale, want_lse=False, window=w)[0]
