"""Flash attention (online-softmax tiling): wrapper, plain version.

`flash_attention` replaces the TPU kernel
`src/repro/kernels/flash_attention.py::flash_attention_pallas` with the
hand-written CUDA kernel of `csrc/flash_attention.cu`: per (batch, query
head) and tile of query rows, KV tiles stream through shared memory while
a running max `m`, sum `l` and output `acc` are kept in f32; masked
scores are -1e30 where key > query; the output is acc / max(l, 1e-30) in
q.dtype.

It takes GQA directly: q (B, S, H, hd), k and v (B, T, KV, hd) with query
head h reading KV head h // (H // KV), so the KV heads are never repeated
H times (KV == H is the reference's pre-broadcast call).  Any S and T:
the kernel masks the ragged tiles.  hd in {32, 64, 128}, bf16 or f32.

Three kernels behind one C entry point; `flash_route` picks one from the
dtype and hd alone, before the launch (never as a retry):
  - "wgmma": bf16, hd 128 (Yi-9B, every long prompt) -- TMA loads into an
    mbarrier ring fed by a producer warpgroup, wgmma for both products;
  - "mma_sync": bf16, hd 32 and 64 -- the first version's `mma.sync`
    kernel;
  - "fma": f32 -- FMA, never TF32.
`FLASH.launches` counts every launch and `FLASH.launches_by_route` each
route's.

The probabilities stay in f32 in both dtypes, as in the Pallas kernel
(which promotes v to f32) and `chunked_attention`.  In bf16 the tensor
cores take bf16 operands, so the kernel splits p into a hi + lo pair of
bf16 and runs the second product on each half: p keeps about 16 bits, and
v stays bf16.  The contract in bf16: each output row within 4e-3 of its
largest value of an f64 attention on the same inputs (the output's own
rounding to bf16 allows up to 2^-8 = 3.9e-3).  `flash_attention_plain` is
this function in plain PyTorch; the reference's oracle
(`ref.flash_attention_ref`), which casts p to v.dtype first, misses that
bound (5e-3 to 6e-3 at 512 keys).

On CUDA tensors the wrapper launches the kernel or raises; on CPU tensors
it runs `flash_attention_plain`.  Forward only, as the reference's kernel:
a CUDA input that requires a gradient raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaFunction, aligned
from repro_torch.kernels.ref import NEG_INF

HEAD_DIMS = (32, 64, 128)
DTYPES = {torch.bfloat16: 0, torch.float32: 1}
ROUTES = {"wgmma": 0, "mma_sync": 1, "fma": 2}   # the C entry point's `route`

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
FLASH = CudaFunction("flash_attention", "flash_attention_fwd",
                     [_P, _P, _P, _P] + [_I] * 8 + [_F, _I])


def flash_route(dtype: torch.dtype, hd: int) -> str:
    """The kernel that serves (dtype, hd): "wgmma" for bf16 at hd 128,
    "mma_sync" for bf16 at hd 32 or 64, "fma" for f32."""
    if dtype not in DTYPES:
        raise TypeError(f"flash_attention: the CUDA kernel takes bf16 or f32, "
                        f"got {dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the CUDA kernel takes head size "
                         f"{HEAD_DIMS}, got {hd}")
    if dtype == torch.float32:
        return "fma"
    return "wgmma" if hd == 128 else "mma_sync"


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          scale: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch, as the Pallas `_kernel`
    computes it: f32 scores q k^T times `scale`, -1e30 above the diagonal,
    f32 softmax, p @ v with v promoted to f32, the output cast once to
    q.dtype.  GQA in place: query head h reads kv head h // (H // KV).  One
    kv head's group of query heads at a time, so the (S, T) scores of only
    H / KV heads are held at once."""
    S, H = q.shape[1], q.shape[2]
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    keep = None
    if causal:
        keep = (torch.arange(T, device=q.device)[None, :]
                <= torch.arange(S, device=q.device)[:, None])
    outs = []
    for h in range(KV):
        s = torch.einsum("bsgd,btd->bgst", q[:, :, h * G:(h + 1) * G].float(),
                         k[:, :, h].float()) * scale
        if keep is not None:
            s = torch.where(keep, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bgst,btd->bsgd", p, v[:, :, h].float()))
    return torch.cat(outs, dim=2).to(q.dtype)


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


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float) -> torch.Tensor:
    """softmax(q k^T * scale, causal) v per query head, GQA layout; returns
    (B, S, H, hd) in q.dtype."""
    _check_shapes(q, k, v)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention: the CUDA kernel is forward-only, as the "
            "reference's; training at chunked_attn_threshold tokens or more "
            "on the card is ROADMAP queue 1, item 5")
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q "
                             f"on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is "
                            f"{q.dtype}")
    route = flash_route(q.dtype, hd)
    if B * H > 2**31 - 1 or -(-S // 64) > 65535:
        raise ValueError(f"flash_attention: B * H = {B * H} or S = {S} "
                         "exceeds the kernel's grid")
    q, k, v = aligned(q), aligned(k), aligned(v)
    out = torch.empty_like(q)
    if out.numel() == 0 or T == 0:
        return out.zero_() if T == 0 else out
    FLASH(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
          B, S, T, H, KV, hd, DTYPES[q.dtype], int(causal), float(scale),
          ROUTES[route], route=route)
    return out
