"""Plain PyTorch oracles for the kernels of `kernels/ops.py`.

The port's own copy of `src/repro/kernels/ref.py`, function for function:
the same semantics, f32 accumulation where the reference asks for it.
These are the plain versions the tests hold the kernels against.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def topk_mask_ref(x: torch.Tensor, threshold) -> torch.Tensor:
    """Magnitude-threshold masking: keep x where |x| >= threshold."""
    return torch.where(x.abs() >= threshold, x, torch.zeros_like(x))


def threshold_count_ref(x: torch.Tensor, threshold) -> torch.Tensor:
    """Number of entries with |x| >= threshold (int32)."""
    return (x.abs() >= threshold).sum(dtype=torch.int32)


def lora_matmul_ref(x, w, a, b, scale: float) -> torch.Tensor:
    """y = x @ w + scale * (x @ a) @ b, both products accumulated in f32,
    x @ a rounded to x.dtype before the second product, y in x.dtype.
    x (M, K), w (K, N), a (K, r), b (r, N)."""
    y = torch.matmul(x.float(), w.float())
    xa = torch.matmul(x.float(), a.float()).to(x.dtype)
    y = y + scale * torch.matmul(xa.float(), b.float())
    return y.to(x.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        scale: float | None = None) -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, T, KV, hd) with H % KV == 0: query head h
    reads kv head h // (H // KV); KV == H is the reference's pre-broadcast
    call.  f32 scores over sqrt(hd) (the reference's), or times `scale`
    where one is given (the flash kernel's); -1e30 above the diagonal; f32
    softmax; the probabilities cast to v.dtype for the second product.
    One kv head's group of query heads at a time, so the (S, T) scores of
    only H / KV heads are held at once."""
    S, H, hd = q.shape[1], q.shape[2], q.shape[3]
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    keep = None
    if causal:
        keep = (torch.arange(T, device=q.device)[None, :]
                <= torch.arange(S, device=q.device)[:, None])
    outs = []
    for h in range(KV):
        s = torch.einsum("bsgd,btd->bgst", q[:, :, h * G:(h + 1) * G].float(),
                         k[:, :, h].float())
        if scale is None:
            s = s / torch.tensor(math.sqrt(hd), dtype=torch.float32)
        else:
            s = s * scale
        if keep is not None:
            s = torch.where(keep, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bgst,btd->bsgd", p.to(v.dtype), v[:, :, h]))
    return torch.cat(outs, dim=2)
