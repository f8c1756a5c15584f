"""GQA attention: full-sequence, chunked long-prompt and one-token decode.

Shapes as in `src/repro/models/attention.py`: x (B, S, D); q (B, S, H, hd);
k/v (B, T, KV, hd).  GQA is computed with grouped einsums (no
materialized KV repeat); scores and softmax are f32.

A prompt of `cfg.chunked_attn_threshold` tokens or more takes the
flash-style path, as in the reference: on CUDA tensors the hand-written
flash kernel (`kernels/flash_attention.py`), which also carries the
gradient there (its backward kernels, `csrc/flash_attention_bwd.cu`), so
training at these lengths runs on the card; on CPU tensors its plain
version on the model's path, `chunked_attention`, which autograd
differentiates.

A sliding window of W keys (`window=W`, the reference's serving of long
contexts on dense archs) masks key t for query s unless s - W < t <= s,
in every path: the full mask, `chunked_attention` (which skips the kv
chunks below the window where the reference does) and the flash kernel
(which skips the key tiles below it).  Decode needs no mask for it: a
cache of T = W slots written at pos % W holds exactly the window.

Not ported yet: cross attention and MLA.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import P, apply_rope, linear, rms_norm

NEG_INF = -1e30


def gqa_spec(cfg: ModelConfig):
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    dt = cfg.param_dtype
    spec = {
        "wq": P((D, H * hd), ("embed", "heads"), dtype=dt),
        "wk": P((D, KV * hd), ("embed", "kv_heads"), dtype=dt),
        "wv": P((D, KV * hd), ("embed", "kv_heads"), dtype=dt),
        "wo": P((H * hd, D), ("heads", "embed"), dtype=dt),
    }
    if cfg.qk_norm:
        spec["q_norm"] = P((hd,), (None,), init="ones", dtype=dt)
        spec["k_norm"] = P((hd,), (None,), init="ones", dtype=dt)
    return spec


def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window=None):
    """Bool mask (..., S, T): True = attend: key k <= query q and, given a
    window W, k > q - W (W keys including the query's own)."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        m &= k_pos[..., None, :] > (q_pos[..., :, None] - window)
    return m


def _grouped_scores(q, k, scale):
    """q (B,S,KV,G,hd), k (B,T,KV,hd) -> (B,KV,G,S,T) in f32."""
    return torch.einsum("bskgh,btkh->bkgst", q.float(), k.float()) * scale


def _grouped_out(probs, v):
    """probs (B,KV,G,S,T), v (B,T,KV,hd) -> (B,S,KV,G,hd)."""
    return torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype), v)


def full_attention(q, k, v, mask, scale):
    """q (B,S,H,hd) grouped against k/v (B,T,KV,hd); mask (S,T) bool, or
    None for full (bidirectional) attention."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    scores = _grouped_scores(q.reshape(B, S, KV, H // KV, hd), k, scale)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return _grouped_out(probs, v).reshape(B, S, H, hd)


def _chunk_sizes(S: int, T: int, cq: int, ckv: int):
    """The reference's chunk contract: chunks capped at the lengths, which
    they must divide."""
    cq, ckv = min(cq, S), min(ckv, T)
    if S % cq or T % ckv:
        raise ValueError(f"chunked attention needs S % cq == 0 and T % ckv "
                         f"== 0, got S={S}, cq={cq}, T={T}, ckv={ckv}")
    return cq, ckv


def _grouped_out_f32(probs, v):
    return torch.einsum("bkgst,btkh->bskgh", probs, v.float())


def chunked_attention(q, k, v, scale, *, causal: bool, window=None, cq: int,
                      ckv: int, q_offset: int = 0):
    """Flash-style online-softmax attention, chunked over both q and kv.

    Memory is O(cq * ckv) per (head, chunk) instead of O(S * T).  The plain
    version of the flash kernel on the model's path (what `gqa_forward`
    runs on the CPU at long prompts), ported from the reference's function
    of the same name.  q (B, S, H, hd); k, v (B, T, KV, hd); q tokens are at
    positions q_offset + i.  Under `causal`, a window W masks the keys at
    or below q - W.
    """
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    hdv = v.shape[-1]
    G = H // KV
    cq, ckv = _chunk_sizes(S, T, cq, ckv)
    nq, nkv = S // cq, T // ckv
    qg = q.reshape(B, nq, cq, KV, G, hd)
    kc = k.reshape(B, nkv, ckv, KV, hd)
    vc = v.reshape(B, nkv, ckv, KV, hdv)
    q_pos_all = q_offset + torch.arange(S, device=q.device).reshape(nq, cq)
    k_pos_all = torch.arange(T, device=q.device).reshape(nkv, ckv)
    # the reference skips kv chunks above the diagonal and below the window
    # only for few q chunks (its fori_loop branch); otherwise it scans every
    # kv chunk (lax.map of lax.scan).  Both branches are kept, so each has a
    # CPU counterpart.
    skip = causal and q_offset == 0 and S == T and nq <= 8
    outs = []
    for i in range(nq):
        qi, q_pos = qg[:, i], q_pos_all[i]
        m = torch.full((B, KV, G, cq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, KV, G, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, cq, KV, G, hdv), dtype=torch.float32,
                          device=q.device)
        hi = min(((i + 1) * cq + ckv - 1) // ckv, nkv) if skip else nkv
        lo = max((i * cq - window) // ckv, 0) if skip and window else 0
        for j in range(lo, hi):
            s = _grouped_scores(qi, kc[:, j], scale)          # (B,KV,G,cq,ckv)
            if causal:
                s = torch.where(causal_mask(q_pos, k_pos_all[j], window), s,
                                NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] \
                + _grouped_out_f32(p, vc[:, j])
            m = m_new
        outs.append(acc / l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None])
    out = torch.stack(outs, dim=1).reshape(B, S, H, hdv)
    return out.to(q.dtype)


def decode_attention(q1, k, v, scale, *, valid):
    """Single-token decode: q1 (B,1,H,hd), k/v (B,T,KV,hd).  `valid` bool
    masks unfilled cache slots: (T,) shared, or (B, T) per row (continuous
    batching serves lanes at different positions)."""
    B, _, H, hd = q1.shape
    KV = k.shape[2]
    s = _grouped_scores(q1.reshape(B, 1, KV, H // KV, hd), k, scale)  # (B,KV,G,1,T)
    if valid.ndim == 2:
        valid = valid[:, None, None, None, :]                       # (B,1,1,1,T)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return _grouped_out(p, v).reshape(B, 1, H, v.shape[-1])


def cache_valid_mask(T: int, pos: torch.Tensor):
    """Valid cache slots after writing at slot (pos % T): every slot j <= pos,
    or all slots once a rolling buffer has wrapped (pos >= T).  pos () ->
    (T,); pos (B,) -> (B, T) per-row masks."""
    p = pos[..., None]
    return (torch.arange(T, device=pos.device) <= p) | (p >= T)


def _decode_positions(pos: torch.Tensor):
    """Rope positions for one decode step: () -> (1,) shared; (B,) ->
    (B, 1) per row (each lane rotates by its own position)."""
    return pos[None] if pos.ndim == 0 else pos[:, None]


def _cache_write(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor):
    """Write this step's (B, 1, ...) entry at slot pos % T, IN PLACE (the
    reference rebuilds the leaf functionally; the port updates the serving
    cache where it lies).  Scalar pos writes one slot for every row; a (B,)
    pos writes one slot per row (continuous-batching lanes)."""
    T = cache.shape[1]
    slot = torch.remainder(pos, T).long()
    if slot.ndim:
        cache[torch.arange(cache.shape[0], device=cache.device), slot] = \
            new[:, 0].to(cache.dtype)
    else:
        cache.index_copy_(1, slot[None], new.to(cache.dtype))
    return cache


def _maybe_qk_norm(params, q, k, cfg):
    if cfg.qk_norm and "q_norm" in params:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    return q, k


def gqa_forward(params, x, cfg: ModelConfig, *, lora=None, lora_scale=1.0,
                window=None, causal=True, return_kv=False):
    """Self attention over a full sequence at positions 0..S-1, causal (with
    an optional sliding window of `window` keys) or (`causal=False`, the
    classifiers' encoder) full with no mask; RoPE is applied either way, as
    in the reference.  A causal prompt of `cfg.chunked_attn_threshold`
    tokens or more takes the flash-style path: the CUDA flash kernel on
    CUDA tensors (forward and, when autograd records, backward, under a
    window and at every head size), `chunked_attention` on the CPU, both
    held to the reference's chunk contract (`attn_chunk_q`/`_kv` must
    divide S)."""
    B, S, D = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    lget = (lora or {}).get
    q = linear(x, params["wq"], lget("wq"), lora_scale).reshape(B, S, H, hd)
    k = linear(x, params["wk"], lget("wk"), lora_scale).reshape(B, S, KV, hd)
    v = linear(x, params["wv"], lget("wv"), lora_scale).reshape(B, S, KV, hd)
    q, k = _maybe_qk_norm(params, q, k, cfg)
    positions = torch.arange(S, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    scale = 1.0 / math.sqrt(hd)
    if causal and S >= cfg.chunked_attn_threshold:
        cq, ckv = _chunk_sizes(S, S, cfg.attn_chunk_q, cfg.attn_chunk_kv)
        if q.is_cuda:
            out = flash_attention(q, k, v, causal=True, scale=scale,
                                  window=window)
        else:
            out = chunked_attention(q, k, v, scale, causal=True,
                                    window=window, cq=cq, ckv=ckv)
    else:
        mask = causal_mask(positions, positions, window) if causal else None
        out = full_attention(q, k, v, mask, scale)
    y = linear(out.reshape(B, S, H * hd), params["wo"], lget("wo"), lora_scale)
    if return_kv:
        return y, (k, v)
    return y


def gqa_decode(params, x1, cache, pos, cfg: ModelConfig, *, lora=None,
               lora_scale=1.0, window=None):
    """One-token decode. cache = (k, v) with k/v (B, T, KV, hd), written in
    place at slot pos % T; under a sliding window T == W (a rolling buffer:
    the slots hold exactly the window, so `window` changes nothing here; it
    is taken for the reference's signature).  pos is () shared across the
    batch, or (B,) per row (continuous batching: each lane decodes at its
    own position)."""
    B = x1.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    lget = (lora or {}).get
    k_cache, v_cache = cache
    T = k_cache.shape[1]
    q = linear(x1, params["wq"], lget("wq"), lora_scale).reshape(B, 1, H, hd)
    k = linear(x1, params["wk"], lget("wk"), lora_scale).reshape(B, 1, KV, hd)
    v = linear(x1, params["wv"], lget("wv"), lora_scale).reshape(B, 1, KV, hd)
    q, k = _maybe_qk_norm(params, q, k, cfg)
    q = apply_rope(q, _decode_positions(pos), cfg.rope_theta)
    k = apply_rope(k, _decode_positions(pos), cfg.rope_theta)
    _cache_write(k_cache, k, pos)
    _cache_write(v_cache, v, pos)
    out = decode_attention(q, k_cache, v_cache, 1.0 / math.sqrt(hd),
                           valid=cache_valid_mask(T, pos))
    y = linear(out.reshape(B, 1, H * hd), params["wo"], lget("wo"), lora_scale)
    return y, (k_cache, v_cache)
