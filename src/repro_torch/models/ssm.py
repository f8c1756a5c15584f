"""Recurrent blocks: Mamba-style selective SSM (Hymba's hybrid heads) and
xLSTM's mLSTM / sLSTM, from `src/repro/models/ssm.py`.

Same names, specs and arithmetic as the reference; one device, so no
sharding constraints.  Where the reference scans, the port:

* Mamba: the coefficients, the recurrence and the readout (`h C + D u`) go
  through `kernels/selective_scan.py` (on the card the hand-written CUDA
  kernels, on the CPU their plain versions), in `mamba_forward_state` and
  `mamba_decode` alike: decode is the scan at S = 1 from the lane's state.
  Training takes the same call: while autograd records, the scan's
  Function runs the forward kernels and, in the backward pass, the
  backward's (the reference differentiates its scan with `jax.grad`).
  The reference's chunked `associative_scan` sums in another order than the
  sequential scan; any S is taken (the reference asserts S % 256 == 0 past
  256 tokens, ROADMAP queue 3 item 5(f)).
* mLSTM: the reference's stabilized chunk form (`_mlstm_chunk`), a Python
  loop over chunks of `cfg.mlstm_chunk`, with its identity-gate padding.
* sLSTM: the reference's cell, a Python loop over t.
The mLSTM chunk and sLSTM step loops are plain PyTorch, which autograd
differentiates (their kernels are ROADMAP queue 1 item 13).

Decode updates the state it is given IN PLACE (as the port's KV cache) and
returns it.  A paged adapter (a `gidx` leaf, `serving/cache.py::
paged_lora`) reaches every target: the 2-D ones through `linear`'s grouped
kernel, the headwise (H, hd, r) ones of mLSTM's wq / wk / wv through a
per-lane gather of the page and an einsum.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import P, gelu, linear, lora_delta, rms_norm

# ---------------------------------------------------------------------------
# Mamba-style selective SSM
# ---------------------------------------------------------------------------


def mamba_inner_dim(cfg: ModelConfig) -> int:
    return cfg.ssm_expand * cfg.num_heads * cfg.hd


def mamba_spec(cfg: ModelConfig):
    D = cfg.d_model
    di = mamba_inner_dim(cfg)
    N = cfg.ssm_state_size
    dt = cfg.param_dtype
    return {
        "in_proj": P((D, 2 * di), ("embed", "mlp"), dtype=dt),
        "conv_w": P((cfg.ssm_conv_width, di), (None, "mlp"), dtype=dt,
                    fan_in=cfg.ssm_conv_width),
        "conv_b": P((di,), ("mlp",), init="zeros", dtype=dt),
        "w_dt": P((di, 1), ("mlp", None), dtype="float32", fan_in=di),
        "dt_bias": P((di,), ("mlp",), init="zeros", dtype="float32"),
        "w_B": P((di, N), ("mlp", None), dtype=dt, fan_in=di),
        "w_C": P((di, N), ("mlp", None), dtype=dt, fan_in=di),
        "A_log": P((di, N), ("mlp", None), init="zeros", dtype="float32"),
        "D_skip": P((di,), ("mlp",), init="ones", dtype="float32"),
        "out_proj": P((di, D), ("mlp", "embed"), dtype=dt),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv. x (B,S,di), w (W,di)."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = sum(xp[:, i:i + S] * w[i] for i in range(W))
    return out + b


def _ssm_coeffs(params, u):
    """u (B,S,di) post-conv activations -> Bc, Cc (B,S,N) f32, the scan's
    input and readout projections (the decay and drive are formed inside
    `selective_scan`)."""
    uf = u.float()
    return (torch.matmul(uf, params["w_B"].float()),
            torch.matmul(uf, params["w_C"].float()))


def _scan(params, u, h0=None, out_state=None):
    Bc, Cc = _ssm_coeffs(params, u)
    return selective_scan(u, params["w_dt"], params["dt_bias"],
                          params["A_log"], params["D_skip"], Bc, Cc, h0,
                          out_state=out_state)


def mamba_forward_state(params, x, cfg: ModelConfig, *, lora=None, ls=1.0):
    """x (B,S,D) -> (y (B,S,D), decode_state), any S."""
    lget = (lora or {}).get
    S = x.shape[1]
    W = cfg.ssm_conv_width
    xz = linear(x, params["in_proj"], lget("in_proj"), ls)
    u_pre, z = torch.chunk(xz, 2, dim=-1)
    u = F.silu(_causal_conv(u_pre, params["conv_w"], params["conv_b"]))
    y, h_last = _scan(params, u)
    y = y.to(x.dtype) * F.silu(z)
    conv_state = F.pad(u_pre, (0, 0, max(W - 1 - S, 0), 0))[:, -(W - 1):]
    state = {"conv": conv_state.float(), "h": h_last}
    return linear(y, params["out_proj"], lget("out_proj"), ls), state


def mamba_init_state(cfg: ModelConfig, batch: int, dtype=torch.float32):
    di = mamba_inner_dim(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, di), dtype=dtype),
        "h": torch.zeros((batch, di, cfg.ssm_state_size), dtype=torch.float32),
    }


def mamba_decode(params, x1, state, cfg: ModelConfig, *, lora=None, ls=1.0):
    """Single-step recurrence. x1 (B,1,D); `state` updated in place."""
    lget = (lora or {}).get
    xz = linear(x1, params["in_proj"], lget("in_proj"), ls)
    u, z = torch.chunk(xz, 2, dim=-1)                   # (B,1,di)
    conv = state["conv"]
    window = torch.cat([conv, u.to(conv.dtype)], dim=1)
    u = torch.einsum("bwd,wd->bd", window, params["conv_w"].to(window.dtype))
    u = F.silu(u + params["conv_b"])[:, None]           # (B,1,di), f32
    y, _ = _scan(params, u, h0=state["h"], out_state=state["h"])
    y = y.to(x1.dtype) * F.silu(z)
    out = linear(y, params["out_proj"], lget("out_proj"), ls)
    conv.copy_(window[:, 1:])
    return out, state


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory, chunked parallel) and sLSTM (sequential)
# ---------------------------------------------------------------------------

def mlstm_inner(cfg: ModelConfig) -> Tuple[int, int]:
    di = 2 * cfg.d_model                                  # proj factor 2
    return di, di // cfg.num_heads


def _headwise(u_heads, w, lora=None, ls=1.0):
    """Block-diagonal linear: u (B, S, H, hd) @ w (H, hd, hd).  A paged
    adapter's pools a (H, G, hd, r), b (H, G, r, hd) are gathered per lane
    (gidx (H, B): each batch row's page)."""
    y = torch.einsum("bshd,hde->bshe", u_heads, w.to(u_heads.dtype))
    if lora is not None:
        a, b = lora["a"], lora["b"]
        xin = u_heads.to(a.dtype)
        if "gidx" in lora:
            g = lora["gidx"][0].long()
            xa = torch.einsum("bshd,hbdr->bshr", xin, a[:, g])
            d = torch.einsum("bshr,hbre->bshe", xa, b[:, g])
        else:
            xa = torch.einsum("bshd,hdr->bshr", xin, a)
            d = torch.einsum("bshr,hre->bshe", xa, b)
        y = y + (ls * d).to(y.dtype)
    return y


def mlstm_spec(cfg: ModelConfig):
    D = cfg.d_model
    di, hd = mlstm_inner(cfg)
    H = cfg.num_heads
    dt = cfg.param_dtype
    return {
        "up": P((D, 2 * di), ("embed", None), dtype=dt),       # (u | gate z)
        # block-diagonal per-head projections (xLSTM "linear_headwise")
        "wq": P((H, hd, hd), (None, None, None), dtype=dt, fan_in=hd),
        "wk": P((H, hd, hd), (None, None, None), dtype=dt, fan_in=hd),
        "wv": P((H, hd, hd), (None, None, "heads"), dtype=dt, fan_in=hd),
        "w_if": P((di, 2 * H), (None, None), dtype="float32"),  # input/forget gates
        "b_if": P((2 * H,), (None,), init="zeros", dtype="float32"),
        "out_norm": P((di,), (None,), init="ones", dtype=dt),
        "down": P((di, D), (None, "embed"), dtype=dt),
    }


def _mlstm_chunk(q, k, v, logf, logi, carry):
    """Stabilized quadratic intra-chunk mLSTM.
    q,k,v (B,L,H,hd); logf/logi (B,L,H); carry = (C (B,H,hd,hd), n (B,H,hd), m (B,H))."""
    L, hd = q.shape[1], q.shape[3]
    C0, n0, m0 = carry
    Fc = torch.cumsum(logf, dim=1)                        # inclusive (B,L,H)
    # intra-chunk log-decay matrix: D[t,s] = F_t - F_s + logi_s  (s <= t)
    Dm = Fc[:, :, None] - Fc[:, None, :] + logi[:, None, :]   # (B,L,L,H)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    tri = tri[None, :, :, None]
    Dm = torch.where(tri, Dm, -math.inf)
    m_intra = Dm.amax(dim=2)                               # (B,L,H)
    m_inter = Fc + m0[:, None]                             # carry-in stabilizer
    m = torch.clamp_min(torch.maximum(m_intra, m_inter), -1e30)

    scale = 1.0 / math.sqrt(hd)
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.einsum("blhd,bshd->blsh", qf, kf) * scale
    w = s * torch.exp(Dm - m[:, :, None])                  # (B,L,L,H)
    w = torch.where(tri, w, 0.0)
    inter_w = torch.exp(m_inter - m)                       # (B,L,H)
    h_intra = torch.einsum("blsh,bshd->blhd", w, vf)
    qs = qf * scale
    h_inter = torch.einsum("blhd,bhde->blhe", qs, C0) * inter_w[..., None]
    n_t = w.sum(dim=2) + inter_w * torch.einsum("blhd,bhd->blh", qs, n0)
    denom = torch.maximum(n_t.abs(), torch.exp(-m))        # xLSTM normalizer
    h = (h_intra + h_inter) / denom[..., None]

    # carry update to chunk end
    FL = Fc[:, -1]                                         # (B,H)
    m_new = torch.maximum(FL + m0, (Fc[:, -1:, :] - Fc + logi).amax(dim=1))
    decay_k = torch.exp(FL[:, None] - Fc + logi - m_new[:, None])   # (B,L,H)
    carry_w = torch.exp(FL + m0 - m_new)
    kd = decay_k[..., None] * kf
    C_new = carry_w[..., None, None] * C0 + torch.einsum("blhd,blhe->bhde",
                                                         kd, vf)
    n_new = carry_w[..., None] * n0 + kd.sum(dim=1)
    return h, (C_new, n_new, m_new)


def _mlstm_gates(params, u, H: int):
    gif = torch.matmul(u.float(), params["w_if"]) + params["b_if"]
    return gif[..., :H], F.logsigmoid(gif[..., H:])       # logi, logf


def _mlstm_out(params, h, z, cfg: ModelConfig, lora, ls):
    """Per-head RMS norm (xLSTM MultiHeadNorm), the gate and `down`."""
    B, S, H, hd = h.shape
    di = H * hd
    h = rms_norm(h, params["out_norm"].reshape(H, hd), cfg.norm_eps)
    h = (h * F.silu(z).reshape(B, S, H, hd)).reshape(B, S, di)
    y = torch.matmul(h, params["down"].to(h.dtype))
    if lora is not None:
        y = y + lora_delta(h, lora, ls).to(y.dtype)
    return y


def mlstm_forward_state(params, x, cfg: ModelConfig, *, lora=None, ls=1.0):
    lget = (lora or {}).get
    B, S, _ = x.shape
    H = cfg.num_heads
    _, hd = mlstm_inner(cfg)
    u, z = torch.chunk(linear(x, params["up"]), 2, dim=-1)   # (B,S,di)
    uh = u.reshape(B, S, H, hd)
    q = _headwise(uh, params["wq"], lget("wq"), ls)
    k = _headwise(uh, params["wk"], lget("wk"), ls)
    v = _headwise(uh, params["wv"], lget("wv"), ls)
    logi, logf = _mlstm_gates(params, u, H)

    L = min(cfg.mlstm_chunk, S)
    pad = (-S) % L
    if pad:
        # pad the recurrence with identity gates: f=1 (logf=0) carries the
        # state through, i=0 (logi=-1e30) contributes nothing -- padded
        # positions produce garbage outputs that are sliced off below.
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        logf = F.pad(logf, (0, 0, 0, pad))
        logi = F.pad(logi, (0, 0, 0, pad), value=-1e30)
    carry = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device),
             torch.zeros((B, H, hd), dtype=torch.float32, device=x.device),
             torch.zeros((B, H), dtype=torch.float32, device=x.device))
    hs = []
    for c0 in range(0, S + pad, L):
        sl = slice(c0, c0 + L)
        h, carry = _mlstm_chunk(q[:, sl], k[:, sl], v[:, sl], logf[:, sl],
                                logi[:, sl], carry)
        hs.append(h)
    h = torch.cat(hs, dim=1)[:, :S].to(x.dtype)
    y = _mlstm_out(params, h, z, cfg, lget("down"), ls)
    Cf, nf, mf = carry
    return y, {"C": Cf, "n": nf, "m": mf}


def mlstm_init_state(cfg: ModelConfig, batch: int):
    H = cfg.num_heads
    _, hd = mlstm_inner(cfg)
    return {"C": torch.zeros((batch, H, hd, hd)),
            "n": torch.zeros((batch, H, hd)),
            "m": torch.zeros((batch, H))}


def mlstm_decode(params, x1, state, cfg: ModelConfig, *, lora=None, ls=1.0):
    """One step. x1 (B,1,D); `state` updated in place."""
    lget = (lora or {}).get
    B = x1.shape[0]
    H = cfg.num_heads
    _, hd = mlstm_inner(cfg)
    u, z = torch.chunk(linear(x1, params["up"]), 2, dim=-1)
    uh = u.reshape(B, 1, H, hd)
    q = _headwise(uh, params["wq"], lget("wq"), ls)[:, 0]
    k = _headwise(uh, params["wk"], lget("wk"), ls)[:, 0]
    v = _headwise(uh, params["wv"], lget("wv"), ls)[:, 0]
    logi, logf = _mlstm_gates(params, u[:, 0], H)
    m_new = torch.maximum(logf + state["m"], logi)
    fw = torch.exp(logf + state["m"] - m_new)
    iw = torch.exp(logi - m_new)
    kf = k.float()
    C = fw[..., None, None] * state["C"] \
        + iw[..., None, None] * kf[..., :, None] * v.float()[..., None, :]
    n = fw[..., None] * state["n"] + iw[..., None] * kf
    qs = q.float() / math.sqrt(hd)
    num = torch.einsum("bhd,bhde->bhe", qs, C)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", qs, n).abs(),
                        torch.exp(-m_new))
    h = (num / den[..., None])[:, None].to(x1.dtype)         # (B,1,H,hd)
    y = _mlstm_out(params, h, z, cfg, lget("down"), ls)
    state["C"].copy_(C)
    state["n"].copy_(n)
    state["m"].copy_(m_new)
    return y, state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_spec(cfg: ModelConfig):
    D = cfg.d_model
    H, hd = cfg.num_heads, cfg.d_model // cfg.num_heads
    dt = cfg.param_dtype
    ff = int(round(cfg.d_model * 4 / 3 / 64) * 64)
    return {
        "wx": P((D, 4 * D), ("embed", None), dtype=dt),          # z,i,f,o pre-acts
        "r": P((H, hd, 4 * hd), (None, None, None), dtype=dt, fan_in=hd),
        "b": P((4 * D,), (None,), init="zeros", dtype="float32"),
        "out_norm": P((D,), ("embed",), init="ones", dtype=dt),
        "up1": P((D, ff), ("embed", "mlp"), dtype=dt),
        "up2": P((D, ff), ("embed", "mlp"), dtype=dt),
        "down": P((ff, D), ("mlp", "embed"), dtype=dt),
    }


def _slstm_cell(params, gx, hcnm, cfg):
    """One step. gx (B,4D) input pre-activations; state tuple of (B,H,hd)."""
    h, c, n, m = hcnm
    B = gx.shape[0]
    H, hd = cfg.num_heads, cfg.d_model // cfg.num_heads
    r = params["r"]
    rec = torch.einsum("bhd,hdg->bhg", h.to(r.dtype), r)
    g = gx.reshape(B, H, 4 * hd).float() + rec.float() \
        + params["b"].reshape(H, 4 * hd)
    z, i_t, f_t, o = torch.chunk(g, 4, dim=-1)
    z = torch.tanh(z)
    o = torch.sigmoid(o)
    logf = F.logsigmoid(f_t)
    m_new = torch.maximum(logf + m, i_t)
    fw = torch.exp(logf + m - m_new)
    iw = torch.exp(i_t - m_new)
    c_new = fw * c + iw * z
    n_new = fw * n + iw
    h_new = o * c_new / torch.clamp_min(n_new.abs(), 1.0)
    return h_new, c_new, n_new, m_new


def _slstm_out(params, h, cfg: ModelConfig, lora, ls):
    lget = (lora or {}).get
    h = rms_norm(h, params["out_norm"], cfg.norm_eps)
    up = gelu(linear(h, params["up1"])) * linear(h, params["up2"])
    return linear(up, params["down"], lget("down"), ls)


def slstm_forward_state(params, x, cfg: ModelConfig, *, lora=None, ls=1.0):
    lget = (lora or {}).get
    B, S, D = x.shape
    H, hd = cfg.num_heads, D // cfg.num_heads
    gx = linear(x, params["wx"], lget("wx"), ls)            # (B,S,4D)
    z0 = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
    state = (z0, z0, z0, torch.full((B, H, hd), -1e30, dtype=torch.float32,
                                    device=x.device))
    hs = []
    for t in range(S):
        state = _slstm_cell(params, gx[:, t], state, cfg)
        hs.append(state[0])
    h = torch.stack(hs, dim=1).reshape(B, S, D).to(x.dtype)
    hf, cf, nf, mf = state
    return _slstm_out(params, h, cfg, lora, ls), \
        {"h": hf, "c": cf, "n": nf, "m": mf}


def slstm_init_state(cfg: ModelConfig, batch: int):
    H, hd = cfg.num_heads, cfg.d_model // cfg.num_heads
    return {"h": torch.zeros((batch, H, hd)), "c": torch.zeros((batch, H, hd)),
            "n": torch.zeros((batch, H, hd)),
            "m": torch.full((batch, H, hd), -1e30)}


def slstm_decode(params, x1, state, cfg: ModelConfig, *, lora=None, ls=1.0):
    """One step. x1 (B,1,D); `state` updated in place."""
    lget = (lora or {}).get
    B, _, D = x1.shape
    gx = linear(x1, params["wx"], lget("wx"), ls)[:, 0]
    new = _slstm_cell(params, gx, (state["h"], state["c"], state["n"],
                                   state["m"]), cfg)
    out = new[0].reshape(B, 1, D).to(x1.dtype)
    for key, t in zip("hcnm", new):
        state[key].copy_(t)
    return _slstm_out(params, out, cfg, lora, ls), state
