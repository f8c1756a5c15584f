"""Model assembly: specs, the layer loop, forward / prefill / decode.

The dense `attn_mlp` decoder of `src/repro/models/model.py`.  Params are
stacked on a leading layer axis as in the reference; where the reference
runs `lax.scan` over that axis, the port runs a Python loop over layer
slices (views, no copies).  One device, so no sharding constraints.

The decode KV cache is updated in place (see `attention._cache_write`):
`decode_step` returns the cache it was given, now holding the new slot.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import attention as A
from repro_torch.models.config import ATTN_MLP, ModelConfig
from repro_torch.models.layers import (P, chunked_softmax_ce, layer_slice,
                                       linear, mlp_apply, mlp_spec,
                                       param_count, rms_norm, stack_spec)


def check_supported(cfg: ModelConfig) -> None:
    """The port builds causal dense token LMs of `attn_mlp` blocks only."""
    missing = [name for name, off in (
        ("MLA", cfg.use_mla), ("MoE", cfg.num_experts > 0),
        ("encoder-decoder", cfg.encoder_decoder),
        ("embedding inputs", cfg.embed_inputs),
        ("image tokens", cfg.num_image_tokens > 0),
        ("multi-token prediction", cfg.mtp_depth > 0),
        ("classifier head", cfg.num_classes > 0),
        ("learned positions", cfg.use_learned_pos),
        ("sliding window", cfg.sliding_window is not None)) if off]
    kinds = [k for k, _ in cfg.layer_groups()]
    if kinds != [ATTN_MLP]:
        missing.append(f"block kinds {kinds}")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the port does not build {', '.join(missing)} yet")


def _dense_ff(cfg: ModelConfig) -> int:
    return cfg.dense_d_ff if cfg.dense_d_ff else cfg.d_ff


def block_spec(cfg: ModelConfig):
    D, dt = cfg.d_model, cfg.param_dtype
    return {"attn_norm": P((D,), ("embed",), init="ones", dtype=dt),
            "attn": A.gqa_spec(cfg),
            "mlp_norm": P((D,), ("embed",), init="ones", dtype=dt),
            "mlp": mlp_spec(D, _dense_ff(cfg), cfg.activation, dt)}


def model_spec(cfg: ModelConfig):
    check_supported(cfg)
    D, V, dt = cfg.d_model, cfg.vocab_size, cfg.param_dtype
    spec: Dict[str, Any] = {
        "embed": P((V, D), ("vocab", "embed"), init="embed", dtype=dt),
        "groups": {"g0": stack_spec(block_spec(cfg), cfg.num_layers)},
        "final_norm": P((D,), ("embed",), init="ones", dtype=dt),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = P((D, V), ("embed", "vocab"), dtype=dt)
    return spec


def count_params(cfg: ModelConfig) -> int:
    return param_count(model_spec(cfg))


# ---------------------------------------------------------------------------
# block forward / decode
# ---------------------------------------------------------------------------

def _sub(lora, key):
    return (lora or {}).get(key) or None


def block_forward(lp, x, cfg: ModelConfig, *, lora, ls, want_cache=False):
    """Returns (x, cache_dict)."""
    cache: Dict[str, Any] = {}
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    y = A.gqa_forward(lp["attn"], h, cfg, lora=_sub(lora, "attn"),
                      lora_scale=ls, return_kv=want_cache)
    if want_cache:
        y, cache["self"] = y
    x = x + y
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    x = x + mlp_apply(lp["mlp"], h, cfg.activation, _sub(lora, "mlp"), ls)
    return x, cache


def block_decode(lp, x1, cache, pos, cfg: ModelConfig, *, lora, ls):
    """Returns (x1, cache) with cache['self'] written in place."""
    h = rms_norm(x1, lp["attn_norm"], cfg.norm_eps)
    y, kv = A.gqa_decode(lp["attn"], h, cache["self"], pos, cfg,
                         lora=_sub(lora, "attn"), lora_scale=ls)
    x1 = x1 + y
    h = rms_norm(x1, lp["mlp_norm"], cfg.norm_eps)
    x1 = x1 + mlp_apply(lp["mlp"], h, cfg.activation, _sub(lora, "mlp"), ls)
    return x1, {"self": kv}


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------

def _lm_head(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor):
    return params["embed"][tokens]


def forward(params, cfg: ModelConfig, batch: Dict[str, Any], *, lora=None,
            lora_scale: float = 1.0, want_cache: bool = False,
            want_logits: bool = True):
    """Full-sequence forward over batch['tokens'] (B, S).  Returns
    dict(hidden, logits, cache); cache leaves are stacked (L, B, S, ...).
    want_logits=False skips the (B, S, V) logits (the loss path takes the
    chunked vocab CE on `hidden` instead)."""
    check_supported(cfg)
    x = embed_tokens(params, cfg, batch["tokens"])
    gp = params["groups"]["g0"]
    gl = (lora or {}).get("g0") or {}
    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, c = block_forward(layer_slice(gp, i), x, cfg,
                             lora=layer_slice(gl, i), ls=lora_scale,
                             want_cache=want_cache)
        if want_cache:
            ks.append(c["self"][0])
            vs.append(c["self"][1])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    out: Dict[str, Any] = {"hidden": x}
    if want_logits:
        out["logits"] = linear(x, _lm_head(params, cfg))
    if want_cache:
        out["cache"] = {"g0": {"self": (torch.stack(ks), torch.stack(vs))}}
    return out


def loss_fn(params, cfg: ModelConfig, batch, *, lora=None,
            lora_scale: float = 1.0, loss_chunk: int = 1024):
    """Mean next-token CE of batch['tokens'] (..., S), masked by
    batch['loss_mask'] when present: the LM branch of the reference's
    `loss_fn` (classifier heads and multi-token prediction raise in
    `check_supported`; the dense block adds no auxiliary loss)."""
    out = forward(params, cfg, batch, lora=lora, lora_scale=lora_scale,
                  want_logits=False)
    tokens = batch["tokens"]
    mask = batch.get("loss_mask", None)
    return chunked_softmax_ce(out["hidden"][..., :-1, :], _lm_head(params, cfg),
                              tokens[..., 1:],
                              None if mask is None else mask[..., 1:],
                              chunk=loss_chunk)


def prefill(params, cfg: ModelConfig, batch, *, lora=None, lora_scale=1.0,
            max_len: Optional[int] = None):
    """max_len pads the attention caches to serving capacity (slots beyond
    the prefilled length are masked out by decode's validity mask)."""
    out = forward(params, cfg, batch, lora=lora, lora_scale=lora_scale,
                  want_cache=True)
    k, v = out["cache"]["g0"]["self"]          # (L, B, S, KV, hd)
    if max_len is not None and k.shape[2] < max_len:
        pad = (0, 0, 0, 0, 0, max_len - k.shape[2])
        k = torch.nn.functional.pad(k, pad)
        v = torch.nn.functional.pad(v, pad)
    return out["logits"][..., -1:, :], {"g0": {"self": (k, v)}}


def decode_step(params, cfg: ModelConfig, token, pos, cache, *, lora=None,
                lora_scale: float = 1.0):
    """token (B,) int; pos () shared, or (B,) per row (the continuous-
    batching serving path: each lane at its own position); cache as
    returned by prefill or `cache_spec`, updated in place.  A paged lora
    tree (leaf dicts carrying `gidx`, see `serving/cache.py::paged_lora`)
    serves a different adapter per row through the same call.  Returns
    (logits (B,1,V), cache)."""
    check_supported(cfg)
    x1 = embed_tokens(params, cfg, token[:, None])
    gp = params["groups"]["g0"]
    gl = (lora or {}).get("g0") or {}
    gc = cache["g0"]
    for i in range(cfg.num_layers):
        x1, _ = block_decode(layer_slice(gp, i), x1, layer_slice(gc, i), pos,
                             cfg, lora=layer_slice(gl, i), ls=lora_scale)
    x1 = rms_norm(x1, params["final_norm"], cfg.norm_eps)
    return linear(x1, _lm_head(params, cfg)), cache


def cache_spec(cfg: ModelConfig, batch: int, cache_len: int):
    kv = P((batch, cache_len, cfg.num_kv_heads, cfg.hd),
           ("batch", "kv_seq", None, None), dtype=cfg.param_dtype)
    return {"g0": stack_spec({"self": (kv, kv)}, cfg.num_layers)}
