"""Model assembly: specs, the layer loop, forward / prefill / decode.

The dense `attn_mlp` models of `src/repro/models/model.py`: causal token
LMs, and the paper's task models (a ViT-style classifier over embedding
inputs, GPT-style classifiers and LMs with learned positions).  Params are
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
from repro_torch.models.layers import (P, chunked_softmax_ce, cross_entropy,
                                       layer_slice, linear, mlp_apply,
                                       mlp_spec, param_count, rms_norm,
                                       stack_spec, torch_dtype)


def check_supported(cfg: ModelConfig) -> None:
    """The port builds dense models of `attn_mlp` blocks: causal token LMs
    and the paper's task models (embedding inputs, learned positions, a
    mean-pooled classifier head), for `forward` and `loss_fn`."""
    _refuse(cfg, (
        ("MLA", cfg.use_mla), ("MoE", cfg.num_experts > 0),
        ("encoder-decoder", cfg.encoder_decoder),
        ("image tokens", cfg.num_image_tokens > 0),
        ("multi-token prediction", cfg.mtp_depth > 0),
        ("sliding window", cfg.sliding_window is not None)), "build")


def check_servable(cfg: ModelConfig) -> None:
    """`prefill` and `decode_step` serve causal token LMs only: the task
    models' embedding inputs, classifier heads and learned positions are
    not served (see ROADMAP queue 3 on the reference's decode of learned
    positions)."""
    check_supported(cfg)
    _refuse(cfg, (("embedding inputs", cfg.embed_inputs),
                  ("classifier head", cfg.num_classes > 0),
                  ("learned positions", cfg.use_learned_pos)), "serve")


def _refuse(cfg: ModelConfig, features, verb: str) -> None:
    missing = [name for name, off in features if off]
    kinds = [k for k, _ in cfg.layer_groups()]
    if kinds != [ATTN_MLP]:
        missing.append(f"block kinds {kinds}")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the port does not {verb} {', '.join(missing)} yet")


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
    spec: Dict[str, Any] = {}
    if not cfg.embed_inputs:
        spec["embed"] = P((V, D), ("vocab", "embed"), init="embed", dtype=dt)
    if cfg.use_learned_pos:
        spec["pos_embed"] = P((cfg.max_seq, D), (None, "embed"), init="embed",
                              dtype=dt)
    spec["groups"] = {"g0": stack_spec(block_spec(cfg), cfg.num_layers)}
    spec["final_norm"] = P((D,), ("embed",), init="ones", dtype=dt)
    if cfg.num_classes > 0:
        spec["cls_head"] = P((D, cfg.num_classes), ("embed", None),
                             dtype="float32")
    elif not cfg.tie_embeddings:
        spec["lm_head"] = P((D, V), ("embed", "vocab"), dtype=dt)
    return spec


def count_params(cfg: ModelConfig) -> int:
    return param_count(model_spec(cfg))


# ---------------------------------------------------------------------------
# block forward / decode
# ---------------------------------------------------------------------------

def _sub(lora, key):
    return (lora or {}).get(key) or None


def block_forward(lp, x, cfg: ModelConfig, *, lora, ls, causal=True,
                  want_cache=False):
    """Returns (x, cache_dict)."""
    cache: Dict[str, Any] = {}
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    y = A.gqa_forward(lp["attn"], h, cfg, lora=_sub(lora, "attn"),
                      lora_scale=ls, causal=causal, return_kv=want_cache)
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


def embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor,
                 pos_offset: int = 0):
    """Token embeddings, plus the learned positions pos_offset.. when the
    model has them."""
    x = params["embed"][tokens]
    if cfg.use_learned_pos:
        S = tokens.shape[-1]
        x = x + params["pos_embed"][pos_offset:pos_offset + S]
    return x


def forward(params, cfg: ModelConfig, batch: Dict[str, Any], *, lora=None,
            lora_scale: float = 1.0, want_cache: bool = False,
            want_logits: bool = True):
    """Full-sequence forward over batch['tokens'] (B, S), or over
    batch['embeds'] (B, S, D) for a model with `embed_inputs`.  Attention
    is causal for LMs and bidirectional for classifiers (`num_classes >
    0`), whose logits are the f32 head over the mean of the final hidden
    states.  Returns dict(hidden, logits, cache); cache leaves are stacked
    (L, B, S, ...).  want_logits=False skips an LM's (B, S, V) logits (the
    loss path takes the chunked vocab CE on `hidden` instead)."""
    check_supported(cfg)
    causal = cfg.num_classes == 0
    if cfg.embed_inputs:
        x = batch["embeds"].to(torch_dtype(cfg.compute_dtype))
        if cfg.use_learned_pos:
            x = x + params["pos_embed"][:x.shape[-2]]
    else:
        x = embed_tokens(params, cfg, batch["tokens"])
    gp = params["groups"]["g0"]
    gl = (lora or {}).get("g0") or {}
    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, c = block_forward(layer_slice(gp, i), x, cfg,
                             lora=layer_slice(gl, i), ls=lora_scale,
                             causal=causal, want_cache=want_cache)
        if want_cache:
            ks.append(c["self"][0])
            vs.append(c["self"][1])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    out: Dict[str, Any] = {"hidden": x}
    if cfg.num_classes > 0:
        pooled = torch.mean(x, dim=-2)
        out["logits"] = torch.matmul(pooled.float(), params["cls_head"])
    elif want_logits:
        out["logits"] = linear(x, _lm_head(params, cfg))
    if want_cache:
        out["cache"] = {"g0": {"self": (torch.stack(ks), torch.stack(vs))}}
    return out


def loss_fn(params, cfg: ModelConfig, batch, *, lora=None,
            lora_scale: float = 1.0, loss_chunk: int = 1024):
    """A classifier's mean CE of its logits against batch['labels']; an
    LM's mean next-token CE of batch['tokens'] (..., S), masked by
    batch['loss_mask'] when present.  The reference's `loss_fn` without
    multi-token prediction (which raises in `check_supported`); the dense
    block adds no auxiliary loss."""
    out = forward(params, cfg, batch, lora=lora, lora_scale=lora_scale,
                  want_logits=False)
    if cfg.num_classes > 0:
        return cross_entropy(out["logits"], batch["labels"])
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
    check_servable(cfg)
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
    check_servable(cfg)
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
