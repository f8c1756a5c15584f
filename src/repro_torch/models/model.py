"""Model assembly: specs, the layer loop, forward / prefill / decode.

The dense `attn_mlp` models of `src/repro/models/model.py`: causal token
LMs, and the paper's task models (a ViT-style classifier over embedding
inputs, GPT-style classifiers and LMs with learned positions).  Params are
stacked on a leading layer axis as in the reference; where the reference
runs `lax.scan` over that axis, the port runs a Python loop over layer
slices (views, no copies), and where it runs the scan under
`jax.checkpoint`, the port recomputes each block in the backward pass
(`_Recompute`): a training forward keeps one layer input per layer.  One
device, so no sharding constraints.

The decode KV cache is updated in place (see `attention._cache_write`):
`decode_step` returns the cache it was given, now holding the new slot.

A call's `window=W` (a sliding window of W keys, how the reference serves
long contexts on dense archs) runs through `forward`, `loss_fn`,
`prefill`, `decode_step` and `cache_spec`, as in the reference: the
prefill cache keeps the last W positions rolled so that position p sits at
slot p % W (`_roll_window`), and the decode cache has min(W, cache_len)
slots.  A config's own `sliding_window` belongs to the hybrid family,
which the port does not build.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import attention as A
from repro_torch.models.config import ATTN_MLP, ModelConfig
from repro_torch.models.layers import (P, chunked_softmax_ce, cross_entropy,
                                       layer_slice, linear, mlp_apply,
                                       mlp_spec, param_count, rms_norm,
                                       stack_spec, torch_dtype, tree_leaves)


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


def _roll_window(t: torch.Tensor, window: int) -> torch.Tensor:
    """The last `window` cache entries (positions S-W..S-1 at indices
    0..W-1) in rolling-buffer layout, where position p lives at slot p % W.
    t (B, S, ...); unchanged when the sequence is shorter than the window."""
    S = t.shape[1]
    if S < window:
        return t
    return torch.roll(t[:, -window:], S % window, dims=1)


def block_forward(lp, x, cfg: ModelConfig, *, lora, ls, window=None,
                  causal=True, want_cache=False):
    """Returns (x, cache_dict)."""
    cache: Dict[str, Any] = {}
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    y = A.gqa_forward(lp["attn"], h, cfg, lora=_sub(lora, "attn"),
                      lora_scale=ls, window=window, causal=causal,
                      return_kv=want_cache)
    if want_cache:
        y, kv = y
        if window is not None:
            kv = tuple(_roll_window(t, window) for t in kv)
        cache["self"] = kv
    x = x + y
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    x = x + mlp_apply(lp["mlp"], h, cfg.activation, _sub(lora, "mlp"), ls)
    return x, cache


def block_decode(lp, x1, cache, pos, cfg: ModelConfig, *, lora, ls,
                 window=None):
    """Returns (x1, cache) with cache['self'] written in place."""
    h = rms_norm(x1, lp["attn_norm"], cfg.norm_eps)
    y, kv = A.gqa_decode(lp["attn"], h, cache["self"], pos, cfg,
                         lora=_sub(lora, "attn"), lora_scale=ls,
                         window=window)
    x1 = x1 + y
    h = rms_norm(x1, lp["mlp_norm"], cfg.norm_eps)
    x1 = x1 + mlp_apply(lp["mlp"], h, cfg.activation, _sub(lora, "mlp"), ls)
    return x1, {"self": kv}


def _rebuild(tree, leaves):
    """`tree` with its leaves replaced, in `tree_leaves` order, by the
    next items of the iterator `leaves`."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, tuple):
        return tuple(_rebuild(v, leaves) for v in tree)
    return next(leaves)


class _Recompute(torch.autograd.Function):
    """One block run with no activations kept, and run again in the
    backward pass: the reference's `jax.checkpoint` of its scanned layer.
    The block's weights and LoRA tensors are explicit inputs (not captured
    in `run`), so every one that requires a gradient gets it.  The forward
    keeps only the inputs; the backward's recomputation repeats the same
    ops on the same tensors, so the gradient is bitwise the one of the
    plain loop.  (`torch.utils.checkpoint` without reentrance recomputes
    the same way, through a Python hook per saved tensor that doubles the
    host time of a step.)"""

    @staticmethod
    def forward(ctx, run, x, *leaves):
        ctx.run = run
        ctx.save_for_backward(x, *leaves)
        with torch.no_grad():
            return run(x, *leaves)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        need = ctx.needs_input_grad[1:]
        ins = [t.detach().requires_grad_(n)
               for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            y = ctx.run(*ins)
        grads = iter(torch.autograd.grad(
            y, [t for t, n in zip(ins, need) if n], dy))
        return (None, *(next(grads) if n else None for n in need))


def _recomputed_block(lp, x, cfg: ModelConfig, *, lora, ls, window, causal):
    """block_forward's x through `_Recompute`."""
    def run(x, *leaves):
        it = iter(leaves)
        return block_forward(_rebuild(lp, it), x, cfg, lora=_rebuild(lora, it),
                             ls=ls, window=window, causal=causal)[0]
    return _Recompute.apply(run, x, *tree_leaves(lp), *tree_leaves(lora))


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
            lora_scale: float = 1.0, window=None, want_cache: bool = False,
            want_logits: bool = True):
    """Full-sequence forward over batch['tokens'] (B, S), or over
    batch['embeds'] (B, S, D) for a model with `embed_inputs`.  Attention
    is causal for LMs (within a sliding window of `window` keys, if given)
    and bidirectional for classifiers (`num_classes > 0`), whose logits are
    the f32 head over the mean of the final hidden states.  Returns
    dict(hidden, logits, cache); cache leaves are stacked (L, B, S, ...),
    or (L, B, W, ...) rolled (`_roll_window`) under a window W <= S.
    want_logits=False skips an LM's (B, S, V) logits (the loss path takes
    the chunked vocab CE on `hidden` instead)."""
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
    # the reference's jax.checkpoint of the scanned layer: while autograd
    # records, each block keeps only its input and is recomputed in the
    # backward pass (a forward that returns the KV cache keeps its blocks)
    remat = (torch.is_grad_enabled() and not want_cache and (
        x.requires_grad or any(t.requires_grad for t in
                               (*tree_leaves(gp), *tree_leaves(gl)))))
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lp, ll = layer_slice(gp, i), layer_slice(gl, i)
        if remat:
            x = _recomputed_block(lp, x, cfg, lora=ll, ls=lora_scale,
                                  window=window, causal=causal)
            continue
        x, c = block_forward(lp, x, cfg, lora=ll, ls=lora_scale, window=window,
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
            lora_scale: float = 1.0, window=None, loss_chunk: int = 1024):
    """A classifier's mean CE of its logits against batch['labels']; an
    LM's mean next-token CE of batch['tokens'] (..., S), masked by
    batch['loss_mask'] when present.  The reference's `loss_fn` without
    multi-token prediction (which raises in `check_supported`); the dense
    block adds no auxiliary loss."""
    out = forward(params, cfg, batch, lora=lora, lora_scale=lora_scale,
                  window=window, want_logits=False)
    if cfg.num_classes > 0:
        return cross_entropy(out["logits"], batch["labels"])
    tokens = batch["tokens"]
    mask = batch.get("loss_mask", None)
    return chunked_softmax_ce(out["hidden"][..., :-1, :], _lm_head(params, cfg),
                              tokens[..., 1:],
                              None if mask is None else mask[..., 1:],
                              chunk=loss_chunk)


def prefill(params, cfg: ModelConfig, batch, *, lora=None, lora_scale=1.0,
            window=None, max_len: Optional[int] = None):
    """max_len pads the attention caches to serving capacity (slots beyond
    the prefilled length are masked out by decode's validity mask); under
    a sliding window W, to min(max_len, W) slots, the rolled cache's."""
    check_servable(cfg)
    out = forward(params, cfg, batch, lora=lora, lora_scale=lora_scale,
                  window=window, want_cache=True)
    k, v = out["cache"]["g0"]["self"]          # (L, B, S or W, KV, hd)
    if max_len is not None:
        target = max_len if window is None else min(max_len, window)
        if k.shape[2] < target:
            pad = (0, 0, 0, 0, 0, target - k.shape[2])
            k = torch.nn.functional.pad(k, pad)
            v = torch.nn.functional.pad(v, pad)
    return out["logits"][..., -1:, :], {"g0": {"self": (k, v)}}


def decode_step(params, cfg: ModelConfig, token, pos, cache, *, lora=None,
                lora_scale: float = 1.0, window=None):
    """token (B,) int; pos () shared, or (B,) per row (the continuous-
    batching serving path: each lane at its own position); cache as
    returned by prefill or `cache_spec`, updated in place.  A paged lora
    tree (leaf dicts carrying `gidx`, see `serving/cache.py::paged_lora`)
    serves a different adapter per row through the same call.  Under a
    sliding window the cache is the rolling one of `cache_spec(...,
    window)` or `prefill(..., window=)`.  Returns (logits (B,1,V),
    cache)."""
    check_servable(cfg)
    x1 = embed_tokens(params, cfg, token[:, None])
    gp = params["groups"]["g0"]
    gl = (lora or {}).get("g0") or {}
    gc = cache["g0"]
    for i in range(cfg.num_layers):
        x1, _ = block_decode(layer_slice(gp, i), x1, layer_slice(gc, i), pos,
                             cfg, lora=layer_slice(gl, i), ls=lora_scale,
                             window=window)
    x1 = rms_norm(x1, params["final_norm"], cfg.norm_eps)
    return linear(x1, _lm_head(params, cfg)), cache


def cache_spec(cfg: ModelConfig, batch: int, cache_len: int, window=None):
    """The decode KV cache's spec: (L, batch, T, KV, hd) per k and v, with
    T = cache_len, or min(window, cache_len) slots under a sliding window
    (a rolling buffer)."""
    T = cache_len if window is None else min(window, cache_len)
    kv = P((batch, T, cfg.num_kv_heads, cfg.hd),
           ("batch", "kv_seq", None, None), dtype=cfg.param_dtype)
    return {"g0": stack_spec({"self": (kv, kv)}, cfg.num_layers)}
