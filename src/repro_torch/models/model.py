"""Model assembly: specs, the layer loop, forward / prefill / decode.

The models of `src/repro/models/model.py` that the port builds: causal
token LMs of dense `attn_mlp` blocks and the paper's task models (a
ViT-style classifier over embedding inputs, GPT-style classifiers and LMs
with learned positions), hymba's `hybrid` blocks (attention and Mamba
heads side by side, under the config's own sliding window) and xLSTM's
periodic `mlstm` / `slstm` groups (`models/ssm.py`).  Params are stacked on
a leading layer axis per group as in the reference (a periodic group's
sub-blocks `b0`, `b1`, ... each stacked over the periods); where the
reference runs `lax.scan` over that axis, the port runs a Python loop over
layer slices (views, no copies), and where it runs the scan under
`jax.checkpoint`, the port recomputes each block in the backward pass
(`_Recompute`): a training forward keeps one layer input per block.  One
device, so no sharding constraints.

The decode cache is updated in place (see `attention._cache_write` and
`models/ssm.py`): `decode_step` returns the cache it was given, now holding
the new slot and the new recurrent state.

A call's `window=W` (a sliding window of W keys, how the reference serves
long contexts on dense archs) runs through `forward`, `loss_fn`,
`prefill`, `decode_step` and `cache_spec`, as in the reference: the
prefill cache keeps the last W positions rolled so that position p sits at
slot p % W (`_roll_window`), and the decode cache has min(W, cache_len)
slots.  A config's own `sliding_window` belongs to the hybrid family, whose
attention takes it whenever the call gives no window.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import attention as A
from repro_torch.models import ssm as S
from repro_torch.models.config import (ATTN_MLP, HYBRID, MLSTM, SLSTM,
                                       ModelConfig)
from repro_torch.models.layers import (P, chunked_softmax_ce, cross_entropy,
                                       layer_slice, linear, mlp_apply,
                                       mlp_spec, param_count, rms_norm,
                                       stack_spec, torch_dtype, tree_leaves)

BUILT_KINDS = (ATTN_MLP, MLSTM, SLSTM, HYBRID)


def check_supported(cfg: ModelConfig) -> None:
    """The port builds `attn_mlp`, `mlstm`, `slstm` and `hybrid` blocks:
    causal token LMs, the paper's task models (embedding inputs, learned
    positions, a mean-pooled classifier head), hymba and xLSTM, for
    `forward` and `loss_fn`."""
    _refuse(cfg, (
        ("MLA", cfg.use_mla), ("MoE", cfg.num_experts > 0),
        ("encoder-decoder", cfg.encoder_decoder),
        ("image tokens", cfg.num_image_tokens > 0),
        ("multi-token prediction", cfg.mtp_depth > 0),
        ("sliding window outside the hybrid family",
         cfg.sliding_window is not None and cfg.family != "hybrid")),
        "build")


def check_servable(cfg: ModelConfig) -> None:
    """`prefill` and `decode_step` serve causal token LMs only, as the
    reference's engine does: the task models' embedding inputs and
    classifier heads are not served.  Learned positions are (GPT-2 Small):
    `decode_step` adds each row's own position's embedding."""
    check_supported(cfg)
    _refuse(cfg, (("embedding inputs", cfg.embed_inputs),
                  ("classifier head", cfg.num_classes > 0)), "serve")


def _refuse(cfg: ModelConfig, features, verb: str) -> None:
    missing = [name for name, off in features if off]
    kinds = [k for k, _ in cfg.layer_groups()]
    if any(k not in BUILT_KINDS for ks, _ in _group_kinds(cfg) for k in ks):
        missing.append(f"block kinds {kinds}")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the port does not {verb} {', '.join(missing)} yet")


def _dense_ff(cfg: ModelConfig) -> int:
    return cfg.dense_d_ff if cfg.dense_d_ff else cfg.d_ff


def block_spec(cfg: ModelConfig, kind: str = ATTN_MLP):
    D, dt = cfg.d_model, cfg.param_dtype
    norm = lambda: P((D,), ("embed",), init="ones", dtype=dt)  # noqa: E731
    if kind == ATTN_MLP:
        return {"attn_norm": norm(), "attn": A.gqa_spec(cfg),
                "mlp_norm": norm(),
                "mlp": mlp_spec(D, _dense_ff(cfg), cfg.activation, dt)}
    if kind == MLSTM:
        return {"norm": norm(), "core": S.mlstm_spec(cfg)}
    if kind == SLSTM:
        return {"norm": norm(), "core": S.slstm_spec(cfg)}
    if kind == HYBRID:
        return {"attn_norm": norm(),
                "attn": A.gqa_spec(cfg),
                "mamba": S.mamba_spec(cfg),
                "comb_norm_a": norm(), "comb_norm_m": norm(),
                "w_comb": P((2,), (None,), init="ones", dtype="float32"),
                "mlp_norm": norm(),
                "mlp": mlp_spec(D, cfg.d_ff, cfg.activation, dt)}
    raise ValueError(kind)


def _group_kinds(cfg: ModelConfig):
    """[(kinds, count)] per group: one kind, or a period's sub-block kinds
    (`period:mlstm,...,slstm`, stacked as `b0`, `b1`, ... over count
    periods)."""
    out = []
    for kind, count in cfg.layer_groups():
        if kind.startswith("period:"):
            out.append((tuple(kind[len("period:"):].split(",")), count))
        else:
            out.append(((kind,), count))
    return out


def _group_spec(cfg: ModelConfig, kinds):
    if len(kinds) == 1:
        return block_spec(cfg, kinds[0])
    return {f"b{j}": block_spec(cfg, kj) for j, kj in enumerate(kinds)}


def model_spec(cfg: ModelConfig):
    check_supported(cfg)
    D, V, dt = cfg.d_model, cfg.vocab_size, cfg.param_dtype
    spec: Dict[str, Any] = {}
    if not cfg.embed_inputs:
        spec["embed"] = P((V, D), ("vocab", "embed"), init="embed", dtype=dt)
    if cfg.use_learned_pos:
        spec["pos_embed"] = P((cfg.max_seq, D), (None, "embed"), init="embed",
                              dtype=dt)
    spec["groups"] = {f"g{gi}": stack_spec(_group_spec(cfg, kinds), count)
                      for gi, (kinds, count) in enumerate(_group_kinds(cfg))}
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


def _attn_window(cfg: ModelConfig, kind: str, window):
    """The window of an attention block: the call's, or hybrid's own when
    the call gives none."""
    return cfg.sliding_window if kind == HYBRID and window is None else window


def _combine(lp, ya, ym, cfg: ModelConfig):
    """hybrid's fusion of the attention and Mamba paths: per-path norms and
    the learned scalars w_comb, in f32 (the reference's f32 w_comb promotes
    the bf16 norms)."""
    wc = lp["w_comb"]
    return 0.5 * (wc[0] * rms_norm(ya, lp["comb_norm_a"], cfg.norm_eps).float()
                  + wc[1] * rms_norm(ym, lp["comb_norm_m"],
                                     cfg.norm_eps).float())


def _mlp_residual(lp, x, cfg: ModelConfig, lora, ls):
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + mlp_apply(lp["mlp"], h, cfg.activation, _sub(lora, "mlp"), ls)


def block_forward(lp, x, cfg: ModelConfig, kind: str = ATTN_MLP, *, lora, ls,
                  window=None, causal=True, want_cache=False):
    """Returns (x, cache_dict)."""
    cache: Dict[str, Any] = {}
    if kind in (ATTN_MLP, HYBRID):
        w = _attn_window(cfg, kind, window)
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        y = A.gqa_forward(lp["attn"], h, cfg, lora=_sub(lora, "attn"),
                          lora_scale=ls, window=w, causal=causal,
                          return_kv=want_cache)
        if want_cache:
            y, kv = y
            if w is not None:
                kv = tuple(_roll_window(t, w) for t in kv)
            cache["self"] = kv
        if kind == HYBRID:
            ym, mst = S.mamba_forward_state(lp["mamba"], h, cfg,
                                            lora=_sub(lora, "mamba"), ls=ls)
            if want_cache:
                cache["mamba"] = mst
            y = _combine(lp, y, ym, cfg).to(x.dtype)
        x = _mlp_residual(lp, x + y, cfg, lora, ls)
    elif kind in (MLSTM, SLSTM):
        fwd = S.mlstm_forward_state if kind == MLSTM else S.slstm_forward_state
        y, st = fwd(lp["core"], rms_norm(x, lp["norm"], cfg.norm_eps), cfg,
                    lora=_sub(lora, "core"), ls=ls)
        if want_cache:
            cache["state"] = st
        x = x + y
    else:
        raise ValueError(kind)
    return x, cache


def block_decode(lp, x1, cache, pos, cfg: ModelConfig, kind: str = ATTN_MLP,
                 *, lora, ls, window=None):
    """Returns (x1, cache) with the cache's KV slot and recurrent state
    written in place."""
    if kind in (ATTN_MLP, HYBRID):
        h = rms_norm(x1, lp["attn_norm"], cfg.norm_eps)
        y, _ = A.gqa_decode(lp["attn"], h, cache["self"], pos, cfg,
                            lora=_sub(lora, "attn"), lora_scale=ls,
                            window=_attn_window(cfg, kind, window))
        if kind == HYBRID:
            ym, _ = S.mamba_decode(lp["mamba"], h, cache["mamba"], cfg,
                                   lora=_sub(lora, "mamba"), ls=ls)
            y = _combine(lp, y, ym, cfg).to(x1.dtype)
        x1 = _mlp_residual(lp, x1 + y, cfg, lora, ls)
    elif kind in (MLSTM, SLSTM):
        dec = S.mlstm_decode if kind == MLSTM else S.slstm_decode
        y, _ = dec(lp["core"], rms_norm(x1, lp["norm"], cfg.norm_eps),
                   cache["state"], cfg, lora=_sub(lora, "core"), ls=ls)
        x1 = x1 + y
    else:
        raise ValueError(kind)
    return x1, cache


def _rebuild(tree, leaves):
    """`tree` with its leaves replaced, in `tree_leaves` order, by the
    next items of the iterator `leaves`."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, tuple):
        return tuple(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _stack(trees):
    """Per-layer cache trees -> one tree of (layers, ...) leaves."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple):
        return tuple(_stack([t[i] for t in trees]) for i in range(len(first)))
    return torch.stack(trees)


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


def _recomputed_block(lp, x, cfg: ModelConfig, kind: str, *, lora, ls,
                      window, causal):
    """block_forward's x through `_Recompute`."""
    def run(x, *leaves):
        it = iter(leaves)
        return block_forward(_rebuild(lp, it), x, cfg, kind,
                             lora=_rebuild(lora, it), ls=ls, window=window,
                             causal=causal)[0]
    return _Recompute.apply(run, x, *tree_leaves(lp), *tree_leaves(lora))


def _layers(cfg: ModelConfig, params, lora):
    """(group, layer, kind, block params, block lora, sub-block key) for
    every block in model order; a periodic group's sub-blocks come one
    after the other under keys b0, b1, ... (None for a one-kind group)."""
    for gi, (kinds, count) in enumerate(_group_kinds(cfg)):
        g = f"g{gi}"
        gp = params["groups"][g]
        gl = (lora or {}).get(g) or {}
        for i in range(count):
            lp, ll = layer_slice(gp, i), layer_slice(gl, i)
            for j, kind in enumerate(kinds):
                if len(kinds) == 1:
                    yield g, i, kind, lp, ll, None
                else:
                    b = f"b{j}"
                    yield g, i, kind, lp[b], (ll or {}).get(b) or {}, b


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------

def _lm_head(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor,
                 positions=None):
    """Token embeddings (B, S, D), plus, when the model has learned
    positions, those of `positions` (indices broadcast against tokens; by
    default 0..S-1)."""
    x = params["embed"][tokens]
    if cfg.use_learned_pos:
        table = params["pos_embed"]
        x = x + (table[:tokens.shape[-1]] if positions is None
                 else table[positions])
    return x


def forward(params, cfg: ModelConfig, batch: Dict[str, Any], *, lora=None,
            lora_scale: float = 1.0, window=None, want_cache: bool = False,
            want_logits: bool = True):
    """Full-sequence forward over batch['tokens'] (B, S), or over
    batch['embeds'] (B, S, D) for a model with `embed_inputs`.  Attention
    is causal for LMs (within a sliding window of `window` keys, if given,
    and hybrid's within its config's own otherwise) and bidirectional for
    classifiers (`num_classes > 0`), whose logits are the f32 head over the
    mean of the final hidden states.  Returns dict(hidden, logits, cache);
    cache leaves are stacked per group (L, B, ...): KV (L, B, S, ...), or
    (L, B, W, ...) rolled (`_roll_window`) under a window W <= S, and the
    recurrent blocks' final states.  want_logits=False skips an LM's (B, S,
    V) logits (the loss path takes the chunked vocab CE on `hidden`
    instead)."""
    check_supported(cfg)
    causal = cfg.num_classes == 0
    if cfg.embed_inputs:
        x = batch["embeds"].to(torch_dtype(cfg.compute_dtype))
        if cfg.use_learned_pos:
            x = x + params["pos_embed"][:x.shape[-2]]
    else:
        x = embed_tokens(params, cfg, batch["tokens"])
    # the reference's jax.checkpoint of the scanned layer: while autograd
    # records, each block keeps only its input and is recomputed in the
    # backward pass (a forward that returns the cache keeps its blocks)
    remat = (torch.is_grad_enabled() and not want_cache and (
        x.requires_grad or any(t.requires_grad for t in (
            *tree_leaves(params["groups"]), *tree_leaves(lora or {})))))
    layers: Dict[str, list] = {}
    for g, i, kind, lp, ll, b in _layers(cfg, params, lora):
        if remat:
            x = _recomputed_block(lp, x, cfg, kind, lora=ll, ls=lora_scale,
                                  window=window, causal=causal)
            continue
        x, c = block_forward(lp, x, cfg, kind, lora=ll, ls=lora_scale,
                             window=window, causal=causal,
                             want_cache=want_cache)
        if want_cache:
            per = layers.setdefault(g, [])
            if b is None:
                per.append(c)
            else:
                if b == "b0":
                    per.append({})
                per[-1][b] = c
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    out: Dict[str, Any] = {"hidden": x}
    if cfg.num_classes > 0:
        pooled = torch.mean(x, dim=-2)
        out["logits"] = torch.matmul(pooled.float(), params["cls_head"])
    elif want_logits:
        out["logits"] = linear(x, _lm_head(params, cfg))
    if want_cache:
        out["cache"] = {g: _stack(per) for g, per in layers.items()}
    return out


def loss_fn(params, cfg: ModelConfig, batch, *, lora=None,
            lora_scale: float = 1.0, window=None, loss_chunk: int = 1024):
    """A classifier's mean CE of its logits against batch['labels']; an
    LM's mean next-token CE of batch['tokens'] (..., S), masked by
    batch['loss_mask'] when present.  The reference's `loss_fn` without
    multi-token prediction (which raises in `check_supported`); the blocks
    the port builds add no auxiliary loss."""
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


def _pad_kv(tree, target: int):
    """Every `self` KV leaf (L, B, T, ...) of a cache tree zero-padded to
    `target` slots along T."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k == "self":
            v = tuple(torch.nn.functional.pad(
                t, (0, 0) * (t.ndim - 3) + (0, target - t.shape[2]))
                if t.shape[2] < target else t for t in v)
        else:
            v = _pad_kv(v, target)
        out[k] = v
    return out


def prefill(params, cfg: ModelConfig, batch, *, lora=None, lora_scale=1.0,
            window=None, max_len: Optional[int] = None):
    """max_len pads the attention caches to serving capacity (slots beyond
    the prefilled length are masked out by decode's validity mask); under
    a sliding window W (the call's, or hybrid's own), to min(max_len, W)
    slots, the rolled cache's.  The recurrent states are the prompt's
    final ones."""
    check_servable(cfg)
    out = forward(params, cfg, batch, lora=lora, lora_scale=lora_scale,
                  window=window, want_cache=True)
    cache = out["cache"]
    if max_len is not None:
        eff = window if window is not None else cfg.sliding_window
        cache = _pad_kv(cache, min(max_len, eff) if eff else max_len)
    return out["logits"][..., -1:, :], cache


def decode_step(params, cfg: ModelConfig, token, pos, cache, *, lora=None,
                lora_scale: float = 1.0, window=None):
    """token (B,) int; pos () shared, or (B,) per row (the continuous-
    batching serving path: each lane at its own position); cache as
    returned by prefill or `cache_spec`, updated in place.  A paged lora
    tree (leaf dicts carrying `gidx`, see `serving/cache.py::paged_lora`)
    serves a different adapter per row through the same call.  Under a
    sliding window the cache is the rolling one of `cache_spec(...,
    window)` or `prefill(..., window=)`.  A model with learned positions
    adds `pos_embed[pos]` to each row, its own position's (the reference's
    decode adds position 0's to every token; its `forward` is what the
    port is held to), so every pos must be below `cfg.max_seq`.  Returns
    (logits (B,1,V), cache)."""
    check_servable(cfg)
    x1 = embed_tokens(params, cfg, token[:, None],
                      torch.as_tensor(pos, device=token.device).reshape(-1, 1))
    for g, i, kind, lp, ll, b in _layers(cfg, params, lora):
        lc = layer_slice(cache[g], i)
        x1, _ = block_decode(lp, x1, lc if b is None else lc[b], pos, cfg,
                             kind, lora=ll, ls=lora_scale, window=window)
    x1 = rms_norm(x1, params["final_norm"], cfg.norm_eps)
    return linear(x1, _lm_head(params, cfg)), cache


def _kind_cache_spec(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                     window):
    spec: Dict[str, Any] = {}
    if kind in (ATTN_MLP, HYBRID):
        w = _attn_window(cfg, kind, window)
        T = min(w, cache_len) if w else cache_len
        kv = P((batch, T, cfg.num_kv_heads, cfg.hd),
               ("batch", "kv_seq", None, None), dtype=cfg.param_dtype)
        spec["self"] = (kv, kv)
    if kind == HYBRID:
        di = S.mamba_inner_dim(cfg)
        spec["mamba"] = {
            "conv": P((batch, cfg.ssm_conv_width - 1, di),
                      ("batch", None, None), dtype="float32"),
            "h": P((batch, di, cfg.ssm_state_size), ("batch", None, None),
                   dtype="float32")}
    elif kind == MLSTM:
        H = cfg.num_heads
        _, hd = S.mlstm_inner(cfg)
        spec["state"] = {
            "C": P((batch, H, hd, hd), ("batch", None, None, None),
                   dtype="float32"),
            "n": P((batch, H, hd), ("batch", None, None), dtype="float32"),
            "m": P((batch, H), ("batch", None), dtype="float32")}
    elif kind == SLSTM:
        H, hd = cfg.num_heads, cfg.d_model // cfg.num_heads
        st = P((batch, H, hd), ("batch", None, None), dtype="float32")
        spec["state"] = {"h": st, "c": st, "n": st, "m": st}
    return spec


def cache_spec(cfg: ModelConfig, batch: int, cache_len: int, window=None):
    """The decode cache's spec, per group stacked (L, batch, ...): KV k and
    v (L, batch, T, KV, hd) with T = cache_len, or min(W, cache_len) slots
    under a sliding window W (a rolling buffer; hybrid's own window when
    the call gives none); the recurrent blocks' f32 states (Mamba's conv
    window and h, mLSTM's C, n, m, sLSTM's h, c, n, m)."""
    caches = {}
    for gi, (kinds, count) in enumerate(_group_kinds(cfg)):
        if len(kinds) == 1:
            kspec = _kind_cache_spec(cfg, kinds[0], batch, cache_len, window)
        else:
            kspec = {f"b{j}": _kind_cache_spec(cfg, kj, batch, cache_len,
                                               window)
                     for j, kj in enumerate(kinds)}
        caches[f"g{gi}"] = stack_spec(kspec, count)
    return caches
