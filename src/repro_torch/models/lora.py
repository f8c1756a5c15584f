"""LoRA adapter trees mirroring the backbone params.

The LoRA tree holds only targeted linear leaves, each replaced by
{'a': (.., d_in, r), 'b': (.., r, d_out)} with the stacked layer axis
kept; `b` inits to zero (dW = 0 at start).  Same keys and shapes as
`src/repro/models/lora.py` for the attention and MLP targets and for the
recurrent cores: the generic q / k / v / o targets map onto mLSTM's
headwise wq / wk / wv (pairs (.., H, hd, r) / (.., H, r, hd)) and `down`,
sLSTM's `wx` and `down`, and Mamba's `in_proj` and `out_proj`
(`_CORE_TARGET_MAP`), so FLASC adapts the attention-free archs too.
`merge_lora` folds an adapter into the backbone for serving one tenant
without the adapter path.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Optional

import torch

from repro_torch import DeviceLike
from repro_torch.models import model as mdl
from repro_torch.models.config import LoRAConfig, ModelConfig
from repro_torch.models.layers import P, init_params


def _lora_pair(w: P, rank: int, dtype: str):
    """w is a (possibly layer-stacked) 2D linear spec (..., d_in, d_out)."""
    lead, lead_axes = w.shape[:-2], w.axes[:-2]
    d_in, d_out = w.shape[-2:]
    return {
        "a": P(lead + (d_in, rank), lead_axes + (None, None), init="normal",
               dtype=dtype, fan_in=d_in),
        "b": P(lead + (rank, d_out), lead_axes + (None, None), init="zeros",
               dtype=dtype),
    }


# recurrent cores (xLSTM / Mamba): the generic q/k/v/o targets on the
# block's input/gate/output projections, as in the reference
_CORE_TARGET_MAP = {"wq": ("wq", "wx", "in_proj"), "wk": ("wk",),
                    "wv": ("wv",), "wo": ("down", "out_proj")}


def _block_lora_spec(bspec, lcfg: LoRAConfig):
    out: Dict[str, Any] = {}
    for section in ("attn", "mlp"):
        if section in bspec:
            sec = {k: _lora_pair(bspec[section][k], lcfg.rank, lcfg.dtype)
                   for k in lcfg.targets if k in bspec[section]}
            if sec:
                out[section] = sec
    for section in ("core", "mamba"):
        if section in bspec:
            sec = {k: _lora_pair(bspec[section][k], lcfg.rank, lcfg.dtype)
                   for t in lcfg.targets for k in _CORE_TARGET_MAP.get(t, ())
                   if k in bspec[section]}
            if sec:
                out[section] = sec
    return out


def lora_spec(cfg: ModelConfig, lcfg: LoRAConfig):
    """Mirrored spec tree with LoRA pairs for every targeted weight, per
    group (a periodic group per sub-block b0, b1, ...)."""
    out: Dict[str, Any] = {}
    for g, gspec in mdl.model_spec(cfg)["groups"].items():
        if all(re.fullmatch(r"b\d+", k) for k in gspec):
            sub = {b: _block_lora_spec(bs, lcfg) for b, bs in gspec.items()}
            sec = {b: v for b, v in sub.items() if v}
        else:
            sec = _block_lora_spec(gspec, lcfg)
        if sec:
            out[g] = sec
    return out


def init_lora(cfg: ModelConfig, lcfg: LoRAConfig, seed: int = 0, *,
              device: DeviceLike = None,
              generator: Optional[torch.Generator] = None):
    return init_params(lora_spec(cfg, lcfg), seed, device=device,
                       generator=generator)


def merge_lora(params, lora, cfg: ModelConfig, lcfg: LoRAConfig):
    """The backbone with dW = a @ b * scale folded into every adapted
    weight, in f32 and cast back to the weight's dtype, as the reference's
    `merge_lora`.  Returns a new tree; `params` and `lora` are unchanged
    (leaves the adapter does not touch are shared, not copied)."""
    def fold(w, pair):
        delta = torch.einsum("...ir,...ro->...io", pair["a"].float(),
                             pair["b"].float()) * lcfg.scale
        return (w.float() + delta).to(w.dtype)

    def walk(ptree, ltree):
        out = dict(ptree)
        for k, v in ltree.items():
            if isinstance(v, dict) and set(v) == {"a", "b"}:
                out[k] = fold(ptree[k], v)
            else:
                out[k] = walk(ptree[k], v)
        return out

    merged = dict(params)
    merged["groups"] = walk(params["groups"], lora)
    return merged
