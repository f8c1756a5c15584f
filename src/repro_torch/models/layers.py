"""Parameter specs and basic layers (plain functions on tensors).

Params are nested dicts of tensors with the reference tree's keys and its
stacked leading layer axis, so a reference params tree maps onto the
port's one to one (`checkpoint/io.py`).  Every leaf is declared as a `P`
spec carrying shape, logical axes and an init kind, as in
`src/repro/models/layers.py`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import DeviceLike, resolve_device

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "int32": torch.int32}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


@dataclasses.dataclass(frozen=True)
class P:
    """Declarative parameter spec."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]      # logical axis names, len == len(shape)
    init: str = "normal"                  # normal | zeros | ones | embed
    dtype: str = "bfloat16"
    fan_in: Optional[int] = None          # override for scaled init

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             "in rank")


def map_specs(fn: Callable[[P], Any], tree):
    """Apply `fn` to every `P` leaf of a nested-dict/tuple spec tree."""
    if isinstance(tree, P):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(map_specs(fn, v) for v in tree)
    raise TypeError(f"not a spec tree node: {type(tree).__name__}")


def stack_spec(spec_tree, n: int, axis_name: str = "layer"):
    """Prepend a stacked layer axis to every leaf spec."""
    return map_specs(lambda p: P((n,) + p.shape, (axis_name,) + p.axes,
                                 p.init, p.dtype, p.fan_in), spec_tree)


def param_count(spec_tree) -> int:
    total = 0

    def add(p: P):
        nonlocal total
        total += math.prod(p.shape)

    map_specs(add, spec_tree)
    return total


def _normal(shape, std: float, dt, gen, device) -> torch.Tensor:
    """f32 normal draw scaled by `std`, then cast (as the reference's
    `init_param`).  A leaf with a stacked leading layer axis is drawn one
    layer slice at a time, so the f32 draw of a whole stacked weight never
    sits in memory."""
    if len(shape) < 3:
        return (torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32) * std).to(dt)
    out = torch.empty(shape, dtype=dt, device=device)
    for i in range(shape[0]):
        out[i] = torch.randn(shape[1:], generator=gen, device=device,
                             dtype=torch.float32) * std
    return out


def init_param(p: P, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    dt = torch_dtype(p.dtype)
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dt, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dt, device=device)
    if p.init == "embed":
        return _normal(p.shape, 0.02, dt, gen, device)
    fan_in = p.fan_in if p.fan_in is not None else (
        p.shape[-2] if len(p.shape) >= 2 else p.shape[-1])
    return _normal(p.shape, 1.0 / math.sqrt(max(fan_in, 1)), dt, gen, device)


def init_params(spec_tree, seed: int = 0, *, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None):
    """Random params for a spec tree, drawn from one `torch.Generator` on
    `device` (seeded with `seed` unless a generator is passed), leaves in
    sorted-key order.  The draws differ from the reference's (Philox, not
    threefry): cross-package tests convert weights, never re-initialise."""
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(seed)

    def walk(node):
        if isinstance(node, P):
            return init_param(node, gen, dev)
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return tuple(walk(v) for v in node)

    return walk(spec_tree)


def zeros_from_spec(spec_tree, device: torch.device):
    return map_specs(lambda p: torch.zeros(p.shape, dtype=torch_dtype(p.dtype),
                                           device=device), spec_tree)


def tree_leaves(tree):
    """Leaves of a nested dict/tuple tree, dict keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    elif isinstance(tree, tuple):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def layer_slice(tree: Dict[str, Any], i: int):
    """Index every leaf of a stacked (nested-dict/tuple) tree at layer i;
    the slices are views."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tuple(layer_slice(v, i) for v in tree)


# ---------------------------------------------------------------------------
# basic ops
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight.float()).to(dt)


def linear(x: torch.Tensor, w: torch.Tensor, lora=None, scale: float = 1.0):
    """y = x @ w (+ LoRA path). w: (d_in, d_out); lora: {'a': (d_in, r),
    'b': (r, d_out)}.

    A lora dict carrying a `gidx` leaf is a *paged* adapter: 'a'/'b' are
    page pools (G, d_in, r) / (G, r, d_out) and gidx assigns one page per
    leading-dim row (the multi-tenant serving path; see
    `serving/cache.py::paged_lora`).  The delta dispatches through the
    grouped-kernel registry in `kernels/lora_matmul.py`.
    """
    y = torch.matmul(x, w.to(x.dtype))
    if lora is not None:
        y = y + lora_delta(x, lora, scale).to(y.dtype)
    return y


def lora_delta(x: torch.Tensor, lora, scale: float = 1.0) -> torch.Tensor:
    """`linear`'s LoRA term scale * (x @ a) @ b in the adapter's dtype: one
    adapter, or a paged one (a `gidx` leaf) through the grouped-kernel
    registry (`kernels/lora_matmul.py::grouped_lora_delta`)."""
    if "gidx" in lora:
        from repro_torch.kernels.lora_matmul import grouped_lora_delta
        return grouped_lora_delta(x, lora["a"], lora["b"], lora["gidx"], scale)
    xa = torch.matmul(x.to(lora["a"].dtype), lora["a"])
    return scale * torch.matmul(xa, lora["b"])


def gelu(x):
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {
    "swiglu": F.silu,
    "geglu": gelu,
    "gelu": gelu,
}


def mlp_spec(d_model: int, d_ff: int, activation: str, dtype: str):
    spec = {
        "w1": P((d_model, d_ff), ("embed", "mlp"), dtype=dtype),
        "w2": P((d_ff, d_model), ("mlp", "embed"), dtype=dtype),
    }
    if activation in ("swiglu", "geglu"):
        spec["w3"] = P((d_model, d_ff), ("embed", "mlp"), dtype=dtype)
    return spec


def mlp_apply(params, x, activation: str, lora=None, lora_scale=1.0):
    act = ACTIVATIONS[activation]
    lget = (lora or {}).get
    h = linear(x, params["w1"], lget("w1"), lora_scale)
    if "w3" in params:
        h = act(h) * linear(x, params["w3"], lget("w3"), lora_scale)
    else:
        h = act(h)
    return linear(h, params["w2"], lget("w2"), lora_scale)


# ---------------------------------------------------------------------------
# token cross-entropy
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask=None):
    """Mean token cross-entropy. logits (..., V) upcast to f32, labels int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def _head_logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """(N, D) @ (D, V) with f32 products and accumulation (the reference's
    `preferred_element_type=f32`: bf16 inputs upcast exactly)."""
    return torch.matmul(x.float(), head.to(x.dtype).float())


def chunked_softmax_ce(x, head, labels, mask=None, chunk: int = 1024):
    """Mean token CE of `x @ head` without materializing (N, V) logits.

    x (..., D) hidden states; head (D, V); labels (...) int.  Tokens are
    flattened; up to `chunk` tokens take one plain `cross_entropy`, more
    run in `chunk`-sized slices, each recomputed in the backward pass
    (`torch.utils.checkpoint`), so peak memory is O(chunk * V)."""
    D = x.shape[-1]
    xf = x.reshape(-1, D)
    lf = labels.reshape(-1)
    mf = torch.ones(lf.shape, dtype=torch.float32, device=lf.device) \
        if mask is None else mask.reshape(-1).float()
    n = xf.shape[0]
    if n <= chunk:
        return cross_entropy(_head_logits(xf, head), lf, mf)
    pad = (-n) % chunk
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
        lf = F.pad(lf, (0, pad))
        mf = F.pad(mf, (0, pad))

    def body(xc, lc, mc):
        logits = _head_logits(xc, head)
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, lc[:, None].long())[:, 0]
        return torch.sum((logz - gold) * mc)

    from torch.utils.checkpoint import checkpoint
    tot = torch.zeros((), dtype=torch.float32, device=xf.device)
    cnt = torch.zeros((), dtype=torch.float32, device=xf.device)
    for s in range(0, xf.shape[0], chunk):
        tot = tot + checkpoint(body, xf[s:s + chunk], lf[s:s + chunk],
                               mf[s:s + chunk], use_reentrant=False)
        cnt = cnt + torch.sum(mf[s:s + chunk])
    return tot / torch.clamp_min(cnt, 1.0)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, H, hd) or (..., S, hd); positions: (..., S).  f32
    inside, split-halves layout."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)                # (hd/2,)
    angles = positions[..., None].float() * freqs                # (..., S, hd/2)
    if x.ndim >= angles.ndim + 1:                                # head axis
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
