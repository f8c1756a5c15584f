"""Federated strategies: a `Strategy` protocol + registry.

The port of `src/repro/core/strategies.py`.  A strategy answers three
questions about one FL round over the flat global vector `P`: which
entries move down, which gradients train, which entries move up, through
the hooks

  init_state(p_len, device)          -> persistent server-side dict
  download_mask(flatP, sstate, r)    -> global (p_len,) bool download mask
  client_plan(m_down, slot, ctx)     -> per-client `RoundPlan`
  post_round(sstate, flatP, ...)     -> end-of-round state transition

plus `download_base(flatP, sstate)`.  `core/fedround.py` only calls these
hooks.  `StrategySpec` is field for field the reference's, so a spec means
the same thing in both packages, and every kind the reference registers
is ported: ``lora``, ``flasc``, ``flasc_ef``, ``sparse_adapter``,
``fedselect``, ``adapter_lth``, ``ffa``, ``hetlora``, ``flocora`` and
``two_stage_ortho``.

The round index the hooks see is a host int (the engine's round), not a
device scalar: where the reference branches with `jax.lax.cond` (the
sparse adapter's one pruning, the lottery ticket's schedule, the QR fold
of ``two_stage_ortho``) the port branches in Python, so a round launches
the kernels of the branch it takes and nothing else, with no host sync.
The sparse adapter's ``initialized`` flag is a host bool for the same
reason.  Masks that depend only on the flat vector's static rank map
(``ffa``, ``hetlora``, ``two_stage_ortho``) are copied to the device once
per run and shared by every client of a round.
"""
from __future__ import annotations

import dataclasses
import inspect
import warnings
from typing import Any, ClassVar, Dict, Optional, Tuple, Type, Union

import numpy as np
import torch

from repro_torch.core import selectors as sel
from repro_torch.core import sparsity as sp

KINDS = ("lora", "flasc", "flasc_ef", "sparse_adapter", "fedselect",
         "adapter_lth", "ffa", "hetlora")


@dataclasses.dataclass(frozen=True)
class StrategySpec:
    """Declarative strategy config; resolved to a `Strategy` via `resolve`.
    Fields and defaults are the reference's (see its docstring there)."""
    kind: str = "flasc"
    density_down: float = 0.25
    density_up: float = 0.25
    # Top-K selection policy ("exact" | "histogram" | "pallas" | "fused");
    # "" means unset and resolves to "exact" (or the exact_topk mapping)
    selector: str = ""
    # deprecated alias for `selector`: True -> "exact", False -> "histogram"
    exact_topk: Optional[bool] = None
    lth_prune_every: int = 1
    lth_keep: float = 0.98
    client_densities: Tuple[float, ...] = ()
    hetlora_ranks: Tuple[int, ...] = ()
    hetlora_weighted: bool = False
    quant_bits_down: int = 0
    quant_bits_up: int = 0
    lowrank_down: int = 0
    lowrank_up: int = 0
    lowrank_mode: str = "random"
    lowrank_seed: int = 0
    sparse_aggregate: bool = False
    edge_shards: int = 0
    phase_len: int = 1

    def __post_init__(self):
        known = set(KINDS) | set(_REGISTRY)
        if self.kind not in known:
            raise ValueError(f"unknown strategy kind {self.kind!r}; known: "
                             f"{tuple(sorted(known))}")
        if self.exact_topk is not None:
            warnings.warn(
                "StrategySpec(exact_topk=...) is deprecated; use "
                "selector=\"exact\" / \"histogram\" instead",
                DeprecationWarning, stacklevel=3)
            mapped = "exact" if self.exact_topk else "histogram"
            if self.selector and self.selector != mapped:
                raise ValueError(
                    f"conflicting selection config: selector="
                    f"{self.selector!r} with exact_topk={self.exact_topk}")
            object.__setattr__(self, "selector", mapped)
            object.__setattr__(self, "exact_topk", None)
        elif not self.selector:
            object.__setattr__(self, "selector", "exact")
        if not isinstance(self.selector, str) or \
                self.selector not in sel.registered_selectors():
            raise ValueError(
                f"unknown selector {self.selector!r}; known: "
                f"{sel.registered_selectors()} (custom Selector instances "
                "go through transport.TopKSparsify, not the spec)")
        if self.lowrank_mode not in ("random", "learned"):
            raise ValueError(
                f"unknown lowrank_mode {self.lowrank_mode!r}; "
                "known: ('random', 'learned')")
        if self.lowrank_down < 0 or self.lowrank_up < 0:
            raise ValueError("lowrank ranks must be >= 0 (0 = off); got "
                             f"{self.lowrank_down}/{self.lowrank_up}")
        if self.edge_shards < 0:
            raise ValueError(
                f"edge_shards must be >= 0 (0 = flat); got {self.edge_shards}")
        if self.phase_len < 1:
            raise ValueError(f"phase_len must be >= 1; got {self.phase_len}")


# ---------------------------------------------------------------------------
# per-client round plans
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class UploadRule:
    """How one client turns its dense local delta into the upload message.

    mode "topk":  Top-K of the delta at `density` (FLASC).
    mode "fixed": multiply by `mask`; nnz counts actual nonzero values.
    """
    mode: str                                   # "topk" | "fixed"
    density: float = 1.0
    mask: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.mode not in ("topk", "fixed"):
            raise ValueError(f"unknown upload mode {self.mode!r}")

    @classmethod
    def topk(cls, density: float) -> "UploadRule":
        return cls(mode="topk", density=float(density))

    @classmethod
    def fixed(cls, mask) -> "UploadRule":
        return cls(mode="fixed", mask=mask)


@dataclasses.dataclass(frozen=True)
class RoundPlan:
    """One client's plan for one round, in flat-vector space: m_down
    (p_len,) bool, m_train (p_len,) bool or None (dense local training),
    and the upload rule."""
    m_down: torch.Tensor
    m_train: Optional[torch.Tensor]
    upload: UploadRule


@dataclasses.dataclass(frozen=True)
class PlanContext:
    """Per-round facts available to `client_plan` / `aggregate` /
    `post_round`; a fresh context per round."""
    p_len: int
    n_clients: int
    rank_idx: Optional[np.ndarray] = None       # per-entry LoRA rank component
    is_b: Optional[np.ndarray] = None           # per-entry "is a B-matrix entry"
    round_idx: Optional[int] = None             # the server round, on the host
    meta: Any = None                            # `fedround.FlatMeta`
    cohort_slots: Optional[Tuple[int, ...]] = None


# ---------------------------------------------------------------------------
# the protocol + registry
# ---------------------------------------------------------------------------

class Strategy:
    """Base strategy: dense download, dense training, upload = download
    mask.  Instances are stateless wrappers around a `StrategySpec`; the
    persistent state lives in the `sstate` dict threaded through rounds."""
    kind: ClassVar[str] = "base"

    def __init__(self, spec: Optional[StrategySpec] = None):
        self.spec = spec if spec is not None else StrategySpec(kind=self.kind)
        if self.spec.kind != self.kind:
            raise ValueError(f"spec kind {self.spec.kind!r} for a "
                             f"{self.kind!r} strategy")

    # --- hooks -------------------------------------------------------------
    def init_state(self, p_len: int, device=None) -> Dict[str, Any]:
        """The strategy's persistent state, its tensors on `device`."""
        return {}

    def download_mask(self, flatP, sstate, round_idx) -> torch.Tensor:
        """Global (non-per-client) download mask. (p_len,) bool."""
        return torch.ones_like(flatP, dtype=torch.bool)

    def download_base(self, flatP, sstate) -> torch.Tensor:
        return flatP

    def client_plan(self, m_down, slot: int, ctx: PlanContext) -> RoundPlan:
        return RoundPlan(m_down, None, UploadRule.fixed(m_down))

    def aggregate(self, deltas, ctx: PlanContext) -> torch.Tensor:
        """Combine the (n_clients, p_len) upload messages into the server
        pseudo-gradient.  Default: uniform averaging (FedAvg)."""
        return deltas.mean(0)

    def aggregate_sparse(self, idx, val, ctx: PlanContext) -> torch.Tensor:
        """`aggregate` over packed upload messages, (n_clients, cap)
        index/value rows with the sentinel index >= p_len in empty slots,
        without densifying them: one scatter-add
        (`fused_transport.sparse_accumulate`, or the edge tree
        `hierarchical_accumulate` when `spec.edge_shards > 0`, bitwise
        equal to it), then the uniform 1/C scaling.  Only called when
        `supports_sparse_aggregate` holds.  The scaling multiplies by the
        f32 reciprocal of C, as the reference's jitted `acc / C` is
        folded."""
        from repro_torch.kernels import fused_transport as ft
        if self.spec.edge_shards > 0:
            acc = ft.hierarchical_accumulate(idx, val, ctx.p_len,
                                             self.spec.edge_shards)
        else:
            acc = ft.sparse_accumulate(idx, val, ctx.p_len)
        return acc * float(np.float32(1.0) / np.float32(idx.shape[0]))

    @property
    def uniform_aggregation(self) -> bool:
        return True

    def post_round(self, sstate, flatP, *, P_base, m_down, round_idx,
                   ctx: Optional[PlanContext] = None):
        """End-of-round transition; returns (sstate', flatP')."""
        return sstate, flatP

    def __repr__(self):
        return f"{type(self).__name__}({self.spec})"


def call_post_round(strat: "Strategy", sstate, flatP, *, P_base, m_down,
                    round_idx, ctx: Optional[PlanContext]):
    """Invoke `strat.post_round`, passing `ctx=` only when the override
    accepts it (hooks written against the older signature keep working)."""
    params = inspect.signature(type(strat).post_round).parameters
    if "ctx" in params or any(p.kind is inspect.Parameter.VAR_KEYWORD
                              for p in params.values()):
        return strat.post_round(sstate, flatP, P_base=P_base, m_down=m_down,
                                round_idx=round_idx, ctx=ctx)
    return strat.post_round(sstate, flatP, P_base=P_base, m_down=m_down,
                            round_idx=round_idx)


_REGISTRY: Dict[str, Type[Strategy]] = {}


def register_strategy(kind: str):
    """Class decorator: `@register_strategy("flasc")` makes the class
    constructible from `StrategySpec(kind="flasc")` / the string "flasc"."""
    def deco(cls: Type[Strategy]) -> Type[Strategy]:
        if not issubclass(cls, Strategy):
            raise TypeError(f"{cls} is not a Strategy")
        cls.kind = kind
        _REGISTRY[kind] = cls
        return cls
    return deco


def registered_kinds() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def supports_sparse_aggregate(strat: "Strategy") -> bool:
    """True when `strat` would aggregate packed (index, value) uploads:
    the spec opts in, `aggregate` is the base-class uniform mean, no
    per-client upload densities, no low-rank upload compression."""
    spec = strat.spec
    return bool(spec.sparse_aggregate
                and type(strat).aggregate is Strategy.aggregate
                and not spec.client_densities
                and spec.lowrank_up == 0)


def sparse_aggregate_capacity(strat: "Strategy", p_len: int) -> int:
    """Static packed-message slot count for sparse aggregation: 0 when
    `strat` does not support it (read as "stay dense"), else
    `comm.pack_capacity` over the expected Top-K upload support."""
    if not supports_sparse_aggregate(strat):
        return 0
    from repro_torch.core import comm
    return comm.pack_capacity(
        p_len, int(sp.density_count(p_len, strat.spec.density_up)))


StrategyLike = Union[Strategy, StrategySpec, str]


def resolve(obj: StrategyLike) -> Strategy:
    """StrategySpec / kind-string / Strategy instance -> Strategy instance."""
    if isinstance(obj, Strategy):
        return obj
    if isinstance(obj, StrategySpec):
        try:
            cls = _REGISTRY[obj.kind]
        except KeyError:
            raise KeyError(f"no strategy registered for kind={obj.kind!r}; "
                           f"known: {registered_kinds()}") from None
        return cls(obj)
    if isinstance(obj, str):
        return resolve(StrategySpec(kind=obj))
    raise TypeError(f"cannot resolve {obj!r} to a Strategy")


# ---------------------------------------------------------------------------
# static flat-view metadata (shared by ffa / hetlora / two_stage_ortho)
# ---------------------------------------------------------------------------

def rank_index_map(lora_tree) -> Tuple[np.ndarray, np.ndarray]:
    """Static per-entry metadata for the flat view: (rank_idx, is_b), over
    the leaves in sorted-key order (the reference's `jax.tree` order).

    For a leaf 'a' (..., d_in, r): rank component = position % r.
    For a leaf 'b' (..., r, d_out): rank component = (position // d_out) % r.
    """
    rank_idx, is_b = [], []

    def walk(node, name):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], k)
            return
        shape = tuple(node.shape)
        n = int(np.prod(shape))
        pos = np.arange(n, dtype=np.int32)
        if name == "a":
            rank_idx.append(pos % shape[-1])
            is_b.append(np.zeros(n, np.int8))
        elif name == "b":
            r, d_out = shape[-2], shape[-1]
            rank_idx.append((pos // d_out) % r)
            is_b.append(np.ones(n, np.int8))
        else:  # non-LoRA leaf: no rank structure
            rank_idx.append(np.zeros(n, np.int32))
            is_b.append(np.ones(n, np.int8))

    walk(lora_tree, None)
    return np.concatenate(rank_idx), np.concatenate(is_b)


def _device_map(strat: Strategy, arr: np.ndarray, device, make,
                key: Any = None) -> torch.Tensor:
    """`make(arr)` as a tensor on `device`, cached on `strat` per (the
    static numpy array `arr`, `key` or else `make`, device).  A
    `FlatMeta`'s rank map is the same array every round, so each map is
    copied once per run, and without a host sync (`non_blocking`; the host
    copy stays referenced)."""
    cache = strat.__dict__.setdefault("_device_maps", {})
    ck = (id(arr), make if key is None else key, str(torch.device(device)))
    hit = cache.get(ck)
    if hit is None or hit[0] is not arr:
        host = np.ascontiguousarray(make(arr))
        hit = (arr, host, torch.from_numpy(host).to(device, non_blocking=True))
        cache[ck] = hit
    return hit[2]


def _is_b(is_b: np.ndarray) -> np.ndarray:
    return is_b == 1


def _is_a(is_b: np.ndarray) -> np.ndarray:
    return is_b != 1


# ---------------------------------------------------------------------------
# the paper's strategies
# ---------------------------------------------------------------------------

@register_strategy("lora")
class DenseLoRA(Strategy):
    """Dense LoRA (FedIT): everything moves, everything trains.  Full
    finetuning reuses it over the backbone vector."""


@register_strategy("flasc")
class Flasc(Strategy):
    """FLASC: Top-K download of P, dense local training, independent Top-K
    upload of the delta: the paper's method."""

    def download_mask(self, flatP, sstate, round_idx):
        return sel.topk_mask(flatP, self.spec.density_down,
                             selector=self.spec.selector)

    def client_plan(self, m_down, slot, ctx):
        s = self.spec
        d_up = s.client_densities[slot] if s.client_densities else s.density_up
        return RoundPlan(m_down, None, UploadRule.topk(d_up))


@register_strategy("flasc_ef")
class FlascEF(Flasc):
    """FLASC + server-side error feedback for download sparsity: the Top-K
    residual accumulates and is re-offered next round."""

    def init_state(self, p_len, device=None):
        return {"e": torch.zeros(p_len, dtype=torch.float32, device=device)}

    def download_mask(self, flatP, sstate, round_idx):
        return sel.topk_mask(flatP + sstate["e"], self.spec.density_down,
                             selector=self.spec.selector)

    def download_base(self, flatP, sstate):
        return flatP + sstate["e"]

    def post_round(self, sstate, flatP, *, P_base, m_down, round_idx,
                   ctx=None):
        return {"e": sp.apply_mask(P_base, ~m_down)}, flatP   # unsent residual


@register_strategy("sparse_adapter")
class SparseAdapter(Strategy):
    """Fixed sparse adapter (paper Appx A): one dense round, then magnitude-
    prune once and freeze the mask for download, training, and upload.
    `initialized` is a host bool, so only the first round runs the Top-K."""

    def init_state(self, p_len, device=None):
        return {"mask": torch.ones(p_len, dtype=torch.bool, device=device),
                "initialized": False}

    def download_mask(self, flatP, sstate, round_idx):
        return sstate["mask"]

    def client_plan(self, m_down, slot, ctx):
        return RoundPlan(m_down, m_down, UploadRule.fixed(m_down))

    def post_round(self, sstate, flatP, *, P_base, m_down, round_idx,
                   ctx=None):
        if sstate["initialized"]:
            return sstate, flatP
        mask = sel.topk_mask(flatP, self.spec.density_down,
                             selector=self.spec.selector)
        return {"mask": mask, "initialized": True}, flatP


@register_strategy("fedselect")
class FedSelect(Strategy):
    """Federated Select: a fresh Top-K mask of P each round, shared by
    download, training, and upload."""

    def download_mask(self, flatP, sstate, round_idx):
        return sel.topk_mask(flatP, self.spec.density_down,
                             selector=self.spec.selector)

    def client_plan(self, m_down, slot, ctx):
        return RoundPlan(m_down, m_down, UploadRule.fixed(m_down))


@register_strategy("adapter_lth")
class AdapterLTH(Strategy):
    """Lottery-ticket adapter: multiplicative density decay with permanent
    pruning every `lth_prune_every` rounds (never in round 0).  The
    schedule is decided on the host; the density, the keep-count and the
    mask stay on the device."""

    def init_state(self, p_len, device=None):
        return {"mask": torch.ones(p_len, dtype=torch.bool, device=device),
                "density": torch.ones((), dtype=torch.float32, device=device)}

    def download_mask(self, flatP, sstate, round_idx):
        return sstate["mask"]

    def client_plan(self, m_down, slot, ctx):
        return RoundPlan(m_down, m_down, UploadRule.fixed(m_down))

    def post_round(self, sstate, flatP, *, P_base, m_down, round_idx,
                   ctx=None):
        spec = self.spec
        if round_idx % spec.lth_prune_every == 0 and round_idx > 0:
            n = flatP.shape[-1]
            dens = torch.clamp_min(sstate["density"] * spec.lth_keep, 1e-4)
            masked = torch.where(sstate["mask"], flatP.abs(),
                                 torch.zeros((), dtype=flatP.dtype,
                                             device=flatP.device))
            # `masked > 0` keeps pruned entries pruned under the exact
            # selector, whose rank selection would resurrect zeros on ties
            k = torch.clamp(torch.round(n * dens).to(torch.int32), 1, n - 1)
            mask = sel.topk_mask_by_count(masked, k, selector=spec.selector) \
                & (masked > 0)
            sstate = {"mask": mask, "density": dens}
        return sstate, sp.apply_mask(flatP, sstate["mask"])


@register_strategy("ffa")
class FFALoRA(Strategy):
    """FFA-LoRA: download everything, but train and upload only the B
    matrices (A frozen at init).  Every client of a round gets the same
    mask object, so the round shares it instead of stacking copies."""

    def client_plan(self, m_down, slot, ctx):
        if ctx.is_b is None:
            raise ValueError("ffa needs FlatMeta rank metadata")
        m_train = _device_map(self, ctx.is_b, m_down.device, _is_b)
        return RoundPlan(m_down, m_train, UploadRule.fixed(m_train))


@register_strategy("hetlora")
class HetLoRA(Strategy):
    """Heterogeneous LoRA: client c sees only the leading `hetlora_ranks[c]`
    rank components (structured nested masks) for download, training, and
    upload.  With `hetlora_weighted=True` the aggregation divides each
    entry by the number of clients whose rank slice covers it, instead of
    the full cohort size."""

    def client_plan(self, m_down, slot, ctx):
        if ctx.rank_idx is None:
            raise ValueError("hetlora needs FlatMeta rank metadata")
        r_c = self.spec.hetlora_ranks[slot]
        rank_idx = _device_map(self, ctx.rank_idx, m_down.device,
                               np.asarray)
        m = rank_idx < r_c
        return RoundPlan(m, m, UploadRule.fixed(m))

    def coverage(self, ctx: PlanContext) -> np.ndarray:
        """(p_len,) count of aggregated rows whose rank mask covers each
        entry: the full 0..n_clients-1 cohort, or the slots of
        `ctx.cohort_slots` (a slot appearing twice counts twice)."""
        if ctx.rank_idx is None:
            raise ValueError("hetlora needs FlatMeta rank metadata")
        if ctx.cohort_slots is not None:
            ranks = np.asarray([self.spec.hetlora_ranks[s]
                                for s in ctx.cohort_slots])
        else:
            ranks = np.asarray(self.spec.hetlora_ranks[:ctx.n_clients])
            if len(ranks) != ctx.n_clients:
                raise ValueError(f"{len(self.spec.hetlora_ranks)} hetlora "
                                 f"ranks for {ctx.n_clients} clients")
        return np.sum(ranks[:, None] > ctx.rank_idx[None, :], axis=0)

    def aggregate(self, deltas, ctx):
        if not self.spec.hetlora_weighted:
            return super().aggregate(deltas, ctx)
        cov = _device_map(
            self, ctx.rank_idx, deltas.device,
            lambda _: np.maximum(self.coverage(ctx), 1).astype(np.float32),
            key=("coverage", ctx.n_clients, ctx.cohort_slots))
        return deltas.sum(0) / cov

    @property
    def uniform_aggregation(self) -> bool:
        return not self.spec.hetlora_weighted


# ---------------------------------------------------------------------------
# the named communication-efficiency baselines
# ---------------------------------------------------------------------------

@register_strategy("flocora")
class FloCoRA(DenseLoRA):
    """FLoCoRA (Grativol et al., arXiv:2406.14082): dense LoRA rounds whose
    messages are low-rank compressed by the `transport.LowRankCompress`
    stage in both directions; each unset (zero) rank defaults to 8.  Mode
    "random" ships only the seeded-projection coefficients, "learned" both
    SVD factors."""

    DEFAULT_RANK = 8

    def __init__(self, spec: Optional[StrategySpec] = None):
        spec = spec if spec is not None else StrategySpec(kind="flocora")
        spec = dataclasses.replace(
            spec, lowrank_down=spec.lowrank_down or self.DEFAULT_RANK,
            lowrank_up=spec.lowrank_up or self.DEFAULT_RANK)
        super().__init__(spec)


@register_strategy("two_stage_ortho")
class TwoStageOrtho(Strategy):
    """Two-stage sparsified-orthogonal updates (Kim & Choi,
    arXiv:2505.00333): the A and B factors alternate communication phases
    of `phase_len` rounds (A first; non-LoRA leaves ride the B phase),
    uploads are Top-K at `density_up`, and after every A phase the server
    replaces each A by the Q of its reduced QR and folds R into B, which
    keeps every product A·B.  Download stays dense."""

    def _phase_mask(self, ctx: PlanContext, device) -> torch.Tensor:
        if ctx.is_b is None:
            raise ValueError("two_stage_ortho needs FlatMeta rank metadata")
        if ctx.round_idx is None:
            raise ValueError("two_stage_ortho needs PlanContext.round_idx")
        phase_b = (ctx.round_idx // self.spec.phase_len) % 2 == 1
        return _device_map(self, ctx.is_b, device,
                           _is_b if phase_b else _is_a)

    def client_plan(self, m_down, slot, ctx):
        return RoundPlan(m_down, self._phase_mask(ctx, m_down.device),
                         UploadRule.topk(self.spec.density_up))

    def post_round(self, sstate, flatP, *, P_base, m_down, round_idx,
                   ctx=None):
        if ctx is None or ctx.meta is None:
            raise ValueError("two_stage_ortho.post_round needs "
                             "PlanContext.meta")
        # fold once per A phase, on its last round
        L = self.spec.phase_len
        if (round_idx // L) % 2 == 0 and (round_idx + 1) % L == 0:
            meta = ctx.meta
            flatP = meta.flatten(_ortho_lora_pairs(meta.unflatten(flatP)))
        return sstate, flatP


def _ortho_lora_pairs(tree):
    """Reduced-QR every {'a', 'b'} LoRA pair in a mirrored tree:
    a -> Q, b -> R @ b (product-preserving; batched over any leading
    stacked-layer dims).  A wide A (d_in < r) is left as it is."""
    if isinstance(tree, dict) and {"a", "b"} <= set(tree) \
            and not isinstance(tree["a"], dict):
        a, b = tree["a"], tree["b"]
        if a.shape[-2] < a.shape[-1]:
            return tree
        q, r = torch.linalg.qr(a.float())
        return {**tree, "a": q.to(a.dtype),
                "b": (r @ b.float()).to(b.dtype)}
    if isinstance(tree, dict):
        return {k: _ortho_lora_pairs(v) for k, v in tree.items()}
    return tree
