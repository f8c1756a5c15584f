"""The federated round: FLASC Algorithm 1, strategy-agnostic.

The port of `src/repro/core/fedround.py` (the synchronous round).  One
call is one FL round: ask the `Strategy` for a global download mask and
one `RoundPlan` per client, send the download, run every client's local
SGD(+momentum) steps, route the uploads through the `core.transport`
pipeline, aggregate, apply the FedAdam server step, and hand the round to
the strategy's `post_round` hook.

How the reference's JAX structure maps here:
  - `jax.vmap` over clients is a Python loop for local training; the
    uploads are stacked into one (C, p_len) tensor and each transport pass
    runs once over all of them (one kernel launch per pass).
  - `lax.scan` over local steps is a Python loop.
  - the gradient is `torch.autograd.grad(loss, flat)` on a leaf `flat`;
    `FlatMeta.unflatten` returns views, so the LoRA tree is differentiable
    and the frozen backbone (no `requires_grad`) gets no gradient.
  - nothing on the round path syncs with the host: counts, thresholds and
    the step count stay on the device until the engine pulls the metrics.

The rng schedule.  The reference derives the round key as
`fold_in(key(seed + 2), r)` and splits it into n_clients + 1 quantization
keys (one per client's upload, the last one shared by the download).  The
port keeps that shape with integer seeds: the engine passes
`round_seed = fold_in(seed + 2, r)`, and the client c upload generator is
seeded with `fold_in(round_seed, c)`, the download's with
`fold_in(round_seed, n_clients)` (`fold_in` is a SplitMix64 hash on the
host; generators live on the vector's device).  Torch and JAX draw
different numbers, so runs that quantize stochastically compare across
packages only in distribution.

With `StrategySpec(sparse_aggregate=True)` the uploads are packed into
(index, value) rows (`fused_transport.pack_values_batch`, one kernel
launch) and scatter-added by `Strategy.aggregate_sparse`; a message that
overflows the packed capacity flips the round to the dense mean with a
`torch.where`, so the overflow test stays on the device too.

The split-phase round of the async engine (`make_client_phase_fn`,
`make_server_phase_fn`) reuses the client block `_run_clients`.  Its
version seed is `fold_in(seed + 2, version)`; slot c's upload generator is
seeded with `fold_in(version_seed, c)`, and with
`fold_in(fold_in(version_seed, c), rep)` for its rep-th repeat job against
the same version (rep > 0); the download's with
`fold_in(version_seed, n_clients)`.  With every slot and no repeats the
client phase computes exactly one round's client block.

Not ported yet: DP clipping (`core/dp.py`, `dp_clip > 0` raises) and the
population / momentum-carrying round (ROADMAP queue 1).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import sparsity as sp
from repro_torch.core import strategies as st
from repro_torch.core import transport as tp
from repro_torch.kernels import fused_transport as ft
from repro_torch.models.config import FederatedConfig
from repro_torch.optim import adam_init, adam_update

LossFn = Callable[..., torch.Tensor]
# loss_of(trainable_tree, microbatch) -> scalar, or, with the backbone
# passed explicitly (`RoundTask.params`), loss_of(params, tree, microbatch)

_MASK64 = (1 << 64) - 1


def fold_in(seed: int, data: int) -> int:
    """Deterministic 63-bit seed for (seed, data): SplitMix64 finalizer of
    the pair, computed on the host (no device work, no sync)."""
    z = (seed * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


@dataclasses.dataclass
class FlatMeta:
    """Static flatten metadata for the trainable tree (nested dicts of
    tensors).  Leaves are flattened in sorted-key order, the order of the
    reference's `jax.tree.flatten`, so index i of the flat vector is the
    same adapter entry in both packages."""
    paths: Tuple[Tuple[str, ...], ...]
    shapes: Tuple[Tuple[Tuple[int, ...], torch.dtype], ...]
    p_len: int
    rank_idx: Optional[np.ndarray] = None
    is_b: Optional[np.ndarray] = None

    @classmethod
    def of(cls, tree, with_rank_map: bool = True) -> "FlatMeta":
        paths, shapes = [], []

        def walk(node, path):
            if isinstance(node, dict):
                for k in sorted(node):
                    walk(node[k], path + (k,))
            elif isinstance(node, torch.Tensor):
                paths.append(path)
                shapes.append((tuple(node.shape), node.dtype))
            else:
                raise TypeError(f"FlatMeta takes nested dicts of tensors; "
                                f"{'/'.join(path)} is a {type(node).__name__}")

        walk(tree, ())
        p_len = int(sum(int(np.prod(s)) for s, _ in shapes))
        rk = ib = None
        if with_rank_map:
            rk, ib = st.rank_index_map(tree)
        return cls(tuple(paths), tuple(shapes), p_len, rk, ib)

    def flatten(self, tree) -> torch.Tensor:
        leaves = []
        for path in self.paths:
            node = tree
            for k in path:
                node = node[k]
            leaves.append(node.reshape(-1).float())
        return torch.cat(leaves)

    def unflatten(self, flat: torch.Tensor):
        """Nested dict of views of `flat` (cast to each leaf's dtype), so
        a gradient flows back to `flat`."""
        out: Dict[str, Any] = {}
        off = 0
        for path, (shape, dtype) in zip(self.paths, self.shapes):
            n = int(np.prod(shape))
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = flat[off:off + n].view(shape).to(dtype)
            off += n
        return out

    def plan_context(self, n_clients: int, round_idx=None,
                     cohort_slots=None) -> st.PlanContext:
        return st.PlanContext(p_len=self.p_len, n_clients=n_clients,
                              rank_idx=self.rank_idx, is_b=self.is_b,
                              round_idx=round_idx, meta=self,
                              cohort_slots=cohort_slots)


class PhaseTimes:
    """Time of each phase of a round, for a profile of where a round goes.

    The clock starts at construction; `mark(name)` closes the phase that
    ran since the previous mark.  On a CUDA device it records an event on
    the current stream (no host sync); `read()`, called by the engine after
    the round's metrics pull, returns {phase: ms} from the events.  On the
    CPU it reads the host clock.  A phase marked more than once (one per
    client) is summed."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._marks: List[Tuple[str, Any]] = [("", self._stamp())]

    def _stamp(self):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            return ev
        return time.perf_counter()

    def mark(self, name: str) -> None:
        self._marks.append((name, self._stamp()))

    def read(self) -> Dict[str, float]:
        if self.device.type == "cuda":
            self._marks[-1][1].synchronize()
        out: Dict[str, float] = {}
        for (_, a), (name, b) in zip(self._marks, self._marks[1:]):
            ms = (a.elapsed_time(b) if self.device.type == "cuda"
                  else 1e3 * (b - a))
            out[name] = out.get(name, 0.0) + ms
        return out


def init_server(flatP: torch.Tensor):
    return {"opt": adam_init(flatP),
            "round": torch.zeros((), dtype=torch.int32, device=flatP.device)}


def _client_update(flat0, cbatch, m_train, *, loss_of, meta: FlatMeta,
                   fed: FederatedConfig):
    """One client's local steps. cbatch leaves: (local_steps, local_bs, ...).
    Returns (delta = flat0 - flat_T, mean loss).  The upload transport runs
    over the whole cohort's stacked deltas in `_run_clients`."""
    flat = flat0
    mu = torch.zeros_like(flat0)
    losses = []
    steps = next(iter(cbatch.values())).shape[0]
    for i in range(steps):
        mb = {k: v[i] for k, v in cbatch.items()}
        f = flat.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = loss_of(meta.unflatten(f), mb)
            (g,) = torch.autograd.grad(loss, f)
        if m_train is not None:
            g = g * m_train
        mu = fed.client_momentum * mu + g
        flat = flat - fed.client_lr * mu
        losses.append(loss.detach())
    return flat0 - flat, torch.stack(losses).mean()


def _share_or_stack(items):
    """(value, axis): identical plan fields stay one shared operand;
    client-varying fields are stacked on a leading client axis."""
    if all(it is items[0] for it in items):
        return items[0], None
    return torch.stack(items), 0


def _run_clients(P_base, plans, client_batches, s: st.StrategySpec, *,
                 loss_of: LossFn, meta: FlatMeta, fed: FederatedConfig,
                 phases: PhaseTimes, kdown=None, upgens=None):
    """Send the download, run every client's local update, and pass the
    stacked deltas through the upload pipeline once.  `phases` gets one
    mark per phase.

    Returns ((upload values (C, p_len), up_nnz (C,), losses (C,),
    down_nnz (C,)), (m_down, axis)) like the reference's `_run_clients`.
    """
    if tp.lowrank_stage(s, "down") is not None or \
            tp.lowrank_stage(s, "up") is not None:
        raise NotImplementedError(
            "low-rank message compression is not ported yet (ROADMAP queue "
            "1, item 6)")
    C = len(plans)
    m_down_cs, ax_down = _share_or_stack([p.m_down for p in plans])
    trains = [p.m_train for p in plans]
    if all(t is None for t in trains):
        m_train_cs, ax_train = None, None
    else:
        ones = torch.ones(meta.p_len, dtype=torch.bool, device=P_base.device)
        m_train_cs, ax_train = _share_or_stack(
            [ones if t is None else t for t in trains])

    up_modes = {p.upload.mode for p in plans}
    if len(up_modes) != 1:
        raise ValueError(f"mixed upload modes unsupported: {up_modes}")
    up_mode = up_modes.pop()
    up_counts = None
    if up_mode == "fixed":
        up_mask, _ = _share_or_stack([p.upload.mask for p in plans])
    else:
        densities = [p.upload.density for p in plans]
        if len(set(densities)) > 1:             # per-client keep-counts
            up_counts = torch.tensor(
                [sp.density_count(meta.p_len, d) for d in densities],
                dtype=torch.int32, device=P_base.device)

    # --- download: one message when the mask is shared ---------------------
    base = P_base if ax_down is None else P_base.expand(C, -1)
    down = tp.download_pipeline(m_down_cs, s.quant_bits_down)(base, rng=kdown)
    down_nnz = down.nnz.expand(C) if ax_down is None else down.nnz
    phases.mark("download")

    # --- local training, one client at a time ------------------------------
    deltas, losses = [], []
    for c in range(C):
        cb = {k: v[c] for k, v in client_batches.items()}
        flat0 = down.values if ax_down is None else down.values[c]
        m_tr = None if m_train_cs is None else (
            m_train_cs if ax_train is None else m_train_cs[c])
        delta, loss = _client_update(flat0, cb, m_tr, loss_of=loss_of,
                                     meta=meta, fed=fed)
        deltas.append(delta)
        losses.append(loss)
        phases.mark("local_update")
    deltas = torch.stack(deltas)

    # --- upload: each transport pass once over the stacked deltas ----------
    if up_mode == "fixed":
        pipe = tp.upload_pipeline(st.UploadRule.fixed(up_mask),
                                  s.quant_bits_up, selector=s.selector)
    else:
        pipe = tp.upload_pipeline(plans[0].upload, s.quant_bits_up,
                                  selector=s.selector, count=up_counts)
    up = pipe(deltas, rng=upgens)
    phases.mark("upload")
    return (up.values, up.nnz, torch.stack(losses), down_nnz), \
        (m_down_cs, ax_down)


def _aggregate_uploads(strat: st.Strategy, deltas, ctx):
    """`Strategy.aggregate` on the (C, p_len) uploads, or, when the strategy
    opts in (`StrategySpec.sparse_aggregate`), their packed form through
    `Strategy.aggregate_sparse`: each row packed to the static capacity
    (`fused_transport.pack_values_batch`) and scatter-added.  A message
    whose support exceeds the capacity flips the round to the dense rule,
    chosen on the device (`torch.where`), so nothing is truncated and the
    host is not asked."""
    cap = st.sparse_aggregate_capacity(strat, ctx.p_len)
    if cap == 0:
        return strat.aggregate(deltas, ctx)
    idx, val, pnnz = ft.pack_values_batch(deltas, cap)
    overflow = (pnnz > cap).any()
    return torch.where(overflow, strat.aggregate(deltas, ctx),
                       strat.aggregate_sparse(idx, val, ctx))


def federated_round(flatP, server_state, sstate, client_batches, rng_seed, *,
                    loss_of: LossFn, meta: FlatMeta, fed: FederatedConfig,
                    strategy: st.StrategyLike, params=None):
    """One round.  client_batches: dict of tensors shaped (n_clients,
    local_steps, local_bs, ...).  `rng_seed` (int, or None for no
    stochastic rounding) seeds the round's quantization generators (see the
    module doc).  `params`, when given, is the frozen backbone, passed to
    `loss_of(params, tree, mb)`.  Returns (flatP', server_state', sstate',
    metrics), every metric a tensor on the device except `phase_ms`, the
    round's `PhaseTimes` (download mask, download, local updates, upload,
    server step), which the engine reads after its metrics pull."""
    strat = st.resolve(strategy)
    if params is not None:
        loss_of = functools.partial(loss_of, params)
    if fed.dp_clip > 0.0:
        raise NotImplementedError(
            "DP clipping (core/dp.py) is not ported yet (ROADMAP queue 1, "
            "item 6)")
    s = strat.spec
    round_idx = server_state["round"]
    n_clients = next(iter(client_batches.values())).shape[0]
    phases = PhaseTimes(flatP.device)

    m_down_global = strat.download_mask(flatP, sstate, round_idx)
    P_base = strat.download_base(flatP, sstate)
    ctx = meta.plan_context(n_clients, round_idx=round_idx)
    plans = [strat.client_plan(m_down_global, c, ctx) for c in range(n_clients)]
    phases.mark("download_mask")

    # --- per-message quantization generators (stochastic rounding) --------
    use_keys = rng_seed is not None and bool(s.quant_bits_up
                                             or s.quant_bits_down)
    kdown = upgens = None
    if use_keys:
        dev = flatP.device
        kdown = generator(fold_in(rng_seed, n_clients), dev)
        upgens = [generator(fold_in(rng_seed, c), dev)
                  for c in range(n_clients)]

    (deltas, nnzs, losses, down_nnzs), (m_down_cs, ax_down) = _run_clients(
        P_base, plans, client_batches, s, loss_of=loss_of, meta=meta, fed=fed,
        phases=phases, kdown=kdown, upgens=upgens)

    if ax_down is None:     # shared mask: bill the global mask support
        down_nnz = m_down_cs.sum(dtype=torch.float32)
    else:                   # per-client masks: average per-client size
        down_nnz = down_nnzs.mean()

    # --- aggregate + server update ----------------------------------------
    pseudo_grad = _aggregate_uploads(strat, deltas, ctx)
    if fed.server_opt == "adam":
        flatP, opt = adam_update(flatP, pseudo_grad, server_state["opt"],
                                 fed.server_lr, fed.adam_b1, fed.adam_b2,
                                 fed.adam_eps)
    else:   # FedAvg/FedSGD rule (paper Appendix A): W <- W - lr * mean(delta)
        flatP = flatP - fed.server_lr * pseudo_grad
        opt = server_state["opt"]

    sstate, flatP = st.call_post_round(strat, sstate, flatP, P_base=P_base,
                                       m_down=m_down_global,
                                       round_idx=round_idx, ctx=ctx)
    server_state = {"opt": opt, "round": round_idx + 1}
    phases.mark("server")

    metrics = {
        "loss": losses.mean(),
        "down_nnz": down_nnz,
        "up_nnz": nnzs.sum(),
        "grad_norm": torch.linalg.vector_norm(pseudo_grad),
        # per-message sizes for the ledger's per-message coding
        "down_nnz_clients": down_nnzs,
        "up_nnz_clients": nnzs,
        # per-client losses: the engine records their host-side mean
        "loss_clients": losses,
        "phase_ms": phases,
    }
    return flatP, server_state, sstate, metrics


def make_round_fn(loss_of: LossFn, meta: FlatMeta, fed: FederatedConfig,
                  strategy: st.StrategyLike, *, with_params: bool = False):
    """Closure over the static pieces; `strategy` may be a Strategy,
    StrategySpec, or kind string.  `with_params=True`: the returned
    function takes the frozen backbone first,

        fn(params, flatP, server_state, sstate, client_batches, rng_seed)
    """
    strat = st.resolve(strategy)

    def fn(params, flatP, server_state, sstate, client_batches, rng_seed):
        return federated_round(flatP, server_state, sstate, client_batches,
                               rng_seed, loss_of=loss_of, meta=meta, fed=fed,
                               strategy=strat, params=params)

    if with_params:
        return fn
    return functools.partial(fn, None)


# ---------------------------------------------------------------------------
# split-phase round (the async engine): client compute and the server update
# are separate calls, so clients run against stale server snapshots and the
# server aggregates a buffer of updates from mixed versions
# ---------------------------------------------------------------------------

def make_client_phase_fn(loss_of: LossFn, meta: FlatMeta, fed: FederatedConfig,
                         strategy: st.StrategyLike, slots: Tuple[int, ...],
                         repeats: Optional[Tuple[int, ...]] = None,
                         pack_cap: Optional[int] = None, *,
                         with_params: bool = False):
    """Client side of the split round: run the cohort slots `slots` (global
    client indices) against one server snapshot.

        fn(flatP, sstate, round_idx, client_batches, rng_seed, phases=None)
            -> (deltas, up_nnzs, losses, down_nnzs)

    with the frozen backbone first when `with_params=True`, and three more
    outputs (idx, val, pnnz) with `pack_cap` set: each upload row packed
    to `pack_cap` (index, value) slots by `fused_transport.
    pack_values_batch` (one launch).  `client_batches` leaves are
    (len(slots), local_steps, local_bs, ...); `rng_seed` is the version
    seed (see the module doc) or None; `phases`, a `PhaseTimes`, gets one
    mark per phase.  `repeats[i] > 0` marks slot i's repeat-th job against
    the same version, whose upload generator folds the repeat in."""
    strat = st.resolve(strategy)
    s = strat.spec
    repeats = tuple(repeats) if repeats is not None else (0,) * len(slots)
    if len(repeats) != len(slots):
        raise ValueError(f"{len(repeats)} repeats for {len(slots)} slots")

    def phase(params, flatP, sstate, round_idx, client_batches, rng_seed,
              phases: Optional[PhaseTimes] = None):
        loss = loss_of if params is None else functools.partial(loss_of,
                                                                params)
        phases = PhaseTimes(flatP.device) if phases is None else phases
        m_down_global = strat.download_mask(flatP, sstate, round_idx)
        P_base = strat.download_base(flatP, sstate)
        ctx = meta.plan_context(fed.n_clients, round_idx=round_idx)
        plans = [strat.client_plan(m_down_global, c, ctx) for c in slots]
        phases.mark("download_mask")

        kdown = upgens = None
        if rng_seed is not None and (s.quant_bits_up or s.quant_bits_down):
            dev = flatP.device
            kdown = generator(fold_in(rng_seed, fed.n_clients), dev)
            upgens = [generator(fold_in(rng_seed, c) if rep == 0 else
                                fold_in(fold_in(rng_seed, c), rep), dev)
                      for c, rep in zip(slots, repeats)]

        (deltas, nnzs, losses, down_nnzs), _ = _run_clients(
            P_base, plans, client_batches, s, loss_of=loss, meta=meta,
            fed=fed, phases=phases, kdown=kdown, upgens=upgens)
        if pack_cap:
            idx, val, pnnz = ft.pack_values_batch(deltas, pack_cap)
            phases.mark("pack")
            return deltas, nnzs, losses, down_nnzs, idx, val, pnnz
        return deltas, nnzs, losses, down_nnzs

    if with_params:
        return phase
    return functools.partial(phase, None)


def make_server_phase_fn(meta: FlatMeta, fed: FederatedConfig,
                         strategy: st.StrategyLike, *, sparse: bool = False,
                         cohort_slots: Optional[Tuple[int, ...]] = None):
    """Server side of the split round: one buffered aggregation event (the
    aggregate / server-optimizer / `post_round` tail of `federated_round`).

        fn(flatP, server_state, sstate, deltas, weights)
            -> (flatP', server_state', sstate')

    `deltas` (k, p_len) are the buffered uploads and `weights` (k,) f32
    their staleness discounts; each row is scaled by its weight before
    `Strategy.aggregate`, and `x * 1.0` is exact, so unit weights give the
    synchronous update bit for bit.  With `sparse=True` (only when
    `strategies.supports_sparse_aggregate` holds) the buffer is packed,

        fn(flatP, server_state, sstate, idx, val, weights)

    with (k, cap) rows, the weights scale the packed values, and the
    pseudo-gradient comes from `Strategy.aggregate_sparse`.
    `cohort_slots` names the client slot of each buffered row for the
    plan context (None: the full cohort)."""
    strat = st.resolve(strategy)
    if sparse and not st.supports_sparse_aggregate(strat):
        raise ValueError(f"{strat} does not aggregate packed uploads")

    def fn(flatP, server_state, sstate, *rest):
        round_idx = server_state["round"]
        m_down = strat.download_mask(flatP, sstate, round_idx)
        P_base = strat.download_base(flatP, sstate)
        ctx = meta.plan_context(fed.n_clients, round_idx=round_idx,
                                cohort_slots=cohort_slots)
        if sparse:
            idx, val, weights = rest
            pseudo_grad = strat.aggregate_sparse(idx, val * weights[:, None],
                                                 ctx)
        else:
            deltas, weights = rest
            pseudo_grad = strat.aggregate(deltas * weights[:, None], ctx)

        if fed.server_opt == "adam":
            flatP2, opt = adam_update(flatP, pseudo_grad, server_state["opt"],
                                      fed.server_lr, fed.adam_b1, fed.adam_b2,
                                      fed.adam_eps)
        else:   # FedAvg/FedSGD rule (paper Appendix A)
            flatP2 = flatP - fed.server_lr * pseudo_grad
            opt = server_state["opt"]
        sstate2, flatP2 = st.call_post_round(strat, sstate, flatP2,
                                             P_base=P_base, m_down=m_down,
                                             round_idx=round_idx, ctx=ctx)
        return flatP2, {"opt": opt, "round": round_idx + 1}, sstate2
    return fn
