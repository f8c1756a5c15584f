"""Figure 6: systems heterogeneity — Heterogeneous LoRA (per-client rank)
vs FLASC (per-client density) vs Federated Select, at low (2-tier) and high
(4-tier) budget spread.  The port of `benchmarks/fig6_system_het.py`.

Paper claim: all three are competitive here; FLASC needs no extra
configuration.

Beyond-paper: an async staleness sweep.  The same 4-tier budget spread is
expressed as *system* heterogeneity (per-client compute speed and
bandwidth via `ClientSystemProfile.tiered`) and FLASC runs under the
event-driven `AsyncEngine` with FedBuff-style buffered aggregation,
sweeping the buffer size, the staleness-discount exponent, and a
max-staleness drop policy — reporting utility alongside the simulated
time the run took."""
from __future__ import annotations

from benchmarks_torch.common import default_fed, emit, get_task, row, run
from repro_torch.core.strategies import StrategySpec
from repro_torch.federated.async_clock import ClientSystemProfile
from repro_torch.federated.engine import AsyncEngine

RANK = 16


def tiers(n_clients, n_tiers):
    """budget tier per client slot, round-robin."""
    return tuple((i % n_tiers) + 1 for i in range(n_clients))


def main(device=None):
    task = get_task("synth_image")
    fed = default_fed()
    rows = []
    for n_tiers, tag in ((2, "low"), (4, "high")):
        bs = tiers(fed.n_clients, n_tiers)
        # HetLoRA: client rank r_c = RANK * (b/n_tiers); FLASC: density b/n_tiers
        het = StrategySpec(kind="hetlora",
                           hetlora_ranks=tuple(max(RANK * b // n_tiers, 1) for b in bs))
        fla = StrategySpec(kind="flasc", density_down=1.0,
                           client_densities=tuple(b / n_tiers for b in bs))
        fse = StrategySpec(kind="fedselect", density_down=sum(bs) / len(bs) / n_tiers)
        for name, spec in (("hetlora", het), ("flasc", fla), ("fedselect", fse)):
            res = run(task, spec, fed=fed, lora_rank=RANK, device=device)
            rows.append(row("fig6", f"{tag}/{name}", "best_acc", res.best_acc()))

    # --- async staleness sweep (buffered aggregation under 4-tier speeds) --
    profile = ClientSystemProfile.tiered(fed.n_clients, 4)
    fla = StrategySpec(kind="flasc", density_down=0.25, density_up=0.25)
    sweeps = [AsyncEngine(buffer_size=k, staleness_alpha=alpha,
                          profile=profile)
              for k in (fed.n_clients, max(fed.n_clients // 2, 1))
              for alpha in (0.0, 0.5)]
    sweeps.append(AsyncEngine(buffer_size=max(fed.n_clients // 2, 1),
                              staleness_alpha=0.5, max_staleness=2,
                              profile=profile))
    for engine in sweeps:
        res = run(task, fla, fed=fed, lora_rank=RANK, engine=engine,
                  device=device)
        drop = (f"_s{engine.max_staleness}"
                if engine.max_staleness is not None else "")
        tag = (f"async/buf{engine.buffer_size}"
               f"_a{engine.staleness_alpha}{drop}")
        rows.append(row("fig6", tag, "best_acc", res.best_acc()))
        rows.append(row("fig6", tag, "sim_time", res.history[-1]["sim_time"]))
    return emit(rows, "Figure 6: systems heterogeneity (+async staleness "
                      "sweep)")


if __name__ == "__main__":
    main()
