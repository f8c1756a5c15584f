"""Figure 3: time to reach a target accuracy under asymmetric up/down
bandwidth (upload at 1x, 1/4x, 1/16x of the download speed).  The port of
`benchmarks/fig3_async_bandwidth.py`.

Runs every method under the event-driven `AsyncEngine` with a comm-only
`ClientSystemProfile` (step_time=0, upload bandwidth scaled down per grid
point), so the reported `sim_time` is the *simulated* wall-clock at which
each round's coded download+upload completed on the event queue.  Two
timing columns per method and ratio:

  * sim_time / sim_rel_time — the async engine's virtual clock
    (time-to-target read off the run's history records);
  * rel_time / rel_time_coded — the post-hoc bytes/bandwidth arithmetic
    over the same histories, kept for comparison.

Paper claim: FLASC's independent upload density makes it robust to slow
uploads — d_up=1/64 reaches target ~16x faster than dense LoRA.

Sentinel: when a method never reaches the target — or the dense-LoRA
reference never does, so there is no baseline to normalize against —
relative rows carry -1.0 (see `rel_row`).
"""
from __future__ import annotations

from benchmarks_torch.common import emit, get_task, row, run
from repro_torch.core.strategies import StrategySpec
from repro_torch.federated.async_clock import ClientSystemProfile
from repro_torch.federated.engine import AsyncEngine

METHODS = {
    "lora": StrategySpec(kind="lora"),
    "flasc_1/4_1/4": StrategySpec(kind="flasc", density_down=0.25, density_up=0.25),
    "flasc_1/4_1/16": StrategySpec(kind="flasc", density_down=0.25, density_up=1 / 16),
    "flasc_1/4_1/64": StrategySpec(kind="flasc", density_down=0.25, density_up=1 / 64),
    "sparse_adapter_1/4": StrategySpec(kind="sparse_adapter", density_down=0.25),
    "adapter_lth_.98": StrategySpec(kind="adapter_lth", lth_keep=0.98),
    # baselines (docs/baselines.md): both attack the same asymmetric-
    # bandwidth problem — flocora shrinks every message to dense-coded
    # low-rank factors; two_stage_ortho halves and Top-K-sparsifies uploads
    "flocora_r8": StrategySpec(kind="flocora"),
    "two_stage_ortho_1/16": StrategySpec(kind="two_stage_ortho",
                                         density_up=1 / 16),
}
BW_RATIOS = (1, 4, 16)          # download/upload speed ratio
DOWN_BW = 1e6                   # bytes/sec; times reported relative to LoRA


def sim_time_to_target(history, target):
    """Virtual-clock time at the first eval record at/above `target`
    (None if the run never reached it)."""
    for h in history:
        if h.get("acc", 0.0) >= target:
            return h["sim_time"]
    return None


def posthoc_time_to_target(history, target, ratio, coded=False):
    """The post-hoc estimate: cumulative bytes / bandwidth at the first eval
    record at/above `target` (None if never reached)."""
    dk, uk = (("down_coded_bytes", "up_coded_bytes") if coded
              else ("down_bytes", "up_bytes"))
    for h in history:
        if h.get("acc", 0.0) >= target:
            return h[dk] / DOWN_BW + h[uk] / (DOWN_BW / ratio)
    return None


def rel_row(figure, setting, metric, t, base_t):
    """Relative-time row with the -1.0 sentinel when the method never
    reached the target (t is None) or the dense-LoRA baseline never did
    (base_t is None)."""
    if t is None or base_t is None:
        return row(figure, setting, metric, -1.0)
    return row(figure, setting, metric, t / base_t)


def main(device=None):
    task = get_task("synth_text")
    rows = []
    results = {}                # (name, ratio) -> ExperimentResult
    for ratio in BW_RATIOS:
        profile = ClientSystemProfile(step_time=0.0, down_bw=DOWN_BW,
                                      up_bw=DOWN_BW / ratio)
        for name, spec in METHODS.items():
            results[(name, ratio)] = run(
                task, spec, engine=AsyncEngine(profile=profile),
                device=device)
    # target = fraction of the dense-LoRA best accuracy (70%-style threshold)
    target = 0.9 * results[("lora", BW_RATIOS[0])].best_acc()
    rows.append(row("fig3", "lora", "target_acc", target))
    for ratio in BW_RATIOS:
        base = results[("lora", ratio)].history
        base_sim = sim_time_to_target(base, target)
        base_t = posthoc_time_to_target(base, target, ratio)
        base_tc = posthoc_time_to_target(base, target, ratio, coded=True)
        for name in METHODS:
            hist = results[(name, ratio)].history
            setting = f"up1/{ratio}/{name}"
            t_sim = sim_time_to_target(hist, target)
            if t_sim is not None:
                rows.append(row("fig3", setting, "sim_time", t_sim))
            rows.append(rel_row("fig3", setting, "sim_rel_time",
                                t_sim, base_sim))
            rows.append(rel_row("fig3", setting, "rel_time",
                                posthoc_time_to_target(hist, target, ratio),
                                base_t))
            rows.append(rel_row("fig3", setting, "rel_time_coded",
                                posthoc_time_to_target(hist, target, ratio,
                                                       coded=True),
                                base_tc))
    return emit(rows, "Figure 3: time-to-accuracy under asymmetric bandwidth "
                      "(async engine)")


if __name__ == "__main__":
    main()
