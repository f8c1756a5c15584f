"""Figure 2: utility vs total communication for LoRA / FLASC /
SparseAdapter / Adapter-LTH — plus the two named communication-efficiency
baselines (docs/baselines.md): FLoCoRA low-rank message compression and
the two-stage sparsified-orthogonal-update schedule — on an image and a
text federated task.  The port of `benchmarks/fig2_comm_efficiency.py`.

Paper claim: FLASC matches dense LoRA at 3-10x less communication;
SparseAdapter fails to match; Adapter-LTH saves little early and degrades
late.

  PYTHONPATH=src python -m benchmarks_torch.fig2_comm_efficiency
  BENCH_MODEL=paper PYTHONPATH=src python -m benchmarks_torch.fig2_comm_efficiency
"""
from __future__ import annotations

from benchmarks_torch.common import emit, get_task, row, run
from repro_torch.core.strategies import StrategySpec

METHODS = {
    "lora": StrategySpec(kind="lora"),
    "flasc_d1/4": StrategySpec(kind="flasc", density_down=0.25, density_up=0.25),
    # beyond-paper: Top-K composed with 8-bit stochastic quantization
    "flasc_d1/4_q8": StrategySpec(kind="flasc", density_down=0.25,
                                  density_up=0.25, quant_bits_down=8,
                                  quant_bits_up=8),
    "flasc_d1/16": StrategySpec(kind="flasc", density_down=1 / 16, density_up=1 / 16),
    "sparse_adapter_d1/4": StrategySpec(kind="sparse_adapter", density_down=0.25),
    "adapter_lth_.98": StrategySpec(kind="adapter_lth", lth_prune_every=1,
                                    lth_keep=0.98),
    # baselines (docs/baselines.md): low-rank message compression in both
    # directions, and the alternating A/B schedule with Top-K uploads
    "flocora_r8": StrategySpec(kind="flocora"),
    "two_stage_ortho_d1/4": StrategySpec(kind="two_stage_ortho",
                                         density_up=0.25),
}


def result_rows(key: str, res):
    """The figure's six rows of one run."""
    rows = [row("fig2", key, "best_acc", res.best_acc()),
            row("fig2", key, "final_acc", res.final_acc),
            row("fig2", key, "total_MB", res.ledger.total_bytes / 1e6),
            # practical wire format: values + min(index, bitmap) coding
            row("fig2", key, "coded_MB", res.ledger.total_coded_bytes / 1e6)]
    dense = res.ledger.dense_equivalent_bytes(8)
    rows.append(row("fig2", key, "comm_vs_dense",
                    res.ledger.total_bytes / max(dense, 1)))
    rows.append(row("fig2", key, "coded_vs_dense",
                    res.ledger.total_coded_bytes / max(dense, 1)))
    return rows


def main(tasks=("synth_image", "synth_text"), device=None):
    rows = []
    for tname in tasks:
        task = get_task(tname)
        for mname, spec in METHODS.items():
            res = run(task, spec, device=device)
            rows += result_rows(f"{tname}/{mname}", res)
    return emit(rows, "Figure 2: utility vs communication")


if __name__ == "__main__":
    main()
