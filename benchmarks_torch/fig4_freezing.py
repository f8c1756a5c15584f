"""Figure 4: sparsity WITHOUT freezing (FLASC) vs client freezing
(Federated Select) vs server+client freezing (SparseAdapter), across
densities.  The port of `benchmarks/fig4_freezing.py`.

Paper claim: FLASC >> SparseAdapter > FedSelect; dense local updates can be
sparsified far beyond what sparse finetuning tolerates."""
from __future__ import annotations

from benchmarks_torch.common import emit, get_task, row, run
from repro_torch.core.strategies import StrategySpec

DENSITIES = (1.0, 0.25, 1 / 16, 1 / 64)


def main(device=None):
    task = get_task("synth_image")
    rows = []
    # random frozen backbone + frozen head: adapters carry all learning,
    # isolating the freezing-vs-communication-sparsity mechanism (a backbone
    # pretrained on the same distribution saturates every method)
    for d in DENSITIES:
        for kind in ("flasc", "fedselect", "sparse_adapter"):
            spec = StrategySpec(kind=kind, density_down=d, density_up=d)
            res = run(task, spec, train_head=False, pretrain_steps=0,
                      device=device)
            rows.append(row("fig4", f"{kind}/d{d:.4f}", "best_acc", res.best_acc()))
    return emit(rows, "Figure 4: sparsity without freezing (head frozen)")


if __name__ == "__main__":
    main()
