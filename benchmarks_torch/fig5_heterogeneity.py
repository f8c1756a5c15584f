"""Figure 5: label heterogeneity (Dirichlet alpha) x {full finetuning,
LoRA rank sweep, FLASC sparsity} at matched communication.  The port of
`benchmarks/fig5_heterogeneity.py`.

Paper claim: rank tuning matters under heterogeneity; FLASC r=16 sparse
beats LoRA r=4 dense at equal communication."""
from __future__ import annotations

from benchmarks_torch.common import emit, get_task, row, run
from repro_torch.core.strategies import StrategySpec

ALPHAS = (100.0, 1.0, 0.01)


def main(device=None):
    rows = []
    for alpha in ALPHAS:
        task = get_task("synth_text", alpha=alpha)
        cfgs = [
            ("full_ft", dict(spec=StrategySpec(kind="lora"), full_finetune=True)),
            ("lora_r16", dict(spec=StrategySpec(kind="lora"), lora_rank=16)),
            ("lora_r4", dict(spec=StrategySpec(kind="lora"), lora_rank=4)),
            ("flasc_r16_d1/4", dict(spec=StrategySpec(kind="flasc",
                                                      density_down=0.25,
                                                      density_up=0.25),
                                    lora_rank=16)),
            ("flasc_r16_d1/16", dict(spec=StrategySpec(kind="flasc",
                                                       density_down=1 / 16,
                                                       density_up=1 / 16),
                                     lora_rank=16)),
        ]
        for name, kw in cfgs:
            res = run(task, device=device, **kw)
            rows.append(row("fig5", f"alpha{alpha}/{name}", "best_acc", res.best_acc()))
            rows.append(row("fig5", f"alpha{alpha}/{name}", "total_MB",
                            res.ledger.total_bytes / 1e6))
    return emit(rows, "Figure 5: label heterogeneity")


if __name__ == "__main__":
    main()
