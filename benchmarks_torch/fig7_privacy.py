"""Figures 7/8: DP-FedAdam (`repro_torch/core/dp.py`) — full finetuning vs
LoRA vs FLASC vs FFA-LoRA under increasing noise, plus the rank sweep at
~50% communication.  The port of `benchmarks/fig7_privacy.py`.

Paper claim: LoRA-family >> full FT under DP; FFA-LoRA (freezing A) does
not beat LoRA/FLASC; FLASC halves communication at equal-or-better
accuracy."""
from __future__ import annotations

from benchmarks_torch.common import default_fed, emit, get_task, row, run
from repro_torch.core.strategies import StrategySpec

SIGMAS = (0.0, 0.02, 0.1)
CLIP = 0.05


def main(device=None):
    task = get_task("synth_reddit")
    rows = []
    for sigma in SIGMAS:
        fed = default_fed(dp_clip=CLIP, dp_noise=sigma, server_lr=2e-2)
        cfgs = [
            ("full_ft", dict(spec=StrategySpec(kind="lora"), full_finetune=True)),
            ("lora_r16", dict(spec=StrategySpec(kind="lora"))),
            ("flasc_d1/2", dict(spec=StrategySpec(kind="flasc", density_down=0.5,
                                                  density_up=0.5))),
            ("ffa", dict(spec=StrategySpec(kind="ffa"))),
        ]
        for name, kw in cfgs:
            res = run(task, fed=fed, device=device, **kw)
            rows.append(row("fig7", f"sigma{sigma}/{name}", "best_acc",
                            res.best_acc()))
    # fig8-style rank sweep under DP at 50% communication
    fed = default_fed(dp_clip=CLIP, dp_noise=SIGMAS[1], server_lr=2e-2)
    for r in (4, 16, 64):
        res = run(task, StrategySpec(kind="flasc", density_down=0.5,
                                     density_up=0.5), fed=fed, lora_rank=r,
                  device=device)
        rows.append(row("fig8", f"rank{r}/flasc_d1/2", "best_acc", res.best_acc()))
    return emit(rows, "Figures 7/8: differential privacy")


if __name__ == "__main__":
    main()
