"""Pretraining sweep of ViT-B/16 on the paper-size image task, on the card:
which `pretrain` setting makes the backbone learn and still leaves the
federated rounds room to improve it.

  PYTHONPATH=src python -m benchmarks_torch.pretrain_sweep \
      [--dtypes bfloat16 float32] [--lrs 1e-3 3e-4 1e-4] \
      [--steps 25 100 300] [--rounds 10] [--min-acc 0.3] [--seed 0] \
      [--out pretrain_sweep.jsonl]

For each parameter dtype, lr and step count, a fresh ViT-B/16
(`common.paper_config` at that dtype) from the seed is pretrained by
`runtime.pretrain` at `common.PAPER_PRETRAIN`'s batch on
`common.get_task("synth_image", model="paper")`: ms a step (host clock,
synchronised; one untimed step first), the final loss and the
backbone's eval accuracy (`common.backbone_acc`).  Every setting at or
above `--min-acc` then runs Figure 2's dense `lora` method for
`--rounds` rounds (`common.default_fed`, eval every `common.EVAL_EVERY`)
from that backbone: its best accuracy against the pretrained one.  Only
knobs both packages have are swept: `pretrain`'s steps and lr, and the
config's `param_dtype`.

One JSON object a setting on stdout (also written to
chiprun_out/<--out>), then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time

import torch

from benchmarks_torch import common
from benchmarks_torch.fig2_comm_efficiency import METHODS
from repro_torch.federated import runtime as rt
from repro_torch.federated.api import Experiment
from repro_torch.models import model as mdl
from repro_torch.models.layers import init_params


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def pretrained(task, dtype: str, lr: float, steps: int, seed: int):
    """(params, cfg, final loss, ms a step) of one fresh pretraining run."""
    batch = common.PAPER_PRETRAIN["batch_size"]
    cfg = dataclasses.replace(common.paper_config(task), param_dtype=dtype)
    params = init_params(mdl.model_spec(cfg), seed, device="cuda")
    rt.pretrain(params, cfg, task, 1, lr=lr, batch_size=batch,
                seed=seed + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, loss = rt.pretrain(params, cfg, task, steps, lr=lr,
                               batch_size=batch, seed=seed)
    torch.cuda.synchronize()
    return params, cfg, loss, 1e3 * (time.perf_counter() - t0) / steps


def lora_run(task, params, cfg, rounds: int, seed: int):
    """Figure 2's dense `lora` from the given backbone, as `common.run`
    would run it."""
    return (Experiment(task, strategy=METHODS["lora"],
                       federation=common.default_fed())
            .with_lora(rank=16).with_params(params, cfg)
            .with_training(rounds=rounds, eval_every=common.EVAL_EVERY,
                           seed=seed)
            .run())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtypes", nargs="+", default=["bfloat16", "float32"])
    ap.add_argument("--lrs", nargs="+", type=float,
                    default=[1e-3, 3e-4, 1e-4])
    ap.add_argument("--steps", nargs="+", type=int, default=[25, 100, 300])
    ap.add_argument("--out", default="pretrain_sweep.jsonl",
                    help="file name under chiprun_out/")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--min-acc", type=float, default=0.3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("pretrain_sweep measures on the card; none is here")
    card = card_line()
    task = common.get_task("synth_image", seed=args.seed, model="paper")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", args.out), "w") as f:
        for dtype in args.dtypes:
            for lr in args.lrs:
                for steps in args.steps:
                    params, cfg, loss, ms = pretrained(
                        task, dtype, lr, steps, args.seed)
                    out = dict(dtype=dtype, lr=lr, steps=steps,
                               batch=common.PAPER_PRETRAIN["batch_size"],
                               loss=loss, ms_a_step=ms,
                               acc=common.backbone_acc(params, cfg, task))
                    if out["acc"] >= args.min_acc:
                        t0 = time.perf_counter()
                        res = lora_run(task, params, cfg, args.rounds,
                                       args.seed)
                        out.update(lora_rounds=args.rounds,
                                   lora_best_acc=res.best_acc(),
                                   lora_final_acc=res.final_acc,
                                   lora_accs=[h["acc"] for h in res.history
                                              if "acc" in h],
                                   lora_losses=[h["loss"]
                                                for h in res.history],
                                   lora_s=time.perf_counter() - t0)
                    out["card"] = card
                    line = json.dumps(out)
                    print(line, flush=True)
                    f.write(line + "\n")
                    del params
                    torch.cuda.empty_cache()
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
