"""Quickstart on the PyTorch port: one dense-LoRA run and one FLASC run on
a synthetic task, the counterpart of `examples/quickstart.py`.

  PYTHONPATH=src python examples/quickstart_torch.py                # the card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu   # the host

QUICK=1 shrinks the task, model and rounds to the reference quickstart's
seconds-long smoke sizes.  Like every entry point of the port it runs on
the card unless `--device` says otherwise.
"""
import argparse
import os

from repro_torch.core.strategies import StrategySpec
from repro_torch.data.datasets import make_synth_image
from repro_torch.federated.runtime import run_experiment
from repro_torch.models.config import FederatedConfig

QUICK = os.environ.get("QUICK", "0") == "1"

MODEL_KW = (dict(d_model=16, num_layers=1, num_heads=2, d_ff=32) if QUICK
            else dict(d_model=48, num_layers=2, num_heads=4, d_ff=96))
ROUNDS = 4 if QUICK else 30
PRETRAIN = 5 if QUICK else 100
EVAL_EVERY = 2 if QUICK else 10


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if QUICK:
        task = make_synth_image(n_examples=256, n_clients=8, n_patches=4,
                                dim=16)
    else:
        task = make_synth_image(n_examples=1024, n_clients=48, n_patches=8,
                                dim=48)
    fed = FederatedConfig(n_clients=8, local_batch=8, local_steps=1,
                          client_lr=5e-3, server_lr=5e-3)
    common = dict(fed=fed, rounds=ROUNDS, lora_rank=16,
                  eval_every=EVAL_EVERY, pretrain_steps=PRETRAIN,
                  model_kw=MODEL_KW, verbose=True, device=args.device)
    print("== dense LoRA baseline ==")
    dense = run_experiment(task, spec=StrategySpec(kind="lora"), **common)
    print("== FLASC (d_down = d_up = 1/4) ==")
    flasc = run_experiment(task, spec=StrategySpec(kind="flasc",
                                                   density_down=0.25,
                                                   density_up=0.25),
                           **common)
    saving = dense.ledger.total_bytes / max(flasc.ledger.total_bytes, 1)
    print(f"\nLoRA   : acc={dense.best_acc():.3f} "
          f"comm={dense.ledger.total_bytes / 1e6:.2f}MB")
    print(f"FLASC  : acc={flasc.best_acc():.3f} "
          f"comm={flasc.ledger.total_bytes / 1e6:.2f}MB")
    print(f"FLASC matches LoRA with {saving:.1f}x less communication")


if __name__ == "__main__":
    main()
