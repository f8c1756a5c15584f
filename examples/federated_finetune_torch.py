"""End-to-end federated finetuning on the PyTorch port, with checkpoints.

  PYTHONPATH=src python examples/federated_finetune_torch.py --preset tiny
  PYTHONPATH=src python examples/federated_finetune_torch.py --preset paper \
      --rounds 200        # GPT-2 Small-scale backbone (124M parameters)

  # continue an interrupted run from its latest snapshot:
  PYTHONPATH=src python examples/federated_finetune_torch.py \
      --resume checkpoints/flasc_torch

The port of `examples/federated_finetune.py`: the paper's text setup
(GPT-2-style backbone, LoRA rank 16, FedAdam, 10 clients a round) on the
Reddit-style next-token task; `tiny` runs the same pipeline at CPU scale.
`--ckpt-every` snapshots the run through the engine's CheckpointCallback
(the reference's snapshot format: either package resumes it).  Runs on
the card unless `--device cpu`; `--engine` is `sim` or `async`.
"""
import argparse

from repro_torch.data.datasets import make_synth_reddit
from repro_torch.federated.api import Experiment
from repro_torch.models.config import FederatedConfig

PRESETS = {
    "tiny": dict(model_kw=dict(d_model=48, num_layers=2, num_heads=4, d_ff=96),
                 vocab=128, rounds=40),
    "small": dict(model_kw=dict(d_model=256, num_layers=4, num_heads=8,
                                d_ff=1024),
                  vocab=1024, rounds=100),
    # paper scale: GPT-2 Small's shape (12 x 768, 12 heads, 3072, 50k vocab)
    "paper": dict(model_kw=dict(d_model=768, num_layers=12, num_heads=12,
                                d_ff=3072, vocab=50257),
                  vocab=50257, rounds=200),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=PRESETS, default="tiny")
    ap.add_argument("--rounds", type=int, default=0)
    ap.add_argument("--density", type=float, default=0.25)
    ap.add_argument("--up-density", type=float, default=0.0)
    ap.add_argument("--rank", type=int, default=16)
    ap.add_argument("--engine", default=None,
                    help="sim | async (resume keeps the saved engine "
                         "unless overridden)")
    ap.add_argument("--ckpt", default="checkpoints/flasc_torch")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", default="",
                    help="checkpoint dir to continue from (ignores presets)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    if args.resume:
        exp = Experiment.resume(args.resume, device=args.device)
        args.ckpt = args.resume
        if args.rounds:
            exp.with_training(rounds=args.rounds)
    else:
        p = PRESETS[args.preset]
        task = make_synth_reddit(n_users=256, vocab=min(p["vocab"], 4096),
                                 length=24)
        fed = FederatedConfig(n_clients=10, local_batch=8, local_steps=1,
                              client_lr=5e-4, server_lr=1e-3)
        exp = (Experiment(task, federation=fed, device=args.device)
               .with_strategy("flasc", density_down=args.density,
                              density_up=args.up_density or args.density)
               .with_model(**p["model_kw"])
               .with_lora(rank=args.rank)
               .with_training(rounds=args.rounds or p["rounds"],
                              eval_every=10, verbose=True)
               .with_checkpoint(args.ckpt, every=args.ckpt_every))
    if args.engine:
        exp.with_engine(args.engine)
    res = exp.run()
    print(f"final token-acc {res.final_acc:.4f}; "
          f"comm {res.ledger.total_bytes/1e6:.1f}MB "
          f"(coded wire {res.ledger.total_coded_bytes/1e6:.1f}MB, "
          f"dense-equivalent {res.ledger.dense_equivalent_bytes(10)/1e6:.1f}MB); "
          f"checkpoints -> {args.ckpt}")
    return res


if __name__ == "__main__":
    main()
