"""FLASC under client-level DP (DP-FedAdam, paper §4.5) on the PyTorch port:
a noise sweep comparing full finetuning / LoRA / FLASC / FFA-LoRA, the
counterpart of `examples/private_flasc.py`.

  PYTHONPATH=src python examples/private_flasc_torch.py                # the card
  PYTHONPATH=src python examples/private_flasc_torch.py --device cpu   # the host

`main(rounds, sigmas, pretrain_steps=, device=)` shrinks the sweep (the
tests run 2 rounds); run as a script it keeps the reference example's
values: 30
rounds, sigma in (0, sigma_sim, 5 sigma_sim) with sigma_sim the noise
multiplier 0.58 of a simulated cohort of 1000 scaled to the 10 clients run
(paper Appx B.4), 100 pretraining steps.  Like every entry point of the
port it runs on the card unless `device` says otherwise.
"""
import argparse

from repro_torch.core.dp import simulated_noise_multiplier
from repro_torch.core.strategies import StrategySpec
from repro_torch.data.datasets import make_synth_reddit
from repro_torch.federated.api import Experiment
from repro_torch.models.config import FederatedConfig

MODEL = dict(d_model=48, num_layers=2, num_heads=4, d_ff=96)
METHODS = (   # (name, strategy, TrainOptions overrides)
    ("full-ft", StrategySpec(kind="lora"), dict(full_finetune=True)),
    ("lora r16", StrategySpec(kind="lora"), {}),
    ("flasc d=1/2", StrategySpec(kind="flasc", density_down=0.5,
                                 density_up=0.5), {}),
    ("ffa-lora", StrategySpec(kind="ffa"), {}))


def federation(sigma: float) -> FederatedConfig:
    """DP-FedAdam over 10 clients a round: clip 0.05, noise multiplier
    sigma."""
    return FederatedConfig(n_clients=10, local_batch=8, client_lr=5e-3,
                           server_lr=2e-2, dp_clip=0.05, dp_noise=sigma)


def default_sigmas():
    # paper Appx B.4: report epsilon at a simulated cohort of 1000, run 10
    sigma_sim = simulated_noise_multiplier(0.58, simulated_cohort=1000,
                                           actual_cohort=10)
    return (0.0, sigma_sim, 5 * sigma_sim)


def main(rounds: int = 30, sigmas=None, *, pretrain_steps: int = 100,
         device=None):
    """Runs the sweep; returns one row a (sigma, method): accuracy and the
    ledger's values and bytes."""
    task = make_synth_reddit(n_users=128, vocab=128, length=20)
    rows = []
    for sigma in (default_sigmas() if sigmas is None else sigmas):
        fed = federation(sigma)
        print(f"\n-- sigma={sigma:.4f} --")
        for name, spec, kw in METHODS:
            res = (Experiment(task, strategy=spec, federation=fed,
                              device=device)
                   .with_model(**MODEL)
                   .with_lora(rank=16)
                   .with_training(rounds=rounds, eval_every=rounds,
                                  pretrain_steps=pretrain_steps, **kw)
                   .run())
            led = res.ledger
            print(f"  {name:12s} acc={res.final_acc:.3f} "
                  f"comm={led.total_bytes / 1e6:6.2f}MB")
            rows.append({"sigma": sigma, "method": name,
                         "acc": res.final_acc, "total_bytes": led.total_bytes,
                         "up_coded_bytes": led.up_coded_bytes,
                         "down_coded_bytes": led.down_coded_bytes,
                         "up_values": led.up_values,
                         "down_values": led.down_values})
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    main(device=ap.parse_args().device)
