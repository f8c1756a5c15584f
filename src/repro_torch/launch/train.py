"""Training launcher: federated LoRA finetuning of an architecture of the
registry, a thin CLI over `Experiment` and the engine registry.

Runs on the card by default, at the architecture's full width and depth,
with random backbone weights from --seed and a synthetic token stream
(the reference launcher's numpy stream, draw for draw):

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --rounds 2

--smoke trains the reduced config; --device cpu runs the plain PyTorch
versions on the host.  It prints the per-round loss every 5 rounds, then
the communication ledger: totals against dense, the coded wire bytes and
the per-client-per-round averages.

The port has no sharded engine: --engine is `sim` (the default) or
`async`; `--engine sharded`, --mesh and --fsdp raise (ROADMAP queue 1,
item 8), as do --dry-run and --multi-pod (item 9).  --rounds-per-call is
accepted and, as in the reference, read only by the sharded engine.
"""
from __future__ import annotations

import argparse
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--density", type=float, default=0.25)
    ap.add_argument("--strategy", default="flasc")
    ap.add_argument("--engine", default="sim",
                    help="registered engine backend (sim | async); the port "
                         "has no sharded engine yet (ROADMAP queue 1, "
                         "item 8)")
    ap.add_argument("--rounds-per-call", type=int, default=1,
                    help="scan-chunk k rounds into one device call (sharded "
                         "only)")
    ap.add_argument("--mesh", default=None, metavar="CxM",
                    help="2-D client x model mesh of the sharded engine "
                         "(not ported: ROADMAP queue 1, item 8)")
    ap.add_argument("--fsdp", action="store_true",
                    help="ZeRO-3 backbone sharding over the client axis "
                         "(not ported: ROADMAP queue 1, item 8)")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds param init and the synthetic data stream")
    ap.add_argument("--dry-run", action="store_true",
                    help="production lowering (not ported: ROADMAP queue 1, "
                         "item 9)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --dry-run (not ported: ROADMAP queue 1, "
                         "item 9)")
    ap.add_argument("--smoke", action="store_true",
                    help="train the architecture's reduced smoke config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def _refuse_unported(args: argparse.Namespace) -> None:
    if args.dry_run or args.multi_pod:
        raise NotImplementedError(
            "--dry-run / --multi-pod (the production lowering) are not "
            "ported yet (ROADMAP queue 1, item 9)")
    if args.mesh is not None or args.fsdp:
        raise NotImplementedError(
            "--mesh / --fsdp (the sharded engine) are not ported yet "
            "(ROADMAP queue 1, item 8)")


def batch_stream(cfg, fed, seed: int, seq: int = 32):
    """-> batch_for_round(r): the reference launcher's numpy draws (one
    `default_rng(seed)` advanced round by round), as numpy arrays."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def batch_for_round(r):
        b = {"tokens": rng.integers(
            0, cfg.vocab_size, (fed.n_clients, 1, fed.local_batch, seq)
        ).astype(np.int32)}
        if cfg.encoder_decoder:
            b["frames"] = rng.normal(
                0, .1, (fed.n_clients, 1, fed.local_batch, cfg.encoder_seq,
                        cfg.d_model)).astype(np.float32)
        if cfg.num_image_tokens:
            b["image_embeds"] = rng.normal(
                0, .1, (fed.n_clients, 1, fed.local_batch,
                        cfg.num_image_tokens, cfg.vision_embed_dim)
            ).astype(np.float32)
        return b
    return batch_for_round


def main(argv: Optional[List[str]] = None):
    args = parse_args(argv)
    _refuse_unported(args)

    import torch

    from repro_torch import resolve_device
    from repro_torch.configs.registry import get_config
    from repro_torch.federated.api import Experiment
    from repro_torch.models import model as mdl
    from repro_torch.models.config import FederatedConfig, LoRAConfig
    from repro_torch.models.layers import init_params

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    size = "reduced" if args.smoke else "full"
    print(f"[train] {args.arch} ({size}: {cfg.num_layers}L d{cfg.d_model}) "
          f"strategy={args.strategy} d={args.density} r={args.rank} "
          f"engine={args.engine}")
    params = init_params(mdl.model_spec(cfg), args.seed, device=device)
    fed = FederatedConfig(n_clients=args.clients, local_batch=4, local_steps=1,
                          client_lr=1e-3, server_lr=2e-3)
    draw = batch_stream(cfg, fed, args.seed)

    def batch_for_round(r):
        return {k: torch.from_numpy(v).to(device)
                for k, v in draw(r).items()}

    exp = (Experiment(None, federation=fed, device=device)
           .with_strategy(args.strategy, density_down=args.density,
                          density_up=args.density)
           .with_lora(config=LoRAConfig(rank=args.rank))
           .with_training(rounds=args.rounds, eval_every=0, log_every=5,
                          pretrain_steps=0, train_head=False, verbose=True)
           .with_params(params, cfg)
           .with_data(batch_for_round)
           .with_engine(args.engine))
    res = exp.run()

    led = res.ledger
    n, r = fed.n_clients, max(led.rounds, 1)
    dense = max(led.dense_equivalent_bytes(n), 1)
    print(f"[train] done after {led.rounds} rounds; "
          f"final loss={res.history[-1]['loss']:.4f}")
    print(f"[train] traffic: total {led.total_bytes/1e6:.2f}MB "
          f"({led.total_bytes/dense:.2%} of dense) | "
          f"coded wire format {led.total_coded_bytes/1e6:.2f}MB "
          f"(down {led.down_coded_bytes/1e6:.2f} / up "
          f"{led.up_coded_bytes/1e6:.2f})")
    print(f"[train] per client per round: "
          f"down {led.down_bytes/(r*n)/1e3:.1f}kB "
          f"({led.down_values/(r*n):.0f} values), "
          f"up {led.up_bytes/(r*n)/1e3:.1f}kB "
          f"({led.up_values/(r*n):.0f} values)")
    return res


if __name__ == "__main__":
    main()
