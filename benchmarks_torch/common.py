"""Shared helpers for the paper-figure harnesses on the port.

Every harness prints CSV rows `figure,setting,metric,value` (plus a header
line) and returns the rows so benchmarks_torch/run.py can aggregate them.
The names, rows and environment switches are those of
`benchmarks/common.py`:

  BENCH_QUICK=0        full mode (120 rounds, eval every 10), else quick
                       (30 rounds, eval every 5);
  BENCH_ENGINE=<name>  route every run through that registered engine
                       ("sim" by default, "async"); "sharded" and
                       "sharded:<k>" raise, as the port has no sharded
                       engine yet;
  BENCH_MODEL=paper    the paper's backbones instead of the tiny
                       `MODEL_KW`: ViT-B/16 (`configs/paper_models.py`) on
                       a 196-patch x 768 image task for the image figures,
                       GPT-2 Small's layer shape (12 x 768, 12 heads, d_ff
                       3072) with the task's head for the text figures,
                       pretrained at `PAPER_PRETRAIN`.

Runs go to the card unless the caller passes `device="cpu"`.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Dict, List, Optional

from repro_torch.configs.paper_models import VIT_B16
from repro_torch.core.fedround import FlatMeta
from repro_torch.core.strategies import StrategyLike
from repro_torch.data import datasets as ds
from repro_torch.federated import runtime as rt
from repro_torch.federated.api import Experiment
from repro_torch.federated.engine import resolve_engine
from repro_torch.models import model as mdl
from repro_torch.models.config import FederatedConfig, ModelConfig
from repro_torch.models.layers import init_params

QUICK = os.environ.get("BENCH_QUICK", "1") != "0"
ENGINE = os.environ.get("BENCH_ENGINE", "sim")
MODEL = os.environ.get("BENCH_MODEL", "tiny")
if MODEL not in ("tiny", "paper"):
    raise ValueError(f"BENCH_MODEL={MODEL!r}; known: 'tiny', 'paper'")

# tiny model shared across figures (the reference's; the paper's sizes
# are BENCH_MODEL=paper)
MODEL_KW = dict(d_model=48, num_layers=2, num_heads=4, d_ff=96)
# ViT-B/16's and GPT-2 Small's layer shape
PAPER_KW = dict(d_model=768, num_layers=12, num_heads=12, d_ff=3072)
# central pretraining of the paper-size backbones: the setting under which
# ViT-B/16 learns the 196-patch image task on the card (accuracy 0.51 at
# seed 0) and dense LoRA still gains over the rounds (PERF.md, PR 22,
# measured by benchmarks_torch/pretrain_sweep.py)
PAPER_PRETRAIN = dict(steps=20, lr=1e-4, batch_size=64,
                      param_dtype="bfloat16")
ROUNDS = 30 if QUICK else 120
EVAL_EVERY = 5 if QUICK else 10


@functools.lru_cache(maxsize=None)
def get_task(name: str, alpha: float = 0.1, seed: int = 0,
             model: Optional[str] = None):
    """The reference's task sizes; with `model` (default `BENCH_MODEL`)
    "paper", synth_image is the 196-patch x 768 task of ViT-B/16 (a 224-px
    image at patch 16), the others keep their sizes."""
    if name == "synth_image":
        if (model or MODEL) == "paper":
            return ds.make_synth_image(n_examples=1024, n_clients=32,
                                       n_patches=196, dim=768, alpha=alpha,
                                       seed=seed, n_eval=256)
        return ds.make_synth_image(n_examples=1024, n_clients=48, n_patches=8,
                                   dim=48, alpha=alpha, seed=seed)
    if name == "synth_text":
        return ds.make_synth_text(n_examples=768, n_clients=48, vocab=128,
                                  length=24, alpha=alpha, seed=seed)
    if name == "synth_reddit":
        return ds.make_synth_reddit(n_users=96, vocab=128, length=20, seed=seed)
    if name == "synth_flair":
        return ds.make_synth_flair(n_users=96, n_patches=8, dim=48, seed=seed)
    raise KeyError(name)


def default_fed(**kw) -> FederatedConfig:
    base = dict(n_clients=8, local_batch=8, local_steps=1,
                client_lr=5e-3, client_momentum=0.9, server_lr=5e-3)
    base.update(kw)
    return FederatedConfig(**base)


def _engine_for(engine):
    """'sim' | 'async' | 'sharded' | 'sharded:<rounds_per_call>' | an
    Engine instance -> Engine.  The sharded engine is not ported: its
    names raise the registry's NotImplementedError (ROADMAP queue 1,
    item 8)."""
    if not isinstance(engine, str):
        return resolve_engine(engine)       # instance passes through
    if ":" in engine:
        name, k = engine.split(":", 1)
        try:
            return resolve_engine(name, rounds_per_call=int(k))
        except TypeError:
            raise ValueError(
                f"engine {name!r} does not support a rounds_per_call chunk "
                f"(BENCH_ENGINE={name}:{k}); only 'sharded' scans rounds"
            ) from None
    return resolve_engine(engine)


def paper_config(task) -> ModelConfig:
    """The paper's backbone for `task`: ViT-B/16 for the image tasks, at
    `PAPER_PRETRAIN`'s parameter dtype; GPT-2 Small's layer shape with the
    task's head for the text tasks (the task model's f32)."""
    if task.kind == "embeds_cls":
        return dataclasses.replace(
            VIT_B16, num_classes=task.n_classes,
            param_dtype=PAPER_PRETRAIN["param_dtype"])
    return rt.model_for_task(task, **PAPER_KW)


# pretrained (params, cfg) per backbone identity — figure harnesses sweep
# strategies over the SAME task/model/seed, so pretraining once per
# combination instead of once per run cuts harness wall-clock.  Keyed on the
# task object id; the task itself is stored in the entry, which keeps it
# alive and so guarantees the id is never reused by a different task.
_BACKBONES: Dict[tuple, tuple] = {}


def pretrained_backbone(task, model_kw: dict, pretrain_steps: int, seed: int,
                        device=None):
    """(params, cfg): the tiny task model through `Experiment.build_backbone`
    (Adam at lr 1e-3, batch 64), or at `PAPER_KW` the paper's backbone
    (`paper_config`) from `init_params`, pretrained at `PAPER_PRETRAIN`'s lr
    and batch."""
    key = (id(task), tuple(sorted(model_kw.items())), pretrain_steps, seed,
           str(device))
    if key not in _BACKBONES:
        if model_kw == PAPER_KW:
            cfg = paper_config(task)
            params = init_params(mdl.model_spec(cfg), seed, device=device)
            params, _ = rt.pretrain(
                params, cfg, task, pretrain_steps, lr=PAPER_PRETRAIN["lr"],
                batch_size=PAPER_PRETRAIN["batch_size"], seed=seed)
            backbone = (params, cfg)
        else:
            exp = (Experiment(task, device=device)
                   .with_model(**model_kw)
                   .with_training(pretrain_steps=pretrain_steps, seed=seed))
            backbone = exp.build_backbone()
        _BACKBONES[key] = (task, backbone)
    return _BACKBONES[key][1]


def backbone_acc(params, cfg: ModelConfig, task) -> float:
    """`runtime.evaluate` of the backbone alone (no LoRA, its own head)."""
    tree = {"lora": {}, "head": {"final_norm": params["final_norm"]}}
    meta = FlatMeta.of(tree)
    return rt.evaluate(params, cfg, tree, meta, task, 1.0, meta.flatten(tree))


def run(task, spec: StrategyLike, fed: Optional[FederatedConfig] = None,
        rounds: int = None, lora_rank: int = 16, seed: int = 0,
        model_kw: Optional[dict] = None, pretrain_steps: Optional[int] = None,
        full_finetune: bool = False, engine=None, device=None, **train_kw):
    """One experiment run on `device` (default: the card).  `engine` is a
    registry name ('sim', 'async') or an Engine instance (e.g. an
    AsyncEngine with a custom ClientSystemProfile); None defers to
    $BENCH_ENGINE.  `model_kw` defaults to `BENCH_MODEL`'s backbone."""
    t0 = time.time()
    model_kw = model_kw or (PAPER_KW if MODEL == "paper" else MODEL_KW)
    if pretrain_steps is None:
        pretrain_steps = (PAPER_PRETRAIN["steps"] if model_kw == PAPER_KW
                          else 40 if QUICK else 150)
    params, cfg = pretrained_backbone(task, model_kw, pretrain_steps, seed,
                                      device)
    exp = (Experiment(task, strategy=spec, federation=fed or default_fed(),
                      device=device)
           .with_model(**model_kw)
           .with_lora(rank=lora_rank)
           .with_params(params, cfg)
           .with_engine(_engine_for(engine or ENGINE))
           .with_training(
               rounds=rounds or ROUNDS, eval_every=EVAL_EVERY, seed=seed,
               pretrain_steps=pretrain_steps,
               full_finetune=full_finetune, **train_kw))
    res = exp.run()
    res.elapsed = time.time() - t0
    return res


def emit(rows: List[Dict], header: str):
    print(f"\n== {header} ==", flush=True)
    for r in rows:
        print(",".join(str(r[k]) for k in ("figure", "setting", "metric", "value")),
              flush=True)
    return rows


def row(figure, setting, metric, value):
    return {"figure": figure, "setting": setting, "metric": metric,
            "value": round(value, 6) if isinstance(value, float) else value}
