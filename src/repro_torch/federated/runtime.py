"""Federated finetuning runtime helpers: task-model construction, central
pretraining and evaluation, shared by the `Experiment` builder
(`federated/api.py`) and the examples.  The port of
`src/repro/federated/runtime.py`.

Flow (the paper's setup):
  1. build a backbone for the task (a ViT-style encoder classifier for the
     image tasks, a GPT-style model for the text tasks),
  2. pretrain it centrally on pooled data for a few steps (the paper's
     premise of a good frozen initialization),
  3. inject LoRA, freeze the backbone,
  4. run R federated rounds under a registered strategy, tracking the
     communication ledger and eval accuracy.

Everything runs on the device of the params it is given; task arrays
(numpy) are moved there once per call.  `pretrain` and `evaluate` pull
to the host only what the reference pulls: the final loss, and each eval
batch's correct count.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import comm as comm_mod
from repro_torch.core import fedround
from repro_torch.core import strategies as st
from repro_torch.data.datasets import FederatedTask
from repro_torch.data.pipeline import eval_batches
from repro_torch.models import model as mdl
from repro_torch.models.config import FederatedConfig, ModelConfig
from repro_torch.models.layers import tree_leaves
from repro_torch.optim import adam_init, adam_update


def model_for_task(task: FederatedTask, *, d_model=64, num_layers=2,
                   num_heads=4, d_ff=128, vocab=256) -> ModelConfig:
    if task.kind == "embeds_cls":
        return ModelConfig(name=f"vit-{task.name}", family="dense",
                           num_layers=num_layers, d_model=d_model,
                           num_heads=num_heads, num_kv_heads=num_heads,
                           d_ff=d_ff, vocab_size=vocab, activation="gelu",
                           num_classes=task.n_classes, embed_inputs=True,
                           use_learned_pos=True, max_seq=64,
                           param_dtype="float32", compute_dtype="float32")
    if task.kind == "tokens_cls":
        return ModelConfig(name=f"gpt-{task.name}", family="dense",
                           num_layers=num_layers, d_model=d_model,
                           num_heads=num_heads, num_kv_heads=num_heads,
                           d_ff=d_ff, vocab_size=vocab, activation="gelu",
                           num_classes=task.n_classes, use_learned_pos=True,
                           max_seq=256, param_dtype="float32",
                           compute_dtype="float32")
    return ModelConfig(name=f"gpt-{task.name}", family="dense",
                       num_layers=num_layers, d_model=d_model,
                       num_heads=num_heads, num_kv_heads=num_heads,
                       d_ff=d_ff, vocab_size=vocab, activation="gelu",
                       use_learned_pos=True, max_seq=256,
                       param_dtype="float32", compute_dtype="float32")


def _task_batch(cfg: ModelConfig, batch: Dict[str, Any]) -> Dict[str, Any]:
    """Adapt task arrays to the model input dict: every task kind's arrays
    ('embeds' or 'tokens', and 'labels') are what `forward` reads."""
    return dict(batch)


def task_loss(params, cfg: ModelConfig, batch) -> torch.Tensor:
    return mdl.loss_fn(params, cfg, _task_batch(cfg, batch))


def _device_of(params) -> torch.device:
    return next(tree_leaves(params)).device


def _to_device(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


def _with_leaves(tree, leaves):
    """`tree` with its leaves (sorted-key order) replaced by `leaves`."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return next(it)
    return walk(tree)


def pretrain(params, cfg: ModelConfig, task: FederatedTask, steps: int = 100,
             lr: float = 1e-3, batch_size: int = 64,
             seed: int = 0) -> Tuple[Any, Optional[float]]:
    """Brief centralized Adam pretraining on pooled data, every backbone
    leaf trained.  Always returns `(params, loss)`: the last step's loss,
    or None when `steps <= 0` (then `params` come back as given).  The
    reference returns bare params in that case.

    The batch indices are the reference's numpy stream (one
    `rng.integers(0, n, batch_size)` a step, drawn up front); the pooled
    data is moved to the params' device once, so the loop issues one
    forward and backward a step and syncs with the host only for the
    final loss."""
    if steps <= 0:
        return params, None
    device = _device_of(params)
    rng = np.random.default_rng(seed)
    n = len(next(iter(task.data.values())))
    idx = np.stack([rng.integers(0, n, batch_size) for _ in range(steps)])
    idx = torch.from_numpy(idx).to(device)
    data = _to_device(task.data, device)
    opt = adam_init(params)
    loss = None
    for s in range(steps):
        batch = {k: v[idx[s]] for k, v in data.items()}
        params = _with_leaves(params, [p.detach().requires_grad_(True)
                                       for p in tree_leaves(params)])
        loss = task_loss(params, cfg, batch)
        grads = torch.autograd.grad(loss, list(tree_leaves(params)))
        with torch.no_grad():
            params, opt = adam_update(params, _with_leaves(params, grads),
                                      opt, lr)
    return params, float(loss.detach())


def eval_logits(params, cfg: ModelConfig, meta: fedround.FlatMeta,
                lora_scale: float, flatP, batch) -> torch.Tensor:
    """The eval forward's logits for one batch (tensors on the params'
    device): the backbone with the head of `flatP` taken in, and its LoRA
    tree applied; under full finetuning the backbone of `flatP` itself
    (the reference evaluates `params` there, the pretrained backbone)."""
    tree = meta.unflatten(flatP)
    lora_tree = tree.get("lora", tree)
    p = dict(tree["backbone"] if "backbone" in tree else params)
    if "head" in tree:
        p.update(tree["head"])
    return mdl.forward(p, cfg, batch, lora=lora_tree,
                       lora_scale=lora_scale)["logits"]


@torch.no_grad()
def evaluate(params, cfg: ModelConfig, trainable, meta: fedround.FlatMeta,
             task: FederatedTask, lora_scale: float, flatP) -> float:
    """Classification accuracy, or next-token accuracy for LM tasks, over
    `eval_batches(task)`; one count pulled to the host a batch."""
    device = flatP.device
    correct = total = 0
    for batch in eval_batches(task):
        tb = _to_device(batch, device)
        lg = eval_logits(params, cfg, meta, lora_scale, flatP, tb)
        if cfg.num_classes > 0:
            pred = torch.argmax(lg, -1)
            correct += int(torch.sum(pred == tb["labels"]))
            total += pred.numel()
        else:
            pred = torch.argmax(lg[..., :-1, :], -1)
            gold = tb["tokens"][..., 1:]
            correct += int(torch.sum(pred == gold))
            total += gold.numel()
    return correct / max(total, 1)


@dataclasses.dataclass
class ExperimentResult:
    history: List[Dict[str, Any]]
    ledger: comm_mod.CommLedger
    final_acc: float

    def best_acc(self) -> float:
        return max((h["acc"] for h in self.history if "acc" in h), default=0.0)

    def comm_to_acc(self, target: float) -> Optional[int]:
        """Total bytes when target accuracy was first reached (None if
        never)."""
        for h in self.history:
            if h.get("acc", 0.0) >= target:
                return int(h["total_bytes"])
        return None


def run_experiment(task: FederatedTask, *, spec: st.StrategyLike,
                   fed: FederatedConfig, rounds: int, lora_rank: int = 16,
                   lora_alpha: float = 32.0, model_kw: Optional[dict] = None,
                   pretrain_steps: int = 100, train_head: bool = True,
                   eval_every: int = 10, seed: int = 0,
                   full_finetune: bool = False, params_and_cfg=None,
                   verbose: bool = False,
                   device=None) -> ExperimentResult:
    """Legacy entry point: thin shim over `federated.api.Experiment`."""
    from repro_torch.federated.api import Experiment, TrainOptions

    exp = (Experiment(task, strategy=spec, federation=fed, device=device)
           .with_model(**(model_kw or {}))
           .with_lora(rank=lora_rank, alpha=lora_alpha)
           .with_training(TrainOptions(
               rounds=rounds, pretrain_steps=pretrain_steps,
               train_head=train_head, eval_every=eval_every, seed=seed,
               full_finetune=full_finetune, verbose=verbose)))
    if params_and_cfg is not None:
        exp.with_params(*params_and_cfg)
    return exp.run()
