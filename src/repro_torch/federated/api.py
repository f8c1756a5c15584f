"""Typed experiment builder for federated LoRA finetuning: the port of
`src/repro/federated/api.py`.

    result = (Experiment(task)
              .with_strategy("flasc", density_down=0.25, density_up=0.25)
              .with_federation(n_clients=8, local_batch=8, client_lr=5e-3)
              .with_model(d_model=48, num_layers=2, num_heads=4, d_ff=96)
              .with_lora(rank=16)
              .with_training(rounds=30, eval_every=10)
              .run())

A `FederatedTask` (`repro_torch.data`) drives the paper's path: the
task's backbone from `ModelOptions` (`runtime.model_for_task`), initialized
from the training seed and pretrained centrally (`runtime.pretrain`), or
given with `with_params`; LoRA on it, plus the classifier head and final
norm when `train_head`; client batches from `data.sample_round`; and
`runtime.evaluate` on the `eval_every` cadence.  The task-less path of
`launch/train.py` in the reference takes `Experiment(None)` with the
backbone from `with_params` and client batches from `with_data`.

`run()` returns `ExperimentResult(history, ledger, final_acc)`.  Like every
entry point of the port it runs on the card unless `device` says
otherwise; a backbone or batches handed in must already lie on that
device.

`TrainOptions(full_finetune=True)` trains every backbone leaf instead of
LoRA: the flat vector is the whole backbone (`{"lora": {}, "head": {},
"backbone": params}`, LoRA scale 1.0), under any strategy, and evaluation
runs the trained backbone (the reference evaluates the pretrained one,
ROADMAP queue 3 item 5(d)).

Not ported yet, and raising `NotImplementedError`: checkpoint/resume
(ROADMAP queue 1, item 3), client populations (item 4) and a device mesh
(item 8).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from repro_torch import DeviceLike, resolve_device
from repro_torch.core import comm as comm_mod
from repro_torch.core import fedround
from repro_torch.core import strategies as st
from repro_torch.core import transport as tp
from repro_torch.data.datasets import FederatedTask
from repro_torch.data.pipeline import sample_round
from repro_torch.federated import engine as eng
from repro_torch.federated import runtime as rt
from repro_torch.models import lora as lora_mod
from repro_torch.models import model as mdl
from repro_torch.models.config import FederatedConfig, LoRAConfig
from repro_torch.models.layers import init_params


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    """Backbone shape for the task model (see `runtime.model_for_task`)."""
    d_model: int = 64
    num_layers: int = 2
    num_heads: int = 4
    d_ff: int = 128
    vocab: int = 256

    def kwargs(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    """Everything about the training loop that is not the model, the
    federation geometry or the strategy (the reference's fields)."""
    rounds: int = 30
    pretrain_steps: int = 100
    train_head: bool = True
    eval_every: int = 10
    log_every: int = 0
    seed: int = 0
    full_finetune: bool = False
    verbose: bool = False


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1, "
                               f"{item})")


class Experiment:
    """Builder for one federated finetuning experiment.  Each `with_*`
    replaces one facet and returns the builder."""

    def __init__(self, task: Optional[FederatedTask] = None, *,
                 strategy: st.StrategyLike = "flasc",
                 federation: Optional[FederatedConfig] = None,
                 model: Optional[ModelOptions] = None,
                 lora: Optional[LoRAConfig] = None,
                 train: Optional[TrainOptions] = None,
                 engine: eng.EngineLike = "sim",
                 device: DeviceLike = None):
        self.task = task
        self.strategy = st.resolve(strategy)
        self.federation = federation or FederatedConfig(
            n_clients=8, local_batch=8, local_steps=1)
        self.model = model or ModelOptions()
        self.lora = lora or LoRAConfig()
        self.train = train or TrainOptions()
        self.engine = eng.resolve_engine(engine)
        self.device = resolve_device(device)
        self._params_and_cfg: Optional[Tuple[Any, Any]] = None
        self._data_provider: Optional[eng.DataProvider] = None
        self._callbacks: List[eng.Callback] = []

    # --- builder facets ----------------------------------------------------
    def with_strategy(self, strategy: Optional[st.StrategyLike] = None,
                      **overrides) -> "Experiment":
        """Kind string + StrategySpec field overrides, a StrategySpec, or a
        Strategy instance."""
        if strategy is None:
            spec = dataclasses.replace(self.strategy.spec, **overrides)
        elif isinstance(strategy, str):
            spec = st.StrategySpec(kind=strategy, **overrides)
        else:
            if overrides:
                raise TypeError("pass overrides with a kind string")
            spec = strategy
        self.strategy = st.resolve(spec)
        return self

    def with_federation(self, federation: Optional[FederatedConfig] = None,
                        **overrides) -> "Experiment":
        if federation is None:
            federation = dataclasses.replace(self.federation, **overrides)
        elif overrides:
            raise TypeError("pass overrides without a config object")
        self.federation = federation
        return self

    def with_model(self, model: Optional[ModelOptions] = None,
                   **overrides) -> "Experiment":
        if model is not None and overrides:
            raise TypeError("pass overrides without a config object")
        self.model = model or dataclasses.replace(self.model, **overrides)
        return self

    def with_lora(self, rank: Optional[int] = None,
                  alpha: Optional[float] = None,
                  config: Optional[LoRAConfig] = None) -> "Experiment":
        if config is not None and (rank is not None or alpha is not None):
            raise TypeError("pass overrides without a config object")
        if config is None:
            kw = {}
            if rank is not None:
                kw["rank"] = rank
            if alpha is not None:
                kw["alpha"] = alpha
            config = dataclasses.replace(self.lora, **kw)
        self.lora = config
        return self

    def with_training(self, train: Optional[TrainOptions] = None,
                      **overrides) -> "Experiment":
        if train is not None and overrides:
            raise TypeError("pass overrides without a config object")
        self.train = train or dataclasses.replace(self.train, **overrides)
        return self

    def with_params(self, params, cfg) -> "Experiment":
        """The frozen backbone (nested dict of tensors on the experiment's
        device) and its ModelConfig, used as given instead of building and
        pretraining one from `ModelOptions`."""
        self._params_and_cfg = (params, cfg)
        return self

    def with_engine(self, engine: eng.EngineLike, **kwargs) -> "Experiment":
        """Execution backend: "sim", or "async" with the `AsyncEngine`
        arguments (concurrency, buffer_size, staleness_alpha,
        max_staleness, allow_version_repeats, profile).  "sharded" and the
        async engine's `sampler=` raise (ROADMAP queue 1)."""
        self.engine = eng.resolve_engine(engine, **kwargs)
        return self

    def with_mesh(self, *args, **kwargs) -> "Experiment":
        raise _not_ported("with_mesh (the sharded engine)", "item 8")

    def with_data(self, provider: eng.DataProvider) -> "Experiment":
        """Replace the task's `sample_round` batches with
        `provider(round_idx) -> client_batches`: a dict of tensors on the
        experiment's device, leaves (n_clients, local_steps, local_batch,
        ...)."""
        self._data_provider = provider
        return self

    def with_checkpoint(self, directory: str, every: int = 10) -> "Experiment":
        raise _not_ported("checkpoint/resume of experiments", "item 3")

    def with_callbacks(self, *callbacks: eng.Callback) -> "Experiment":
        """Append user callbacks (they run after the ledger, eval and
        logging callbacks)."""
        self._callbacks.extend(callbacks)
        return self

    def with_population(self, *args, **kwargs) -> "Experiment":
        raise _not_ported("client populations", "item 4")

    # --- assembly ----------------------------------------------------------
    def build_backbone(self):
        """(params, ModelConfig) for the frozen backbone: as given by
        `with_params`, else the task's model from `ModelOptions`,
        initialized from the training seed on the experiment's device and
        pretrained for `pretrain_steps`."""
        if self._params_and_cfg is not None:
            return self._params_and_cfg
        t = self.train
        cfg = rt.model_for_task(self.task, **self.model.kwargs())
        params = init_params(mdl.model_spec(cfg), t.seed, device=self.device)
        params, _ = rt.pretrain(params, cfg, self.task, t.pretrain_steps,
                                seed=t.seed)
        return params, cfg

    def _build_trainable(self, params, cfg):
        """(tree, FlatMeta, LoRA scale) of the flat vector: LoRA (seed + 1),
        plus the `head` subtree (classifier head and final norm) when
        `train_head` and the model classifies; under `full_finetune` the
        whole backbone, at scale 1.0."""
        t = self.train
        if t.full_finetune:
            trainable: Dict[str, Any] = {"lora": {}, "head": {},
                                         "backbone": params}
            return trainable, fedround.FlatMeta.of(trainable), 1.0
        lora0 = lora_mod.init_lora(cfg, self.lora, seed=t.seed + 1,
                                   device=self.device)
        trainable = {"lora": lora0}
        if t.train_head and cfg.num_classes > 0:
            trainable["head"] = {"cls_head": params["cls_head"],
                                 "final_norm": params["final_norm"]}
        return trainable, fedround.FlatMeta.of(trainable), self.lora.scale

    def build_ledger(self, p_len: int) -> comm_mod.CommLedger:
        """Ledger whose per-value widths and coding come from the spec's
        transport configuration (`transport.wire_format`)."""
        spec = self.strategy.spec
        down_vb, down_dense = tp.wire_format(spec, p_len, "down")
        up_vb, up_dense = tp.wire_format(spec, p_len, "up")
        return comm_mod.CommLedger(total_params=p_len,
                                   down_value_bytes=down_vb,
                                   up_value_bytes=up_vb,
                                   down_dense=down_dense,
                                   up_dense=up_dense)

    def _default_data(self) -> eng.DataProvider:
        """Round r's client batches: `sample_round`'s numpy arrays, moved
        to the experiment's device."""
        task, fed, seed, device = (self.task, self.federation,
                                   self.train.seed, self.device)

        def data(r: int):
            return rt._to_device(sample_round(task, fed, r, seed=seed), device)
        return data

    def run(self) -> rt.ExperimentResult:
        task, t = self.task, self.train
        if task is None and (self._data_provider is None
                             or self._params_and_cfg is None):
            raise ValueError("task-less experiments need with_data(...) and "
                             "with_params(...)")
        params, cfg = self.build_backbone()
        trainable, meta, scale = self._build_trainable(params, cfg)

        def loss_of(bb, tree, mb):
            if t.full_finetune:
                return rt.task_loss(tree["backbone"], cfg, mb)
            p = dict(bb)
            if "head" in tree:
                p.update(tree["head"])
            return mdl.loss_fn(p, cfg, rt._task_batch(cfg, mb),
                               lora=tree["lora"], lora_scale=scale)

        plan = eng.RoundTask(loss_of, meta, self.federation, self.strategy,
                             seed=t.seed, params=params)
        state = eng.RunState.fresh(plan, meta.flatten(trainable),
                                   rounds=t.rounds)
        ledger = self.build_ledger(meta.p_len)
        callbacks: List[eng.Callback] = [eng.LedgerCallback(ledger)]
        eval_cb = None
        if task is not None:
            eval_cb = eng.EvalCallback(
                lambda flatP: rt.evaluate(params, cfg, trainable, meta, task,
                                          scale, flatP),
                every=t.eval_every)
            callbacks.append(eval_cb)
        callbacks.append(eng.LoggingCallback(t.verbose, every=t.log_every))
        callbacks.extend(self._callbacks)
        data = self._data_provider or self._default_data()
        state = self.engine.run_rounds(state, data, callbacks)
        acc = eval_cb.acc if eval_cb is not None else 0.0
        return rt.ExperimentResult(state.history, ledger, acc)
