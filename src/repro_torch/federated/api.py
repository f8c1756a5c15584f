"""Typed experiment builder for federated LoRA finetuning.

The port of `src/repro/federated/api.py` on its task-less path: the one
`launch/train.py` builds in the reference, a backbone given with
`with_params` and client batches from `with_data`.

    result = (Experiment(None, federation=FederatedConfig(n_clients=4,
                                                          local_batch=4),
                         device="cpu")
              .with_strategy("flasc", selector="fused", quant_bits_up=4)
              .with_lora(rank=8)
              .with_training(rounds=2)
              .with_params(params, cfg)
              .with_data(batch_for_round)
              .with_engine("sim")
              .run())

`run()` returns `ExperimentResult(history, ledger, final_acc)`.  Like every
entry point of the port it runs on the card unless `device` says
otherwise; the backbone and the batches must already be on that device.

Not ported yet, and raising `NotImplementedError`: a `FederatedTask` and
everything it drives (the model built from `ModelOptions`, pretraining,
evaluation), checkpoint/resume, a device mesh and client populations
(ROADMAP queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

from repro_torch import DeviceLike, resolve_device
from repro_torch.core import comm as comm_mod
from repro_torch.core import fedround
from repro_torch.core import strategies as st
from repro_torch.core import transport as tp
from repro_torch.federated import engine as eng
from repro_torch.federated import runtime as rt
from repro_torch.models import lora as lora_mod
from repro_torch.models import model as mdl
from repro_torch.models.config import FederatedConfig, LoRAConfig


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    """The training loop's settings (the reference's fields; the task-only
    ones must keep their task-less values)."""
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

    def __init__(self, task=None, *,
                 strategy: st.StrategyLike = "flasc",
                 federation: Optional[FederatedConfig] = None,
                 lora: Optional[LoRAConfig] = None,
                 train: Optional[TrainOptions] = None,
                 engine: eng.EngineLike = "sim",
                 device: DeviceLike = None):
        if task is not None:
            raise _not_ported("a FederatedTask (repro.data, model_for_task, "
                              "pretrain, evaluate)", "item 6")
        self.strategy = st.resolve(strategy)
        self.federation = federation or FederatedConfig(
            n_clients=8, local_batch=8, local_steps=1)
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

    def with_model(self, *args, **kwargs) -> "Experiment":
        raise _not_ported("with_model (the task model)", "item 6")

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
        device) and its ModelConfig."""
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
        raise _not_ported("with_mesh (the sharded engine)", "item 12")

    def with_data(self, provider: eng.DataProvider) -> "Experiment":
        """`provider(round_idx) -> client_batches`: a dict of tensors on the
        experiment's device, leaves (n_clients, local_steps, local_batch,
        ...)."""
        self._data_provider = provider
        return self

    def with_checkpoint(self, directory: str, every: int = 10) -> "Experiment":
        raise _not_ported("checkpoint/resume of experiments", "item 6")

    def with_callbacks(self, *callbacks: eng.Callback) -> "Experiment":
        """Append user callbacks (they run after the ledger and logging
        callbacks)."""
        self._callbacks.extend(callbacks)
        return self

    def with_population(self, *args, **kwargs) -> "Experiment":
        raise _not_ported("client populations", "item 8")

    # --- assembly ----------------------------------------------------------
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

    def run(self) -> rt.ExperimentResult:
        t, fed = self.train, self.federation
        if self._data_provider is None or self._params_and_cfg is None:
            raise ValueError("task-less experiments need with_data(...) and "
                             "with_params(...)")
        if t.full_finetune:
            raise _not_ported("full finetuning", "item 6")
        params, cfg = self._params_and_cfg
        lora0 = lora_mod.init_lora(cfg, self.lora, seed=t.seed + 1,
                                   device=self.device)
        trainable = {"lora": lora0}
        meta = fedround.FlatMeta.of(trainable)
        scale = self.lora.scale

        def loss_of(bb, tree, mb):
            return mdl.loss_fn(bb, cfg, rt._task_batch(cfg, mb),
                               lora=tree["lora"], lora_scale=scale)

        plan = eng.RoundTask(loss_of, meta, fed, self.strategy, seed=t.seed,
                             params=params)
        state = eng.RunState.fresh(plan, meta.flatten(trainable),
                                   rounds=t.rounds)
        ledger = self.build_ledger(meta.p_len)
        callbacks: List[eng.Callback] = [
            eng.LedgerCallback(ledger),
            eng.LoggingCallback(t.verbose, every=t.log_every)]
        callbacks.extend(self._callbacks)
        state = self.engine.run_rounds(state, self._data_provider, callbacks)
        return rt.ExperimentResult(state.history, ledger, 0.0)
