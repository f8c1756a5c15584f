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

`with_checkpoint(dir, every)` snapshots the run in the reference's format
(`checkpoint/io.py`: the same npz keys, shapes and dtypes and the same
`meta.json` keys, so either package resumes the other's snapshot), and
`Experiment.resume(dir)` rebuilds the experiment and runs the remaining
rounds, bit for bit the uninterrupted run's (an async run's event queue
and a population's store included).  `with_population(N, sampler=...)`
samples each round's cohort out of N clients with persistent momentum
rows in a host store (`federated/population.py`).

Not ported yet, and raising `NotImplementedError`: a device mesh
(ROADMAP queue 1, item 8).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import DeviceLike, resolve_device
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core import comm as comm_mod
from repro_torch.core import fedround
from repro_torch.core import strategies as st
from repro_torch.core import transport as tp
from repro_torch.data.datasets import FederatedTask
from repro_torch.data.pipeline import sample_round
from repro_torch.federated import engine as eng
from repro_torch.federated import population as popn
from repro_torch.federated import runtime as rt
from repro_torch.models import lora as lora_mod
from repro_torch.models import model as mdl
from repro_torch.models.config import FederatedConfig, LoRAConfig, ModelConfig
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
        self._checkpoint: Optional[Tuple[str, int, bool]] = None
        self._callbacks: List[eng.Callback] = []
        self._restore: Optional[Tuple[Any, Dict[str, Any]]] = None
        self._frozen_written = False
        self._population: Optional[Dict[str, Any]] = None
        self._population_bundle: Optional[popn.Population] = None

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
        max_staleness, allow_version_repeats, profile, sampler).
        "sharded" raises (ROADMAP queue 1, item 8)."""
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

    def with_checkpoint(self, directory: str, every: int = 10, *,
                        save_model_config: bool = False) -> "Experiment":
        """Snapshot the run into `directory` every `every` rounds;
        `Experiment.resume(directory)` restarts from the latest snapshot.

        Resume rebuilds the model from `ModelOptions`, as the reference
        does, so a backbone given by `with_params` under another ModelConfig
        is refused at `run()`.  `save_model_config=True` accepts it and
        writes the config to the sidecar (`meta["model_config"]`, a key the
        port adds), from which the port's `resume` rebuilds it; the
        reference's `resume` does not read that key, so such a snapshot
        resumes in the port only."""
        self._checkpoint = (directory, int(every), bool(save_model_config))
        return self

    def with_callbacks(self, *callbacks: eng.Callback) -> "Experiment":
        """Append user callbacks (they run after the ledger, eval and
        logging callbacks)."""
        self._callbacks.extend(callbacks)
        return self

    def with_population(self, population: int, *,
                        sampler: popn.SamplerLike = "uniform",
                        chunk: int = 4096, prefetch: bool = True,
                        **sampler_kw) -> "Experiment":
        """Sample each round's `n_clients` cohort out of `population`
        clients with the named `CohortSampler` (e.g. `sampler="fraction",
        participation=0.3`), gather their momentum rows from a chunked host
        `PopulationStore` (`chunk` clients a chunk, each chunk `chunk x
        p_len x 4` bytes once written; 0 selects the dense device store, a
        test backend) and commit the final rows after the round.
        `prefetch` stages the next cohort while the current round computes.
        Synchronous engines only (`AsyncEngine` takes `sampler=`)."""
        self._population = {"population": int(population),
                            "sampler": sampler, "chunk": int(chunk),
                            "prefetch": bool(prefetch),
                            "sampler_kw": dict(sampler_kw)}
        return self

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

        pop = None
        if self._population is not None:
            ps = self._population
            pop = popn.Population.build(
                ps["population"], meta.p_len, cohort=self.federation.n_clients,
                sampler=ps["sampler"], seed=t.seed, chunk=ps["chunk"],
                prefetch=ps["prefetch"], device=self.device,
                **ps["sampler_kw"])
            self._population_bundle = pop
        plan = eng.RoundTask(loss_of, meta, self.federation, self.strategy,
                             seed=t.seed, population=pop, params=params)
        state = eng.RunState.fresh(plan, meta.flatten(trainable),
                                   rounds=t.rounds)
        if self._restore is not None:
            state, ledger, saved_acc = self._restore_state(state)
        else:
            ledger, saved_acc = self.build_ledger(meta.p_len), 0.0
        callbacks: List[eng.Callback] = [eng.LedgerCallback(ledger)]
        eval_cb = None
        if task is not None:
            eval_cb = eng.EvalCallback(
                lambda flatP: rt.evaluate(params, cfg, trainable, meta, task,
                                          scale, flatP),
                every=t.eval_every)
            eval_cb.acc = saved_acc
            callbacks.append(eval_cb)
        callbacks.append(eng.LoggingCallback(t.verbose, every=t.log_every))
        if self._checkpoint is not None:
            if task is None:
                raise ValueError("checkpointing needs a FederatedTask")
            directory, every, save_cfg = self._checkpoint
            if (self._params_and_cfg is not None and self._restore is None
                    and not save_cfg
                    and cfg != rt.model_for_task(task, **self.model.kwargs())):
                raise ValueError(
                    "with_checkpoint cannot snapshot a custom ModelConfig "
                    "supplied via with_params: resume rebuilds the config "
                    "from ModelOptions — configure the model through "
                    "with_model(...) instead (or pass "
                    "with_checkpoint(..., save_model_config=True), a "
                    "snapshot only the port resumes)")
            callbacks.append(eng.CheckpointCallback(
                directory, every,
                lambda d, s: self._save_checkpoint(d, s, params, cfg, ledger,
                                                   eval_cb)))
        callbacks.extend(self._callbacks)
        data = self._data_provider or self._default_data()
        state = self.engine.run_rounds(state, data, callbacks)
        acc = eval_cb.acc if eval_cb is not None else 0.0
        return rt.ExperimentResult(state.history, ledger, acc)

    # --- checkpoint / resume ----------------------------------------------
    def _save_checkpoint(self, directory: str, state: eng.RunState, params,
                         cfg: ModelConfig, ledger, eval_cb) -> str:
        """One snapshot with the reference's npz keys and sidecar keys (plus
        `model_config` when `save_model_config`)."""
        task = self.task
        arrays = {"P": state.flatP, "server": state.server,
                  "strategy": state.sstate}
        if state.aux is not None:   # engine-owned state: clock or store
            arrays["aux"] = state.aux
        frozen = {        # run-constant payload, written once per directory
            "params": params,
            "task": {"parts": {str(i): p for i, p in enumerate(task.parts)},
                     "data": task.data, "eval_data": task.eval_data},
        }
        directory_, every, save_cfg = self._checkpoint
        meta_json = {
            "version": 1,
            "round": state.round,
            "history": state.history,
            "acc": float(eval_cb.acc) if eval_cb is not None else 0.0,
            "ledger": {f.name: getattr(ledger, f.name)
                       for f in dataclasses.fields(ledger)},
            "strategy": dataclasses.asdict(self.strategy.spec),
            "federation": dataclasses.asdict(self.federation),
            "model": self.model.kwargs(),
            "lora": dataclasses.asdict(self.lora),
            "train": dataclasses.asdict(self.train),
            "task_meta": {"name": task.name, "kind": task.kind,
                          "n_classes": task.n_classes},
            "checkpoint": {"dir": directory_, "every": every},
            "engine": {"name": self.engine.name,
                       "config": self.engine.config(),
                       "rounds_per_call":
                           int(getattr(self.engine, "rounds_per_call", 1))},
        }
        if save_cfg:
            meta_json["model_config"] = dataclasses.asdict(cfg)
        if self._population_bundle is not None:
            # the store itself rides state.aux; the sidecar keeps the facets
            meta_json["population"] = self._population_bundle.config()
        # a fresh run's first save replaces a frozen payload left by
        # another run in the same directory
        overwrite = not (self._frozen_written or self._restore is not None)
        self._frozen_written = True
        return ckpt_io.save_experiment_checkpoint(directory, arrays, meta_json,
                                                  frozen=frozen,
                                                  overwrite_frozen=overwrite)

    def _restore_state(self, fresh: eng.RunState):
        """The snapshot's state in the form of the fresh state `fresh`:
        tensors on its device in its dtypes, the round index and the
        strategy's flags as host scalars."""
        arrays, mj = self._restore
        flatP = ckpt_io.restore_like(arrays["P"], fresh.flatP)
        server = ckpt_io.restore_like(arrays["server"], fresh.server)
        sstate = ckpt_io.restore_like(arrays.get("strategy", {}),
                                      fresh.sstate)
        state = eng.RunState(fresh.plan, flatP, server, sstate,
                             round=int(mj["round"]), rounds=self.train.rounds,
                             history=list(mj["history"]),
                             aux=arrays.get("aux"))
        ledger = comm_mod.CommLedger(**mj["ledger"])
        return state, ledger, float(mj.get("acc", 0.0))

    @classmethod
    def resume(cls, directory: str, task: Optional[FederatedTask] = None,
               device: DeviceLike = None) -> "Experiment":
        """Rebuild an experiment from its latest snapshot, on `device` (the
        card by default): the frozen backbone goes there in its saved
        dtypes, the task arrays stay host numpy arrays in theirs.  `.run()`
        then runs exactly the remaining rounds; restored history plus the
        new records reproduce the uninterrupted run bit for bit.  Extend a
        run with `.with_training(rounds=...)` before `.run()`.  The saved
        engine (name and `config()`) is restored; an async run also
        restores its event queue, a population run its store."""
        arrays, mj = ckpt_io.load_experiment_checkpoint(directory)
        if task is None:
            tm, tarr = mj["task_meta"], arrays["task"]
            parts = [np.asarray(tarr["parts"][str(i)])
                     for i in range(len(tarr["parts"]))]
            task = FederatedTask(tm["name"], tm["kind"], parts,
                                 tarr["data"], tarr["eval_data"],
                                 tm["n_classes"])
        sj = dict(mj["strategy"])
        for k in ("client_densities", "hetlora_ranks"):
            sj[k] = tuple(sj.get(k, ()))
        lj = dict(mj["lora"])
        lj["targets"] = tuple(lj.get("targets", ()))
        exp = cls(task,
                  strategy=st.StrategySpec(**sj),
                  federation=FederatedConfig(**mj["federation"]),
                  model=ModelOptions(**mj["model"]),
                  lora=LoRAConfig(**lj),
                  train=TrainOptions(**mj["train"]),
                  device=device)
        cj = mj.get("model_config")
        if cj is not None:
            cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in cj.items()})
        else:
            cfg = rt.model_for_task(task, **exp.model.kwargs())
        exp.with_params(ckpt_io.tree_from_numpy(arrays["params"],
                                                device=exp.device), cfg)
        exp.with_checkpoint(mj["checkpoint"]["dir"], mj["checkpoint"]["every"],
                            save_model_config=cj is not None)
        ej = mj.get("engine", {"name": "sim"})
        ekw = ej.get("config")
        if ekw is None:     # pre-config snapshots stored only the chunk
            ekw = ({"rounds_per_call": ej["rounds_per_call"]}
                   if ej.get("rounds_per_call", 1) > 1 else {})
        exp.with_engine(ej["name"], **ekw)
        pj = mj.get("population")
        if pj is not None:
            # the sampler spec carries cohort and seed; the store comes
            # back from the snapshot's aux when run() enters the loop
            exp._population = {"population": int(pj["population"]),
                               "sampler": dict(pj["sampler"]),
                               "chunk": int(pj["chunk"]),
                               "prefetch": bool(pj["prefetch"]),
                               "sampler_kw": {}}
        exp._restore = (arrays, mj)
        return exp
