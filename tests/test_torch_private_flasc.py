"""`examples/private_flasc_torch.py` (the DP-FedAdam noise sweep over full
finetuning, LoRA, FLASC and FFA-LoRA, paper §4.5) against the reference's
`Experiment` with the example's settings, at 2 rounds on the CPU.

Both packages start from the same state: the reference's backbone (2
pretraining steps of the example's model on the example's task, which the
port's data module makes bit for bit) carried over with
`checkpoint/io.py::tree_from_numpy`, and the reference's LoRA init.  The
ledger's values and bytes then hold exactly, method by method, at sigma 0
(clipping only).  At sigma > 0 the noise draws are not ported (JAX's
threefry against torch's Philox): the same normal draw is injected into
both packages' `dp_aggregate`, and again only the ledger is compared (the
noised models differ by the packages' rounding, which Adam's first step
amplifies: tests/_fed_parity.py): exactly, except full finetuning's
uploads, whose count of exact-zero deltas (updates under half an ulp of
their weight, not sent) may differ by a few values in a million: within
1e-5.  Accuracies are only checked to lie in [0, 1].
"""
import _torch_threads  # noqa: F401  (this process's share of the cores)
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.strategies import StrategySpec as JSpec
from repro.data.datasets import make_synth_reddit as j_reddit
from repro.federated.api import Experiment as JExperiment
from repro.models import lora as jlora
from repro.models.config import FederatedConfig as JFed
from repro.models.config import LoRAConfig as JLoRAConfig
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.checkpoint.io import tree_from_numpy
from repro_torch.federated.api import Experiment as TExperiment
from repro_torch.models import lora as tlora
from repro_torch.models.config import ModelConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 2
PRETRAIN = 2
LEDGER = ("total_bytes", "up_coded_bytes", "down_coded_bytes", "up_values",
          "down_values")


def _example():
    path = os.path.join(ROOT, "examples", "private_flasc_torch.py")
    spec = importlib.util.spec_from_file_location("private_flasc_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EX = _example()


def _reference_rows(sigma, backbone):
    """The reference example's loop at ROUNDS rounds for one sigma, on its
    backbone of PRETRAIN steps (built once)."""
    task = j_reddit(n_users=128, vocab=128, length=20)
    fed = JFed(**dataclasses.asdict(EX.federation(sigma)))
    rows = []
    for name, spec, kw in EX.METHODS:
        res = (JExperiment(task, strategy=JSpec(**dataclasses.asdict(spec)),
                           federation=fed)
               .with_params(*backbone)
               .with_model(**EX.MODEL)
               .with_lora(rank=16)
               .with_training(rounds=ROUNDS, eval_every=ROUNDS,
                              pretrain_steps=PRETRAIN, **kw)
               .run())
        rows.append({"method": name, **{k: getattr(res.ledger, k)
                                        for k in LEDGER}})
    return rows


@pytest.fixture(scope="module")
def same_start():
    """The reference's backbone and LoRA init in the port's Experiment."""
    task = j_reddit(n_users=128, vocab=128, length=20)
    jexp = (JExperiment(task).with_model(**EX.MODEL).with_lora(rank=16)
            .with_training(pretrain_steps=PRETRAIN))
    params, cfg = jexp.build_backbone()
    backbone = (tree_from_numpy(jax.tree.map(np.asarray, params),
                                device="cpu"),
                ModelConfig(**dataclasses.asdict(cfg)))

    def init_lora(cfg, lcfg, seed=0, *, device=None, generator=None):
        tree = jlora.init_lora(JModelConfig(**dataclasses.asdict(cfg)),
                               JLoRAConfig(**dataclasses.asdict(lcfg)),
                               jax.random.key(seed))
        return tree_from_numpy(jax.tree.map(np.asarray, tree), device=device)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TExperiment, "build_backbone", lambda self: backbone)
        mp.setattr(tlora, "init_lora", init_lora)
        yield mp, (params, cfg)


def _noise(shape):
    return np.random.default_rng(5).standard_normal(shape).astype(np.float32)


def _inject_noise(mp):
    """Both packages' dp_aggregate add the same standard normal draw."""
    from repro.core import dp as jdp
    from repro_torch.core import dp as tdp
    jorig, torig = jdp.dp_aggregate, tdp.dp_aggregate

    def jagg(deltas, clip_norm, noise_mult, key):
        agg, norms = jorig(deltas, clip_norm, 0.0, key)
        n = deltas.shape[0]
        return agg + (noise_mult / n) * jnp.asarray(_noise(agg.shape)), norms

    def tagg(deltas, clip_norm, noise_mult, generator):
        agg, norms = torig(deltas, clip_norm, 0.0, generator)
        n = deltas.shape[0]
        return agg + (noise_mult / n) * torch.from_numpy(
            _noise(tuple(agg.shape))).to(agg.device), norms

    mp.setattr(jdp, "dp_aggregate", jagg)
    mp.setattr(tdp, "dp_aggregate", tagg)


@pytest.mark.parametrize("noisy", [False, True], ids=["sigma0", "sigma_sim"])
def test_example_ledger_matches_reference(same_start, noisy, capsys):
    sigma = EX.default_sigmas()[1] if noisy else 0.0
    assert (sigma > 0) == noisy
    mp, jbackbone = same_start
    if noisy:
        _inject_noise(mp)
    got = EX.main(ROUNDS, (sigma,), pretrain_steps=PRETRAIN, device="cpu")
    want = _reference_rows(sigma, jbackbone)
    assert [r["method"] for r in got] == [r["method"] for r in want] == \
        [m[0] for m in EX.METHODS]
    for g, w in zip(got, want):
        assert g["sigma"] == sigma and 0.0 <= g["acc"] <= 1.0
        if noisy and g["method"] == "full-ft":
            # a client whose update of a weight is under half its ulp uploads
            # an exact 0, which is not sent: on noised weights that rounded
            # differently, a few such values differ (2 of 1,041,588 here)
            for k in ("down_values", "down_coded_bytes"):
                assert g[k] == w[k], k
            for k in ("up_values", "up_coded_bytes", "total_bytes"):
                assert abs(g[k] - w[k]) <= 1e-5 * w[k], (k, g[k], w[k])
            continue
        assert {k: g[k] for k in LEDGER} == {k: w[k] for k in LEDGER}, \
            g["method"]
    # FLASC at density 1/2 sends half the values of dense LoRA's download
    by = {r["method"]: r for r in got}
    assert by["flasc d=1/2"]["down_values"] * 2 == by["lora r16"]["down_values"]
    assert f"sigma={sigma:.4f}" in capsys.readouterr().out


def test_example_defaults_are_the_reference_sweep():
    sig = EX.default_sigmas()
    assert sig[0] == 0.0 and sig[2] == pytest.approx(5 * sig[1])
    assert sig[1] == pytest.approx(0.58 * 10 / 1000)
    assert EX.main.__defaults__ == (30, None)
    assert EX.main.__kwdefaults__ == {"pretrain_steps": 100, "device": None}
    fed = EX.federation(0.1)
    assert (fed.n_clients, fed.local_batch, fed.client_lr, fed.server_lr,
            fed.dp_clip, fed.dp_noise) == (10, 8, 5e-3, 2e-2, 0.05, 0.1)
