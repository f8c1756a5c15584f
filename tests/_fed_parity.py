"""Shared harness of the strategy parity tests (`test_torch_strategies.py`,
`test_torch_baselines.py`): the reference's `SimEngine` and the port's run
the same strategy spec from the same converted state on the same batches,
at `test_torch_round.py`'s size (2 layers, d 64, f32, rank-4 LoRA with a
nonzero `b`, 4 clients x 1 step x 4 sequences of 16 tokens).

FedAdam runs at `adam_eps` 1e-5, not the default 1e-8.  Kinds that upload
dense or fixed-mask deltas (not Top-K, which keeps only large entries)
hand Adam entries whose clients' deltas cancel: one entry's mean is
-5.03e-8 in the reference and -5.22e-8 in the port (the clients' deltas
themselves agree to 7e-9), and Adam's first step g / (|g| + eps) turns
that into 9.9e-6 of the entry's update at eps 1e-8.  At eps 1e-5 the
same difference moves an update by at most 1e-7, while a typical
pseudo-gradient (3e-4) still takes a step of 0.97 lr.

Each run keeps, per round, the upload messages handed to `aggregate`, the
flat vector and the strategy state after the round, and the ledger's
history record.  `compare` holds them to the tolerances the tests state:
  - losses rtol 1e-5;
  - upload-mask overlap >= 0.999, and equal ledger bytes where the masks
    agree;
  - the flat vector after each round atol 1e-6 on every entry whose upload
    masks agreed for every client in every round so far (for
    `two_stage_ortho`, whose QR is unique only up to the signs of Q's
    columns: every product A·B of such entries, and every other such
    entry, see `pair_products`).  An entry one package uploads and the
    other drops (a Top-K boundary decided by a rounding difference) gets
    another pseudo-gradient: there the two vectors may differ by the
    Adam steps taken, at most 4 server_lr a round;
  - the strategy state: masks overlap >= 0.999, floats atol 1e-6 on the
    same entries, flags equal;
  - download masks bitwise, each package computing its mask from the same
    (reference) flat vector and state at the start of every round.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import fedround as jfr
from repro.core import strategies as jst
from repro.federated import api as japi
from repro.federated import engine as jeng
from repro.models import layers as JL
from repro.models import lora as jlora
from repro.models import model as JM
from repro.models.config import FederatedConfig as JFederatedConfig
from repro.models.config import LoRAConfig as JLoRAConfig
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.checkpoint.io import tree_from_numpy
from repro_torch.core import fedround as tfr
from repro_torch.core import strategies as tst
from repro_torch.federated import Experiment
from repro_torch.federated import engine as teng
from repro_torch.models import model as TM
from repro_torch.models.config import FederatedConfig, ModelConfig

CFG = JModelConfig(name="t", family="dense", num_layers=2, d_model=64,
                   num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
                   param_dtype="float32", compute_dtype="float32")
LCFG = JLoRAConfig(rank=4, alpha=8.0)
FED = dict(n_clients=4, local_batch=4, local_steps=1, client_lr=5e-2,
           server_lr=2e-3, adam_eps=1e-5)
SEQ = 16
RTOL, ATOL, OVERLAP = 1e-5, 1e-6, 0.999
LEDGER_KEYS = ("down_bytes", "up_bytes", "coded_bytes", "down_coded_bytes",
               "up_coded_bytes")


def t_(a):
    return torch.from_numpy(np.array(a))


def build_model():
    """Reference backbone and LoRA tree (numpy-drawn, nonzero `b`), plus
    their port conversions."""
    params = jax.tree.map(np.asarray, jax.jit(
        lambda k: JL.init_params(JM.model_spec(CFG), k))(jax.random.key(0)))
    rng = np.random.default_rng(1)
    spec = jlora.lora_spec(CFG, LCFG)
    lora = jax.tree.map(
        lambda p: (rng.standard_normal(p.shape, dtype=np.float32)
                   * np.float32(0.1)), spec,
        is_leaf=lambda x: isinstance(x, JL.P))
    return {"params": params, "lora": lora,
            "tparams": tree_from_numpy(params, device="cpu"),
            "tlora": tree_from_numpy(lora, device="cpu"),
            "tcfg": ModelConfig(**dataclasses.asdict(CFG))}


def tokens(seed, *shape):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, shape).astype(np.int32)


def capturing(base, jax_side: bool):
    """`base` with its `aggregate` keeping each round's upload messages in
    the instance's `kept` list (a debug callback under the reference's
    jit)."""
    def aggregate(self, deltas, ctx):
        if jax_side:
            jax.debug.callback(lambda d: self.kept.append(np.asarray(d)),
                               deltas)
        else:
            self.kept.append(deltas.numpy().copy())
        return base.aggregate(self, deltas, ctx)
    return type(f"Capturing{base.__name__}", (base,), {"aggregate": aggregate})


def _np_state(sstate):
    return {k: (bool(v) if k == "initialized" else np.array(v))
            for k, v in sstate.items()}


def port_sstate(jsst):
    """A reference strategy state (numpy) as the port holds it."""
    return {k: (bool(v) if k == "initialized" else t_(v))
            for k, v in jsst.items()}


@dataclasses.dataclass
class Run:
    strat: object
    state: object
    ledger: object
    flats: list                 # flat vector after each round
    sstates: list               # strategy state after each round (numpy)


def _keeper(base):
    class Keep(base):
        def __init__(self):
            self.flats, self.sstates = [], []

        def on_round_end(self, ev):
            self.flats.append(np.array(ev.state.flatP))
            self.sstates.append(_np_state(ev.state.sstate))
    return Keep()


def run_pair(model, spec_kw, rounds, fed_kw=None):
    """(reference Run, port Run, initial flat vector, initial reference
    strategy state) for `rounds` rounds of `StrategySpec(**spec_kw)`."""
    fed = dict(FED, **(fed_kw or {}))
    jspec, tspec = jst.StrategySpec(**spec_kw), tst.StrategySpec(**spec_kw)
    jstrat = capturing(type(jst.resolve(jspec)), True)(jspec)
    tstrat = capturing(type(tst.resolve(tspec)), False)(tspec)
    jstrat.kept, tstrat.kept = [], []
    batches = [{"tokens": tokens(10 + r, fed["n_clients"], 1, 4, SEQ)}
               for r in range(rounds)]

    jmeta = jfr.FlatMeta.of({"lora": model["lora"]})
    jtask = jeng.RoundTask(
        lambda bb, tree, mb: JM.loss_fn(bb, CFG, mb, lora=tree["lora"],
                                        lora_scale=LCFG.scale),
        jmeta, JFederatedConfig(**fed), jstrat, seed=0,
        params=model["params"])
    jstate = jeng.RunState.fresh(jtask, jmeta.flatten({"lora": model["lora"]}),
                                 rounds=rounds)
    flat0 = np.asarray(jstate.flatP)
    sst0 = _np_state(jstate.sstate)
    jled = jeng.LedgerCallback(japi.Experiment(None, strategy=jspec)
                               .build_ledger(jmeta.p_len))
    jkeep = _keeper(jeng.Callback)
    jstate = jeng.SimEngine().run_rounds(
        jstate, lambda r: jax.tree.map(jnp.asarray, batches[r]),
        [jled, jkeep])

    tmeta = tfr.FlatMeta.of({"lora": model["tlora"]})
    ttask = teng.RoundTask(
        lambda bb, tree, mb: TM.loss_fn(bb, model["tcfg"], mb,
                                        lora=tree["lora"],
                                        lora_scale=LCFG.scale),
        tmeta, FederatedConfig(**fed), tstrat, seed=0,
        params=model["tparams"])
    tstate = teng.RunState.fresh(ttask, t_(flat0), rounds=rounds)
    tled = teng.LedgerCallback(Experiment(device="cpu", strategy=tspec)
                               .build_ledger(tmeta.p_len))
    tkeep = _keeper(teng.Callback)
    tstate = teng.SimEngine().run_rounds(
        tstate, lambda r: {k: t_(v) for k, v in batches[r].items()},
        [tled, tkeep])
    return (Run(jstrat, jstate, jled.ledger, jkeep.flats, jkeep.sstates),
            Run(tstrat, tstate, tled.ledger, tkeep.flats, tkeep.sstates),
            flat0, sst0)


def pair_products(meta, flat, keep):
    """{path: A @ B in f64} of every LoRA pair of a port flat vector whose
    entries are all in `keep`, and the `keep` entries of no pair."""
    tree, kept = meta.unflatten(t_(flat)), meta.unflatten(t_(keep))
    prods, rest = {}, []

    def walk(node, k, path):
        if isinstance(node, dict) and {"a", "b"} <= set(node) and \
                not isinstance(node["a"], dict):
            if k["a"].all() and k["b"].all():
                prods[path] = (node["a"].double() @ node["b"].double()
                               ).numpy()
            return
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], k[key], path + (key,))
            return
        rest.append(node.reshape(-1)[k.reshape(-1)].double().numpy())

    walk(tree, kept, ())
    return prods, (np.concatenate(rest) if rest else np.zeros(0))


def _close_flat(kind, meta, got, want, keep, r, atol=ATOL):
    what = f"round {r}"
    bound = 4 * FED["server_lr"] * (r + 1)      # Adam steps of apart entries
    assert np.abs(got - want).max() <= bound, (what, bound)
    if kind != "two_stage_ortho":
        np.testing.assert_allclose(got[keep], want[keep], atol=atol,
                                   err_msg=what)
        return
    keepf = keep.astype(np.float32)
    (gp, gr), (wp, wr) = (pair_products(meta, got, keepf),
                          pair_products(meta, want, keepf))
    assert gp.keys() == wp.keys() and gp
    for path in gp:
        np.testing.assert_allclose(gp[path], wp[path], atol=atol,
                                   err_msg=f"{what} {path}")
    np.testing.assert_allclose(gr, wr, atol=atol, err_msg=what)


def _close_sstate(got, want, keep, what, atol=ATOL):
    assert got.keys() == want.keys(), what
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, bool):
            assert g == w, (what, k)
        elif w.dtype == np.bool_:
            overlap = float((g == w).mean())
            print(f"{what} sstate[{k}] overlap {overlap:.6f}")
            assert overlap >= OVERLAP, (what, k, overlap)
        elif w.shape == keep.shape:
            np.testing.assert_allclose(g[keep], w[keep], atol=atol,
                                       err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(g, w, atol=atol, err_msg=f"{what} {k}")


def download_masks_equal(jstrat, tstrat, flat0, sst0, jrun):
    """Each package's download mask from the same reference flat vector and
    state at the start of every round: bitwise equal."""
    starts = [(flat0, sst0)] + list(zip(jrun.flats, jrun.sstates))
    for r, (flat, sst) in enumerate(starts[:len(jrun.flats)]):
        want = jax.jit(lambda f, s, _r=r: jstrat.download_mask(f, s, _r))(
            jnp.asarray(flat), {k: jnp.asarray(v) for k, v in sst.items()})
        got = tstrat.download_mask(t_(flat), port_sstate(sst), r)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"round {r}")


def post_round_equal(jstrat, tstrat, flat, sst, r):
    """Each package's `post_round` of round `r` on the same reference flat
    vector and state (a pruning step computes its mask there): the new
    state and flat vector bitwise equal.  Returns the port's state."""
    jsst, jflat = jax.jit(lambda f, s: jstrat.post_round(
        s, f, P_base=f, m_down=None, round_idx=r))(
            jnp.asarray(flat), {k: jnp.asarray(v) for k, v in sst.items()})
    tsst, tflat = tstrat.post_round(port_sstate(sst), t_(flat), P_base=None,
                                    m_down=None, round_idx=r)
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    jsst, tsst = _np_state(jsst), _np_state(tsst)
    assert jsst.keys() == tsst.keys()
    for k in jsst:
        np.testing.assert_array_equal(tsst[k], jsst[k], err_msg=k)
    return tsst


def compare(kind, jrun, trun, meta, *, uploads=True, atol=ATOL):
    """The per-round comparisons of the module doc (`atol` in place of the
    flat vector's and the strategy state's 1e-6 where a test states
    another); returns the rounds whose upload masks agreed exactly."""
    jh, th = jrun.state.history, trun.state.history
    assert len(th) == len(jh) == len(trun.flats)
    exact = []
    apart = np.zeros(meta.p_len, bool)      # entries uploaded by one side
    for r in range(len(jh)):
        np.testing.assert_allclose(th[r]["loss"], jh[r]["loss"], rtol=RTOL)
        same = True
        if uploads:
            jm, tm_ = jrun.strat.kept[r] != 0, trun.strat.kept[r] != 0
            overlap = float((jm == tm_).mean())
            apart |= (jm != tm_).any(0)
            print(f"{kind} round {r}: upload-mask overlap {overlap:.6f}, "
                  f"{int(apart.sum())} entries apart so far")
            assert overlap >= OVERLAP, (r, overlap)
            same = overlap == 1.0
        if same:
            exact.append(r)
            for key in LEDGER_KEYS:
                assert th[r][key] == jh[r][key], (r, key)
        _close_flat(kind, meta, trun.flats[r], jrun.flats[r], ~apart, r, atol)
        _close_sstate(trun.sstates[r], jrun.sstates[r], ~apart, f"round {r}",
                      atol)
    return exact
