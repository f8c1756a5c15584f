"""Serving a model with learned positions (GPT-2 Small's family) against
the reference, on the CPU at GPT-tiny's size (2 layers, d 64, 256
positions, f32), on weights converted from the reference and LoRA
adapters drawn from a seed.

The reference's `decode_step` adds position 0's embedding to every token
(ROADMAP queue 3, quirk 5(a)); the port adds each row's own position's.
So the port is held to the reference's `forward` over the whole sequence
at the same positions, not to its decode:
  - `prefill`, then `decode_step` with a shared position and with
    per-lane positions (lanes at different lengths in one batch cache):
    every step's logits within rtol = atol = 1e-5 of the reference
    forward's last logits (the two packages' CPU matmuls round in other
    places);
  - a `ServingEngine` run: each completion equals a greedy loop over the
    reference's `forward`, except after a step whose top-2 logit gap in
    the reference is below 1e-4 (printed);
  - an engine whose max_len passes the learned positions raises, with or
    without a window; the ViT (embedding inputs, classifier head) is
    still refused by name.
"""
import _torch_threads  # noqa: F401  (this process's share of the cores)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_models as jpm
from repro.models import layers as JL
from repro.models import lora as jax_lora
from repro.models import model as JM
from repro.models.config import LoRAConfig as JLoRAConfig
from repro_torch import serving as TS
from repro_torch.checkpoint.io import tree_from_numpy
from repro_torch.configs import paper_models as tpm
from repro_torch.models import model as TM
from repro_torch.models.layers import zeros_from_spec

CFG, TCFG = jpm.GPT_TINY, tpm.GPT_TINY
TOL = dict(rtol=1e-5, atol=1e-5)
GAP_TOL = 1e-4
N_ADAPTERS = 4


@pytest.fixture(scope="module")
def weights():
    """The reference's GPT-tiny with learned positions drawn at unit scale
    (so that a row at the wrong position shows in its logits), and
    N_ADAPTERS rank-4 adapters with nonzero b."""
    assert CFG.use_learned_pos and dataclasses.asdict(CFG) == \
        dataclasses.asdict(TCFG)
    params = jax.tree.map(np.asarray, jax.jit(lambda k: JL.init_params(
        JM.model_spec(CFG), k))(jax.random.key(0)))
    rng = np.random.default_rng(1)
    params["pos_embed"] = rng.standard_normal(
        params["pos_embed"].shape).astype(np.float32)
    lcfg = JLoRAConfig(rank=4, alpha=8.0, dtype="float32")
    spec = jax_lora.lora_spec(CFG, lcfg)
    adapters = {c: jax.tree.map(
        lambda p: rng.standard_normal(p.shape, dtype=np.float32)
        * np.float32(0.1), spec, is_leaf=lambda x: isinstance(x, JL.P))
        for c in range(N_ADAPTERS)}
    return params, lcfg, adapters


def _ref_logits(params, lcfg, lora, seq):
    """The reference forward's logits (B, S, V) over seq (B, S): causal, so
    position p's depend on tokens 0..p alone."""
    return np.asarray(JM.forward(params, CFG, {"tokens": jnp.asarray(seq)},
                                 lora=lora, lora_scale=lcfg.scale)["logits"])


def test_prefill_and_decode_at_a_shared_position_match_reference_forward(
        weights):
    params, lcfg, adapters = weights
    tp = tree_from_numpy(params, device="cpu")
    tl = tree_from_numpy(adapters[0], device="cpu")
    S, gen = 7, 5
    seq = np.random.default_rng(2).integers(0, CFG.vocab_size, (2, S + gen))
    want = _ref_logits(params, lcfg, adapters[0], seq)
    with torch.no_grad():
        lg, cache = TM.prefill(
            tp, TCFG, {"tokens": torch.from_numpy(seq[:, :S])}, lora=tl,
            lora_scale=lcfg.scale, max_len=S + gen)
    np.testing.assert_allclose(lg[:, 0].numpy(), want[:, S - 1], **TOL)
    for i in range(gen - 1):
        with torch.no_grad():
            lg, cache = TM.decode_step(
                tp, TCFG, torch.from_numpy(seq[:, S + i]),
                torch.tensor(S + i), cache, lora=tl, lora_scale=lcfg.scale)
        np.testing.assert_allclose(lg[:, 0].numpy(), want[:, S + i], **TOL,
                                   err_msg=f"step {i}")
    # the reference's own decode adds position 0's embedding instead: it
    # leaves its forward, which the port follows
    jcache = JM.prefill(params, CFG, {"tokens": jnp.asarray(seq[:, :S])},
                        lora=adapters[0], lora_scale=lcfg.scale,
                        max_len=S + gen)[1]
    jlg, _ = JM.decode_step(params, CFG, jnp.asarray(seq[:, S]),
                            jnp.int32(S), jcache, lora=adapters[0],
                            lora_scale=lcfg.scale)
    assert not np.allclose(np.asarray(jlg)[:, 0], want[:, S], **TOL)


def test_decode_at_per_lane_positions_matches_reference_forward(weights):
    # lanes prefilled alone at 5 and 11 tokens into one batch cache, then
    # decoded together, each at its own position (a (B,) pos), each with
    # its own adapter through the paged pool
    params, lcfg, adapters = weights
    tp = tree_from_numpy(params, device="cpu")
    store = TS.HostAdapterStore()
    for c, lt in adapters.items():
        store.put(c, lt)
    pool = TS.PagedAdapterCache(store, store.get(0), pages=2, device="cpu")
    clients = (1, 3)
    pages = [pool.acquire(c) for c in clients]
    max_len, gen = 16, 4
    rng = np.random.default_rng(3)
    seqs = [rng.integers(0, CFG.vocab_size, (1, n + gen)) for n in (5, 11)]
    want = [_ref_logits(params, lcfg, adapters[c], s)[0]
            for c, s in zip(clients, seqs)]
    batch = zeros_from_spec(TM.cache_spec(TCFG, 2, max_len), "cpu")
    pos = []
    with torch.no_grad():
        for lane, (seq, page) in enumerate(zip(seqs, pages)):
            n = seq.shape[1] - gen
            lg, row = TM.prefill(
                tp, TCFG, {"tokens": torch.from_numpy(seq[:, :n])},
                lora=TS.page_lora(pool.pool, page), lora_scale=lcfg.scale,
                max_len=max_len)
            np.testing.assert_allclose(lg[0, -1].numpy(), want[lane][n - 1],
                                       **TOL)
            TS.ServingEngine._write_lane(batch, row, lane)
            pos.append(n)
    gidx = torch.tensor(pages, dtype=torch.int32)
    for i in range(gen - 1):
        toks = torch.tensor([int(s[0, p]) for s, p in zip(seqs, pos)])
        with torch.no_grad():
            lg, batch = TM.decode_step(
                tp, TCFG, toks, torch.tensor(pos), batch,
                lora=TS.paged_lora(pool.pool, gidx), lora_scale=lcfg.scale)
        for lane in range(2):
            np.testing.assert_allclose(lg[lane, 0].numpy(),
                                       want[lane][pos[lane]], **TOL,
                                       err_msg=f"step {i}, lane {lane}")
        pos = [p + 1 for p in pos]


def _engine(params, lcfg, adapters, **kw):
    store = TS.HostAdapterStore()
    for c, lt in adapters.items():
        store.put(c, lt)
    cache = TS.PagedAdapterCache(store, store.get(0), pages=2, device="cpu")
    return TS.ServingEngine(tree_from_numpy(params, device="cpu"), TCFG,
                            cache, n_lanes=2, lora_scale=lcfg.scale,
                            device="cpu", **kw)


def test_engine_matches_a_greedy_loop_over_reference_forward(weights):
    # the greedy loop over the reference's forward picks, at each step, the
    # argmax of the forward over the tokens so far; so a completion equals
    # it exactly when each of its tokens is the argmax of one reference
    # forward over the prompt and the completion itself, at its position
    params, lcfg, adapters = weights
    trace = TS.synth_trace(6, N_ADAPTERS, CFG.vocab_size, seed=3,
                           prompt_buckets=(4, 9), gen_range=(2, 6))
    rep = _engine(params, lcfg, adapters, max_len=16).run(trace)
    assert len(rep.completions) == len(trace) and rep.steps > 0
    for req in trace:
        got = rep.completions[req.rid]
        assert len(got) == req.gen_len
        seq = np.asarray([list(req.prompt) + got[:-1]])
        lg = _ref_logits(params, lcfg, adapters[req.client], seq)[0]
        lg = lg[req.prompt_len - 1:]
        for i, tok in enumerate(got):
            if tok != int(lg[i].argmax()):
                # a near tie in the reference may turn either way; the
                # greedy loop leaves this completion here
                top2 = np.sort(lg[i])[-2:]
                gap = float(top2[1] - top2[0])
                print(f"request {req.rid}: token {i} differs, reference "
                      f"top-2 gap {gap:.3e}")
                assert gap < GAP_TOL, (req.rid, i, got, gap)
                break


def test_engine_refuses_max_len_past_the_learned_positions(weights):
    params, lcfg, adapters = weights
    assert _engine(params, lcfg, adapters, max_len=CFG.max_seq).max_len \
        == CFG.max_seq
    for window in (None, 8):
        with pytest.raises(ValueError, match="gpt-tiny: max_len 257"):
            _engine(params, lcfg, adapters, max_len=CFG.max_seq + 1,
                    window=window)


def test_serving_still_refuses_the_vit_by_name():
    with pytest.raises(NotImplementedError,
                       match="vit-tiny: the port does not serve embedding "
                             "inputs, classifier head"):
        TM.check_servable(tpm.VIT_TINY)
    TM.check_servable(tpm.GPT_TINY)
    TM.check_servable(tpm.GPT2_SMALL)
