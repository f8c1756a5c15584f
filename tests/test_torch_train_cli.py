"""The port's training CLI (`repro_torch.launch.train`) on the CPU against
the reference's (`repro.launch.train --engine sim`), both run in this
process on the reduced Yi-9B config: the synthetic client batches are the
reference's numpy stream bit for bit, and the printed traffic lines
(`traffic:` and `per client per round:`, byte counts of Top-K messages
whose sizes do not depend on the weights) are the reference's exactly.
Unknown strategy kinds, the sharded engine, --mesh / --fsdp and
--dry-run / --multi-pod are refused with the ROADMAP item that ports them.
"""
import _torch_threads  # noqa: F401  (this process's share of the cores)
import sys

import numpy as np
import pytest
import torch

from repro.federated import api as japi
from repro.launch import train as jtrain
from repro_torch.federated import api as tapi
from repro_torch.launch import train as ttrain


def _recording(monkeypatch, api, seen):
    """Wrap `Experiment.with_data` so every batch handed to the engine is
    kept (as numpy)."""
    orig = api.Experiment.with_data

    def with_data(self, provider):
        def rec(r):
            b = provider(r)
            seen.append({k: np.array(v) for k, v in b.items()})
            return b
        return orig(self, rec)
    monkeypatch.setattr(api.Experiment, "with_data", with_data)


def _traffic(out):
    return [ln for ln in out.splitlines()
            if "traffic:" in ln or "per client per round:" in ln]


def test_smoke_cli_prints_the_reference_traffic(monkeypatch, capsys):
    jseen, tseen = [], []
    _recording(monkeypatch, japi, jseen)
    _recording(monkeypatch, tapi, tseen)
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "yi-9b",
                                      "--rounds", "2", "--engine", "sim"])
    jtrain.main()
    jout = capsys.readouterr().out
    res = ttrain.main(["--arch", "yi-9b", "--smoke", "--device", "cpu",
                       "--rounds", "2"])
    tout = capsys.readouterr().out
    print(jout, tout)
    assert len(_traffic(tout)) == 2
    assert _traffic(tout) == _traffic(jout)
    assert "[train] yi-9b (reduced: 2L d128) strategy=flasc d=0.25 r=8 " \
        "engine=sim" in tout
    assert "[train] done after 2 rounds; final loss=" in tout
    assert all(np.isfinite(h["loss"]) for h in res.history)
    assert len(jseen) == len(tseen) == 2
    for a, b in zip(tseen, jseen):
        assert a.keys() == b.keys() == {"tokens"}
        assert a["tokens"].dtype == b["tokens"].dtype == np.int32
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_unknown_strategy_names_the_known_kinds():
    with pytest.raises(ValueError, match="known: .*flasc"):
        ttrain.main(["--arch", "yi-9b", "--smoke", "--device", "cpu",
                     "--rounds", "1", "--strategy", "nope"])


@pytest.mark.parametrize("flags,item", [
    (["--mesh", "2x2"], "item 8"),
    (["--fsdp"], "item 8"),
    (["--engine", "sharded"], "item 8"),
    (["--dry-run"], "item 9"),
    (["--dry-run", "--multi-pod"], "item 9"),
])
def test_unported_flags_name_their_roadmap_item(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        ttrain.main(["--arch", "yi-9b", "--smoke", "--device", "cpu",
                     "--rounds", "1"] + flags)


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--arch", "yi-9b", "--smoke", "--rounds", "1"])
    args = ttrain.parse_args(["--arch", "yi-9b"])
    assert (args.engine, args.rounds_per_call, args.smoke) == ("sim", 1,
                                                              False)
