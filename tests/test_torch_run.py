"""`benchmarks_torch/run.py` against the reference's `benchmarks/run.py`:
the port's runner calls the ported harnesses in the reference's order (the
reference's runner read from its source, so that none of its JAX harnesses
runs here), the serving sweep among them, leaving out only the harnesses
not ported yet (`kernels_bench`, `sharded_bench`).  Every harness's `main`
is replaced by a recorder, so the test runs no harness.
"""
import _torch_threads  # noqa: F401  (this process's share of the cores)
import ast
import os

import pytest

from benchmarks_torch import run as trun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOT_PORTED = ("kernels_bench", "sharded_bench")


def _reference_order():
    """The modules whose `main` the reference's runner calls, in order."""
    with open(os.path.join(ROOT, "benchmarks", "run.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "main")
    order = []
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "main"
                and isinstance(node.func.value, ast.Name)):
            order.append((node.lineno, node.func.value.id))
    return [name for _, name in sorted(order)]


def test_the_reference_runner_calls_the_serving_sweep():
    order = _reference_order()
    assert order[:2] == ["table1_partitions", "kernels_bench"]
    assert "serving_bench" in order and len(order) == 10


@pytest.mark.parametrize("device", [None, "cpu"])
def test_run_calls_the_ported_harnesses_in_the_reference_order(monkeypatch,
                                                               device):
    import importlib
    calls = []
    for name in _reference_order():
        if name in NOT_PORTED:
            continue
        mod = importlib.import_module(f"benchmarks_torch.{name}")

        def main(*args, _name=name, **kw):
            calls.append((_name, args, kw))
        monkeypatch.setattr(mod, "main", main)
    trun.main(device=device)
    want = [n for n in _reference_order() if n not in NOT_PORTED]
    assert [c[0] for c in calls] == want
    # every harness but table1 (which builds no model) runs on `device`
    for name, args, kw in calls:
        assert args == ()
        assert kw == ({} if name == "table1_partitions" else
                      {"device": device}), name
    assert "serving_bench" in [c[0] for c in calls]
