"""The port stands alone: it never imports jax or the reference package, and
its entry points default to the card rather than silently running on the
CPU."""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")


def test_import_leaves_jax_out():
    code = ("import sys, repro_torch, repro_torch.serving, "
            "repro_torch.launch.serve, repro_torch.kernels.lora_matmul, "
            "repro_torch.checkpoint.io, repro_torch.core, "
            "repro_torch.core.fedround, repro_torch.core.selectors, "
            "repro_torch.core.transport, repro_torch.federated, "
            "repro_torch.optim, repro_torch.kernels.fused_transport, "
            "repro_torch.kernels.topk_mask, repro_torch.federated.engine, "
            "repro_torch.federated.async_clock, repro_torch.core.strategies; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'repro.')) or m == 'repro'); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_port_file_imports_jax_or_repro():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    # the numpy-only modules the port copies from the reference too
    assert os.path.join(PORT, "federated", "async_clock.py") in files
    for path in files:
        bad = {m for m in _imported_roots(path)
               if m in ("jax", "jaxlib", "repro", "flax", "optax")}
        assert not bad, (os.path.relpath(path, ROOT), bad)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from repro_torch import resolve_device
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as mdl
    from repro_torch.models.layers import init_params
    from repro_torch.serving import (HostAdapterStore, PagedAdapterCache,
                                     ServingEngine)

    cfg = get_config("yi-9b", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(mdl.model_spec(cfg))
    params = init_params(mdl.model_spec(cfg), device="cpu")
    store = HostAdapterStore()
    store.put(0, {"g0": {"attn": {"wq": {"a": torch.zeros(2, 128, 4),
                                         "b": torch.zeros(2, 4, 128)}}}})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedAdapterCache(store, store.get(0), pages=1)
    cache = PagedAdapterCache(store, store.get(0), pages=1, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(params, cfg, cache)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "yi-9b", "--smoke"])
    from repro_torch.federated import Experiment
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Experiment(None)
