"""The port stands alone: it never imports jax or the reference package, and
its entry points default to the card rather than silently running on the
CPU."""
import _torch_threads  # noqa: F401  (this process's share of the cores)
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
HARNESS = os.path.join(ROOT, "benchmarks_torch")


def test_import_leaves_jax_out():
    code = ("import sys, repro_torch, repro_torch.serving, "
            "repro_torch.launch.serve, repro_torch.kernels.lora_matmul, "
            "repro_torch.checkpoint.io, repro_torch.core, "
            "repro_torch.core.fedround, repro_torch.core.selectors, "
            "repro_torch.core.transport, repro_torch.federated, "
            "repro_torch.optim, repro_torch.kernels.fused_transport, "
            "repro_torch.kernels.topk_mask, repro_torch.federated.engine, "
            "repro_torch.federated.async_clock, repro_torch.core.strategies, "
            "repro_torch.kernels.ops, repro_torch.kernels.ref, "
            "repro_torch.kernels.flash_attention, "
            "repro_torch.models.attention, repro_torch.data, "
            "repro_torch.data.datasets, repro_torch.data.partition, "
            "repro_torch.data.pipeline, repro_torch.federated.runtime, "
            "repro_torch.configs.paper_models, repro_torch.core.dp, "
            "repro_torch.federated.population, repro_torch.federated.api, "
            "repro_torch.launch.train, "
            "benchmarks_torch.population_bench, "
            "benchmarks_torch.run, benchmarks_torch.fig2_comm_efficiency, "
            "benchmarks_torch.fig3_async_bandwidth, "
            "benchmarks_torch.fig4_freezing, "
            "benchmarks_torch.fig5_heterogeneity, "
            "benchmarks_torch.fig6_system_het, benchmarks_torch.fig7_privacy, "
            "benchmarks_torch.table1_partitions, "
            "benchmarks_torch.pretrain_sweep, "
            "repro_torch.configs.registry, repro_torch.configs.gemma_7b, "
            "repro_torch.configs.minitron_8b, repro_torch.configs.qwen3_32b, "
            "repro_torch.models.lora, benchmarks_torch.serving_bench; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'repro.', 'benchmarks.')) "
            "or m in ('repro', 'benchmarks')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]))
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
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "scripts", "ab_trees.py"),
             os.path.join(ROOT, "scripts", "flash_ab.py"),
             os.path.join(ROOT, "scripts", "pack_ab.py"),
             os.path.join(ROOT, "scripts", "flash_bwd_ab.py"),
             os.path.join(ROOT, "examples", "quickstart_torch.py"),
             os.path.join(ROOT, "examples", "federated_finetune_torch.py"),
             os.path.join(ROOT, "examples", "serve_lora_torch.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    # the port's figure harnesses: neither the reference package nor the
    # reference's harnesses (`benchmarks/`)
    harness = [os.path.join(HARNESS, n) for n in sorted(os.listdir(HARNESS))
               if n.endswith(".py")]
    assert {"common.py", "fig2_comm_efficiency.py", "fig7_privacy.py",
            "run.py"} <= {os.path.basename(p) for p in harness}
    files += harness
    assert len(files) > 10
    # the numpy-only modules the port copies from the reference too
    assert os.path.join(PORT, "federated", "async_clock.py") in files
    assert os.path.join(PORT, "kernels", "ref.py") in files
    assert os.path.join(PORT, "kernels", "ops.py") in files
    assert os.path.join(PORT, "core", "dp.py") in files
    assert os.path.join(PORT, "federated", "population.py") in files
    assert os.path.join(PORT, "launch", "train.py") in files
    assert os.path.join(HARNESS, "population_bench.py") in files
    for name in ("datasets.py", "partition.py", "pipeline.py"):
        assert os.path.join(PORT, "data", name) in files
    for path in files:
        bad = {m for m in _imported_roots(path)
               if m in ("jax", "jaxlib", "repro", "flax", "optax",
                        "benchmarks")}
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
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "yi-9b", "--smoke", "--rounds", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "gemma-7b", "--smoke", "--window", "8"])
    from benchmarks_torch import serving_bench
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving_bench.main([])
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "serve_lora_torch", os.path.join(ROOT, "examples",
                                         "serve_lora_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        example.main([])
    from repro_torch.data import make_synth_image
    from repro_torch.federated import Experiment
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Experiment(None)
    task = make_synth_image(n_examples=32, n_clients=4, n_patches=2, dim=8,
                            n_eval=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Experiment(task)
    env = dict(os.environ, QUICK="1", PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "quickstart_torch.py")],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr, \
        proc.stdout + proc.stderr
