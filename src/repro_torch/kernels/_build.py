"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by
`nvcc` into `build/repro_torch/lib<name>-<hash>.so` at the root of the
checkout, at first use.  The hash covers the source and the flags, so an
edited source rebuilds and a stale library is never loaded.  Libraries are
loaded with `ctypes`; the wrappers in `kernels/*.py` declare every pointer
and the stream as `c_void_p`.

`CudaFunction` binds one C entry point of a library and counts its
launches; every kernel wrapper of the port holds one.

Nothing here runs on import: the CPU tests import every module, and a
host without `nvcc` only fails when a kernel is actually asked for.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# no --use_fast_math: the kernels keep IEEE f32 division and rounding.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Names of every kernel source under csrc/."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit PyTorch found."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    from torch.utils import cpp_extension
    if cpp_extension.CUDA_HOME:
        cands.append(os.path.join(cpp_extension.CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to "
                       "build the repro_torch CUDA kernels")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str] = ()) -> Dict[str, Path]:
    """Compile the named sources (all of csrc/ when none are named) that
    are not built yet, one `nvcc` process per source, all started
    together.  Returns {name: library path}; raises with the compiler's
    output if any build fails.  The compiler's report (registers, shared
    memory, spills) is kept beside each library as `<lib>.log`."""
    names = list(names) or sources()
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        todo[n].with_suffix(".so.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {n}.cu (exit {proc.returncode}) ---\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[n])      # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build([name])[name]))
    return _LOADED[name]


class CudaFunction:
    """One C entry point of `csrc/<source>.cu`: `int symbol(args..., void*
    stream)`, returning `cudaGetLastError()`.  Bound with ctypes at its
    first call (building the source if needed); `launches` counts the
    successful launches and nothing else adds to it."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]
        self.launches = 0
        self._fn = None

    def __call__(self, device: torch.device, *args) -> None:
        """Launch on `device`'s current stream; raises if the launch is
        refused.  Does not synchronise."""
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = self._fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error {rc}")
        self.launches += 1
