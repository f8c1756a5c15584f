"""What scripts/flash_ab.py and scripts/pack_ab.py share: take LABEL=CSRC
arguments, build one CUDA source of each tree side by side with the port's
nvcc flags, print the ptxas report of the kernels asked for, and time
callables label by label in A B B A turns.

CSRC is a directory holding the source and the headers it includes, such
as a checkout's src/repro_torch/csrc (an older commit unpacked with `git
archive` into a directory that .gitignore lists).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs                                    # noqa: E402


def trees(doc: str, source: str):
    """{label: csrc dir} from the command line, after printing the card's
    name and power limit; None where there is no CUDA device."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", metavar="LABEL=CSRC")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return None
    srcs = {}
    for tree in args.trees:
        label, _, path = tree.partition("=")
        cs.check(bool(label) and os.path.isfile(os.path.join(path, source)),
                 f"{tree!r}: want LABEL=DIR with DIR/{source}")
        srcs[label] = Path(path).resolve()
    print(json.dumps({"card": cs.card_line(),
                      "device": torch.cuda.get_device_name(0)}))
    return srcs


def build(srcs: dict, source: str, reported) -> dict:
    """{label: csrc dir} -> {label: loaded library} of csrc/<source>, one
    nvcc a tree, all started together, into build/<source stem>_ab/.  Prints
    the ptxas report of each kernel whose name `reported` accepts, every
    compiler warning, and the log's end where a tree does not build (that
    label is then left out)."""
    from repro_torch.kernels import _build
    stem = source.removesuffix(".cu")
    out_dir = ROOT / "build" / f"{stem}_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, csrc in srcs.items():
        lib = out_dir / f"{label}-{_build.library_path(stem, csrc).name}"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
               str(csrc / source)]
        procs[label] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(json.dumps({"label": label, "nvcc_failed": log[-4000:]}))
            continue
        for name, report in cs.ptxas_kernels(log):
            if reported(name):
                print(json.dumps({"label": label, "kernel": name,
                                  "ptxas": report}))
        warn = [ln.strip() for ln in log.splitlines()
                if "warning" in ln.lower() or
                "Potential Performance Loss" in ln]
        if warn:
            print(json.dumps({"label": label, "warnings": warn}))
        libs[label] = ctypes.CDLL(str(lib))
    return libs


def abba(labels: list, call, iters: int, turns: int) -> dict:
    """{label: [device ms per call]}: chip_smoke.device_ms of `call(label,
    i)` for each label in the order given and then reversed, `turns`
    times."""
    ms = {label: [] for label in labels}
    for _ in range(turns):
        for label in labels + labels[::-1]:
            ms[label].append(cs.device_ms(
                lambda i, label=label: call(label, i), iters))
    return ms
