"""Pytree checkpoints in the reference's npz format, and weight conversion.

`save_pytree` / `load_pytree` read and write the format of
`src/repro/checkpoint/io.py`: one npz whose keys are '/'-joined tree paths
plus a `__manifest__` entry.  They are numpy only; leaves may be numpy
arrays or tensors.

`tree_from_numpy` / `load_reference` turn the reference package's params
or LoRA tree (`jax.tree.map(np.asarray, tree)`, or an npz written by
`save_pytree`) into the port's tensors with the same keys, shapes and
dtypes.  bf16 leaves arrive as the `ml_dtypes` bfloat16 dtype (or as a
raw 2-byte void dtype from an npz), which `torch.from_numpy` refuses:
their bits are viewed as uint16 and reinterpreted as torch.bfloat16.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import DeviceLike


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            raise TypeError("save_pytree stores numpy dtypes; cast bf16 "
                            "tensors to float32 first")
        return v.numpy()
    return np.asarray(v)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def save_pytree(tree: Any, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {k: _to_numpy(v) for k, v in _flatten(tree)}
    manifest = {"keys": sorted(payload.keys())}
    np.savez(path, __manifest__=json.dumps(manifest), **payload)


def load_pytree(path: str) -> Dict[str, Any]:
    """-> nested dict of numpy arrays (tuples come back as dicts keyed
    '0', '1', ..., as in the reference without a `like` tree)."""
    with np.load(path, allow_pickle=False) as z:
        payload = {k: z[k] for k in z.files if k != "__manifest__"}
    out: Dict[str, Any] = {}
    for key, arr in payload.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return out


def _is_bf16(arr: np.ndarray) -> bool:
    return arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V"
                                           and arr.dtype.itemsize == 2)


def tensor_dtype(arr: np.ndarray) -> torch.dtype:
    """The torch dtype a numpy leaf converts to."""
    if _is_bf16(arr):
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, arr.dtype)).dtype


def array_to_tensor(arr, device: DeviceLike = "cpu",
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    arr = np.asarray(arr)
    if not arr.flags.writeable:      # e.g. a view of a JAX buffer: own a copy
        arr = arr.copy()
    if _is_bf16(arr):
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def tree_from_numpy(tree, *, device: DeviceLike, dtype: Optional[torch.dtype] = None):
    """Nested dict/tuple of numpy arrays -> the same tree of tensors on
    `device`; `dtype` recasts floating leaves."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device=device, dtype=dtype)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_from_numpy(v, device=device, dtype=dtype)
                          for v in tree)
    return array_to_tensor(tree, device, dtype)


def load_reference(path: str, device: DeviceLike):
    """npz written by the reference's `save_pytree` -> port tensors."""
    return tree_from_numpy(load_pytree(path), device=device)
