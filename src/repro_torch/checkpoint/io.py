"""Pytree checkpoints in the reference's npz format, and weight conversion.

`save_pytree` / `load_pytree` read and write the format of
`src/repro/checkpoint/io.py`: one npz whose keys are '/'-joined tree paths
plus a `__manifest__` entry.  They are numpy only; leaves may be numpy
arrays, tensors or host scalars.  A bf16 tensor is written as its bits in
a raw 2-byte void dtype (`V2`), the dtype the reference's `np.savez` gives
an `ml_dtypes` bfloat16 array, so both packages read it back.  A host
bool or int (the round index `server["round"]`, the sparse adapter's
`initialized`) is written as the 0-d bool or int32 array the reference
holds under the same key; `restore_like` turns it back into a host scalar.

`save_experiment_checkpoint` / `load_experiment_checkpoint` are the
reference's resumable experiment snapshot: a run-constant `frozen.npz`
(backbone and task arrays), a round-stamped `state-r<N>.npz` and a
`meta.json` sidecar that names it.

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
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike


BF16_NP = np.dtype("V2")       # how an npz holds a bfloat16 leaf


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(BF16_NP)
        return v.numpy()
    if isinstance(v, (bool, np.bool_)):
        return np.asarray(v, np.bool_)
    if isinstance(v, int):
        return np.asarray(v, np.int32)
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
    # np.ascontiguousarray makes a 0-d array 1-d: keep the shape
    arr = np.ascontiguousarray(arr).reshape(arr.shape)
    if _is_bf16(arr):
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
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


def restore_like(tree, like):
    """A `load_pytree` subtree (nested dicts of numpy arrays) in the form of
    `like` (nested dicts): tensor leaves become tensors of `like`'s dtype on
    its device (shapes checked), host bools and ints come back as host
    scalars."""
    if isinstance(like, dict):
        missing = set(like) - set(tree)
        if missing:
            raise KeyError(f"checkpoint missing {sorted(missing)}")
        return {k: restore_like(tree[k], v) for k, v in like.items()}
    arr = np.asarray(tree)
    if isinstance(like, torch.Tensor):
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"shape {arr.shape} != {tuple(like.shape)}")
        return array_to_tensor(arr, like.device, like.dtype)
    if isinstance(like, bool):
        return bool(arr)
    if isinstance(like, int):
        return int(arr)
    return arr


def save_server_round(flatP, server_state, sstate, path: str) -> None:
    save_pytree({"P": flatP, "server": server_state, "strategy": sstate}, path)


def load_server_round(path: str, like=None):
    """-> (P, server, strategy); with `like` a (P, server, strategy) triple
    of the port's state, each part in its form (`restore_like`), else the
    numpy trees."""
    tree = load_pytree(path)
    tree.setdefault("strategy", {})     # a stateless strategy saves nothing
    parts = (tree["P"], tree["server"], tree["strategy"])
    if like is None:
        return parts
    return tuple(restore_like(t, l) for t, l in zip(parts, like))


# ---------------------------------------------------------------------------
# experiment checkpoints (engine CheckpointCallback / Experiment.resume)
# ---------------------------------------------------------------------------

FROZEN_FILE = "frozen.npz"
META_FILE = "meta.json"


def _atomic_save_pytree(tree: Any, path: str) -> None:
    """`save_pytree` through a same-directory temporary file and a rename,
    so a crash mid-write never leaves a torn payload."""
    tmp = path[:-len(".npz")] + ".tmp.npz"      # np.savez keeps .npz names
    save_pytree(tree, tmp)
    os.replace(tmp, path)


def save_experiment_checkpoint(directory: str, arrays: Any,
                               meta: Dict[str, Any], frozen: Any = None,
                               overwrite_frozen: bool = False) -> str:
    """One resumable snapshot: a round-stamped npz payload (weights,
    server and strategy state, engine state) plus a JSON sidecar with
    everything that is not an array (configs, history, ledger, next round).

    Crash consistency, in the reference's order: the frozen payload (only
    when absent, or on a fresh run's first save with `overwrite_frozen`,
    which first removes the old sidecar so old state is never paired with
    new frozen arrays), then the round-stamped state, then the sidecar by
    rename, then the pruning of older state files.  A kill at any point
    leaves a complete (payload, sidecar) pair.  Returns the payload path."""
    os.makedirs(directory, exist_ok=True)
    frozen_path = os.path.join(directory, FROZEN_FILE)
    if frozen is not None and (overwrite_frozen
                               or not os.path.exists(frozen_path)):
        if overwrite_frozen:
            meta_path = os.path.join(directory, META_FILE)
            if os.path.exists(meta_path):
                os.remove(meta_path)
        _atomic_save_pytree(frozen, frozen_path)
    state_file = f"state-r{int(meta['round'])}.npz"
    _atomic_save_pytree(arrays, os.path.join(directory, state_file))
    meta = dict(meta, state_file=state_file)
    tmp = os.path.join(directory, META_FILE + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(directory, META_FILE))
    for name in os.listdir(directory):          # prune superseded payloads
        if (name.startswith("state-") and name.endswith(".npz")
                and name != state_file):
            os.remove(os.path.join(directory, name))
    return os.path.join(directory, state_file)


def load_experiment_checkpoint(directory: str) -> Tuple[Dict[str, Any],
                                                        Dict[str, Any]]:
    """-> (arrays as nested dicts of numpy arrays, the frozen payload's
    included; the meta dict)."""
    meta_path = os.path.join(directory, META_FILE)
    if not os.path.exists(meta_path):
        raise FileNotFoundError(f"no checkpoint under {directory}")
    with open(meta_path) as f:
        meta = json.load(f)
    arrays = load_pytree(os.path.join(directory, meta["state_file"]))
    frozen_path = os.path.join(directory, FROZEN_FILE)
    if os.path.exists(frozen_path):
        arrays.update(load_pytree(frozen_path))
    return arrays, meta
