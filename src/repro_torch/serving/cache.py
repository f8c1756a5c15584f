"""Paged adapter cache: a fixed pool of device-resident adapter pages.

`HostAdapterStore` is the spill tier (host numpy, npz snapshots in the
training side's `checkpoint/io.py` format); `PagedAdapterCache` keeps a
fixed number of *pages* resident on the device and admits/evicts whole
adapters LRU-keyed by client id, with pin counts protecting the adapters
active decode lanes are using.  Same policy and counters as
`src/repro/serving/cache.py`.

Pool layout: every LoRA pair leaf gains a page axis at -3 --
'a' (lead..., G, d_in, r), 'b' (lead..., G, r, d_out) -- so the leading
layer axis still slices per layer and `paged_lora(pool, gidx)` turns the
pool plus per-lane page indices into the paged tree
`models/layers.py::linear` dispatches on.  Adapters whose rank is below
the pool rank are zero-padded (exact: the padded b rows are zero).
"""
from __future__ import annotations

import os
import re
from collections import OrderedDict
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.checkpoint import io as ckpt_io


def _is_pair(v) -> bool:
    return isinstance(v, dict) and {"a", "b"} <= set(v.keys())


def _map_pairs(tree, fn):
    """Apply fn to every {'a','b',...} pair node of a (nested-dict) lora
    tree, preserving the nesting."""
    return {k: (fn(v) if _is_pair(v) else _map_pairs(v, fn))
            for k, v in tree.items()}


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    return fn(tree)


def paged_lora(pool, gidx: torch.Tensor):
    """Pool tree + per-row page indices (B,) -> the paged lora tree that
    `linear` dispatches to the grouped-kernel registry.  The gidx leaf is
    broadcast (a view) to each pair's leading (layer) dims so it slices
    per layer alongside the stacked pool leaves."""
    def pair(v):
        g = torch.as_tensor(gidx, dtype=torch.int32, device=v["a"].device)
        lead = tuple(v["a"].shape[:-3])
        return {"a": v["a"], "b": v["b"], "gidx": g.expand(lead + tuple(g.shape))}

    return _map_pairs(pool, pair)


def page_lora(pool, page: int):
    """Slice one page out of the pool -> a standard single-adapter lora
    tree (the per-request prefill path: prefill and decode read the SAME
    pool values, so a rank-padded adapter is served identically by both)."""
    return _map_leaves(pool, lambda leaf: leaf[..., page, :, :])


def _pad_rank(pair: Dict[str, np.ndarray], rank: int) -> Dict[str, np.ndarray]:
    a, b = np.asarray(pair["a"]), np.asarray(pair["b"])
    r = a.shape[-1]
    if r > rank:
        raise ValueError(f"adapter rank {r} exceeds pool rank {rank}")
    if r < rank:
        a = np.concatenate(
            [a, np.zeros(a.shape[:-1] + (rank - r,), a.dtype)], axis=-1)
        b = np.concatenate(
            [b, np.zeros(b.shape[:-2] + (rank - r,) + b.shape[-1:], b.dtype)],
            axis=-2)
    return {"a": a, "b": b}


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class HostAdapterStore:
    """Host-resident adapter library: client id -> LoRA tree (numpy
    leaves).  The spill target the device cache misses into, and the
    bridge to disk: snapshots round-trip through the `save_pytree` npz
    format the training side writes."""

    def __init__(self):
        self._adapters: Dict[int, Any] = {}

    def put(self, client: int, lora) -> None:
        self._adapters[int(client)] = _map_leaves(lora, _host)

    def get(self, client: int):
        return self._adapters[int(client)]

    def __contains__(self, client) -> bool:
        return int(client) in self._adapters

    def __len__(self) -> int:
        return len(self._adapters)

    def clients(self):
        return sorted(self._adapters)

    # --- disk round-trip (training snapshot format) -------------------------
    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        for cid, lora in self._adapters.items():
            ckpt_io.save_pytree(lora,
                                os.path.join(directory, f"adapter_{cid}.npz"))

    @classmethod
    def load(cls, directory: str) -> "HostAdapterStore":
        store = cls()
        for name in sorted(os.listdir(directory)):
            m = re.fullmatch(r"adapter_(\d+)\.npz", name)
            if m:
                store._adapters[int(m.group(1))] = ckpt_io.load_pytree(
                    os.path.join(directory, name))
        return store


class PagedAdapterCache:
    """LRU admission/eviction of whole adapters over a fixed device pool.

    * `acquire(client)` -- pin the client's page for an active lane,
      uploading from the host store on a miss (evicting the
      least-recently-used unpinned adapter when the pool is full).
      Returns the page index, or None when every page is pinned by other
      clients (admission blocks until a lane retires).
    * `release(client)` -- drop one pin.
    * `stats()` -- hits / misses / evictions / resident counters.

    The pool stays on the device: a miss copies one page slot in place
    (`pool_leaf[..., p, :, :].copy_`, where the reference rebuilds the
    leaf), it never re-uploads the pool.
    """

    def __init__(self, store: HostAdapterStore, template, pages: int,
                 rank: Optional[int] = None, *, device: DeviceLike = None):
        """`template` is any adapter tree defining the pool leaf shapes;
        `rank` overrides the pool rank (adapters of smaller rank are
        zero-padded on upload)."""
        if pages < 1:
            raise ValueError(f"need at least one page, got {pages}")
        self.store = store
        self.pages = pages
        self.device = resolve_device(device)
        tmpl = _map_leaves(template, _host)

        def pool_pair(v):
            a, b = v["a"], v["b"]
            r = rank if rank is not None else a.shape[-1]
            dt = ckpt_io.tensor_dtype(a)
            return {
                "a": torch.zeros(a.shape[:-2] + (pages, a.shape[-2], r),
                                 dtype=dt, device=self.device),
                "b": torch.zeros(b.shape[:-2] + (pages, r) + b.shape[-1:],
                                 dtype=dt, device=self.device),
            }

        self.rank = rank if rank is not None else _first_pair_rank(tmpl)
        self.pool = _map_pairs(tmpl, pool_pair)
        self._lru: "OrderedDict[int, int]" = OrderedDict()   # client -> page
        self._pins: Dict[int, int] = {}                      # client -> count
        self._free = list(range(pages))
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # --- internals ----------------------------------------------------------
    def _write_page(self, lora, page: int) -> None:
        padded = _map_pairs(lora, lambda v: _pad_rank(v, self.rank))

        def write(pool_tree, new_tree):
            for k, v in pool_tree.items():
                if isinstance(v, dict):
                    write(v, new_tree[k])
                else:
                    src = ckpt_io.array_to_tensor(new_tree[k], dtype=v.dtype)
                    v[..., page, :, :].copy_(src)

        write(self.pool, padded)

    def _victim(self) -> Optional[int]:
        for cid in self._lru:                       # LRU order: oldest first
            if self._pins.get(cid, 0) == 0:
                return cid
        return None

    # --- the scheduler surface ----------------------------------------------
    def acquire(self, client: int) -> Optional[int]:
        client = int(client)
        if client in self._lru:
            self.hits += 1
            self._lru.move_to_end(client)
            self._pins[client] = self._pins.get(client, 0) + 1
            return self._lru[client]
        if self._free:
            page = self._free.pop()
        else:
            victim = self._victim()
            if victim is None:
                return None                          # every page is pinned
            page = self._lru.pop(victim)
            self._pins.pop(victim, None)
            self.evictions += 1
        self.misses += 1
        self._write_page(self.store.get(client), page)
        self._lru[client] = page
        self._pins[client] = 1
        return page

    def release(self, client: int) -> None:
        client = int(client)
        n = self._pins.get(client, 0)
        if n <= 0:
            raise ValueError(f"release of unpinned client {client}")
        self._pins[client] = n - 1

    # --- introspection ------------------------------------------------------
    def resident(self) -> int:
        return len(self._lru)

    def page_of(self, client: int) -> Optional[int]:
        return self._lru.get(int(client))

    def stats(self) -> Dict[str, float]:
        total = self.hits + self.misses
        return {"pages": self.pages, "resident": self.resident(),
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": self.hits / total if total else 0.0}


def _pair_ranks(tree):
    for v in tree.values():
        if _is_pair(v):
            yield int(np.asarray(v["a"]).shape[-1])
        elif isinstance(v, dict):
            yield from _pair_ranks(v)


def _first_pair_rank(tree) -> int:
    for r in _pair_ranks(tree):
        return r
    raise ValueError("template tree has no {'a','b'} LoRA pairs")
