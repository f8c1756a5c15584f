"""Federated dataset partitioning: the numpy copy of
`src/repro/data/partition.py`.

Dirichlet label partition (Hsu et al.) for the CIFAR10 / 20NewsGroups
analogues, and natural per-user partition for the Reddit / FLAIR
analogues.  Host-side numpy, deterministic under a seed.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        seed: int = 0, min_size: int = 2) -> List[np.ndarray]:
    """Per-client index lists with Dirichlet(alpha) label mixtures."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    while True:
        idx_by_client = [[] for _ in range(n_clients)]
        for c in range(n_classes):
            idx_c = np.where(labels == c)[0]
            rng.shuffle(idx_c)
            props = rng.dirichlet(np.full(n_clients, alpha))
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for i, part in enumerate(np.split(idx_c, cuts)):
                idx_by_client[i].extend(part.tolist())
        sizes = [len(x) for x in idx_by_client]
        if min(sizes) >= min_size:
            break
        alpha *= 1.5  # retry with a smoother mixture to avoid empty clients
    return [np.asarray(sorted(x), np.int64) for x in idx_by_client]


def natural_partition(user_ids: np.ndarray) -> List[np.ndarray]:
    users = np.unique(user_ids)
    return [np.where(user_ids == u)[0] for u in users]


def label_heterogeneity(parts: Sequence[np.ndarray], labels: np.ndarray) -> float:
    """Mean max-label fraction per client (1.0 = fully skewed)."""
    fracs = []
    for p in parts:
        if len(p) == 0:
            continue
        counts = np.bincount(labels[p])
        fracs.append(counts.max() / counts.sum())
    return float(np.mean(fracs))
