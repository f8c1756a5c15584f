"""Client sampling and batch assembly for federated rounds: the numpy
copy of `src/repro/data/pipeline.py`.

`sample_round` follows the paper's protocol: each round samples
`n_clients` clients uniformly without replacement; each client runs
`local_steps` steps of `local_batch` examples over a local shuffle of its
data (cycling when the client has fewer examples).  Leaves are shaped
(n_clients, local_steps, local_batch, ...), what the round consumes.
Arrays stay numpy; the caller moves them to its device.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.data.datasets import FederatedTask
from repro_torch.models.config import FederatedConfig


def sample_round(task: FederatedTask, fed: FederatedConfig, round_idx: int,
                 seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(hash((seed, round_idx)) % (2 ** 31))
    clients = rng.choice(task.n_clients, size=fed.n_clients, replace=False)
    need = fed.local_steps * fed.local_batch
    batch: Dict[str, list] = {k: [] for k in task.data}
    for c in clients:
        idx = task.parts[c]
        order = rng.permutation(len(idx))
        take = idx[np.resize(order, need)]           # cycle if short
        for k, v in task.data.items():
            batch[k].append(v[take].reshape(fed.local_steps, fed.local_batch,
                                            *v.shape[1:]))
    return {k: np.stack(v) for k, v in batch.items()}


def eval_batches(task: FederatedTask, batch_size: int = 128):
    n = len(next(iter(task.eval_data.values())))
    for i in range(0, n - batch_size + 1, batch_size):
        yield {k: v[i:i + batch_size] for k, v in task.eval_data.items()}
