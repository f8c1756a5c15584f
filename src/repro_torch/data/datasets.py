"""Deterministic synthetic federated tasks: the numpy copy of
`src/repro/data/datasets.py` (same arrays, bit for bit, from the same
seed).  Nothing is downloaded.  Each task mirrors the *shape* of one of
the paper's four datasets:

  synth_image   -- CIFAR10 analogue: class-conditional Gaussian patch
                   embeddings (the ViT patchify stub), 10 classes.
  synth_flair   -- FLAIR analogue: multi-prototype image task, 17 coarse
                   classes, naturally partitioned by synthetic user with
                   per-user class preferences.
  synth_text    -- 20NewsGroups analogue: class-conditional Markov token
                   sequences, 20 classes, sequence classification.
  synth_reddit  -- Reddit analogue: user-conditional next-token prediction
                   (each user has a biased unigram/bigram signature).

Tasks are learnable by construction (the class signal is linearly present
in the embeddings / transition biases), so utility-against-communication
orderings show at small scale.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.data.partition import dirichlet_partition, natural_partition


@dataclasses.dataclass
class FederatedTask:
    name: str
    kind: str                       # 'embeds_cls' | 'tokens_cls' | 'tokens_lm'
    parts: List[np.ndarray]         # per-client example indices
    data: Dict[str, np.ndarray]     # full arrays ('embeds'/'tokens', 'labels')
    eval_data: Dict[str, np.ndarray]
    n_classes: int = 0

    @property
    def n_clients(self) -> int:
        return len(self.parts)

    def client_examples(self, c: int) -> Dict[str, np.ndarray]:
        idx = self.parts[c]
        return {k: v[idx] for k, v in self.data.items()}


def _class_markov(rng, n_classes, vocab, strength=3.0):
    base = rng.normal(0, 1, (vocab, vocab))
    bias = rng.normal(0, strength, (n_classes, vocab))
    return base, bias


def _sample_markov(rng, base, bias_c, length):
    vocab = base.shape[0]
    seq = np.empty(length, np.int32)
    tok = rng.integers(vocab)
    for t in range(length):
        logits = base[tok] + bias_c
        p = np.exp(logits - logits.max())
        p /= p.sum()
        tok = rng.choice(vocab, p=p)
        seq[t] = tok
    return seq


def make_synth_image(n_examples=2048, n_clients=64, n_classes=10,
                     n_patches=16, dim=64, alpha=0.1, noise=1.0, seed=0,
                     n_eval=512) -> FederatedTask:
    rng = np.random.default_rng(seed)
    protos = rng.normal(0, 1, (n_classes, n_patches, dim)).astype(np.float32)

    def gen(n, r):
        labels = r.integers(0, n_classes, n).astype(np.int32)
        embeds = protos[labels] + noise * r.normal(0, 1, (n, n_patches, dim)).astype(np.float32)
        return {"embeds": embeds.astype(np.float32), "labels": labels}

    data = gen(n_examples, rng)
    eval_data = gen(n_eval, np.random.default_rng(seed + 1))
    parts = dirichlet_partition(data["labels"], n_clients, alpha, seed=seed + 2)
    return FederatedTask("synth_image", "embeds_cls", parts, data, eval_data, n_classes)


def make_synth_flair(n_users=128, examples_per_user=(4, 24), n_classes=17,
                     n_patches=16, dim=64, noise=1.2, seed=0, n_eval=512) -> FederatedTask:
    rng = np.random.default_rng(seed)
    protos = rng.normal(0, 1, (n_classes, n_patches, dim)).astype(np.float32)
    embeds, labels, users = [], [], []
    for u in range(n_users):
        pref = rng.dirichlet(np.full(n_classes, 0.3))
        n_u = int(rng.integers(*examples_per_user))
        ys = rng.choice(n_classes, n_u, p=pref)
        for y in ys:
            embeds.append(protos[y] + noise * rng.normal(0, 1, (n_patches, dim)))
            labels.append(y)
            users.append(u)
    data = {"embeds": np.asarray(embeds, np.float32),
            "labels": np.asarray(labels, np.int32)}
    er = np.random.default_rng(seed + 1)
    ey = er.integers(0, n_classes, n_eval).astype(np.int32)
    eval_data = {"embeds": (protos[ey] + noise * er.normal(0, 1, (n_eval, n_patches, dim))).astype(np.float32),
                 "labels": ey}
    parts = natural_partition(np.asarray(users))
    return FederatedTask("synth_flair", "embeds_cls", parts, data, eval_data, n_classes)


def make_synth_text(n_examples=2048, n_clients=64, n_classes=20, vocab=256,
                    length=32, alpha=0.1, seed=0, n_eval=512) -> FederatedTask:
    rng = np.random.default_rng(seed)
    base, bias = _class_markov(rng, n_classes, vocab)

    def gen(n, r):
        labels = r.integers(0, n_classes, n).astype(np.int32)
        toks = np.stack([_sample_markov(r, base, bias[y], length) for y in labels])
        return {"tokens": toks.astype(np.int32), "labels": labels}

    data = gen(n_examples, rng)
    eval_data = gen(n_eval, np.random.default_rng(seed + 1))
    parts = dirichlet_partition(data["labels"], n_clients, alpha, seed=seed + 2)
    return FederatedTask("synth_text", "tokens_cls", parts, data, eval_data, n_classes)


def make_synth_reddit(n_users=256, examples_per_user=(4, 16), vocab=256,
                      length=24, n_styles=16, seed=0, n_eval=512) -> FederatedTask:
    rng = np.random.default_rng(seed)
    base, bias = _class_markov(rng, n_styles, vocab, strength=2.0)
    toks, users, styles = [], [], []
    for u in range(n_users):
        style = int(rng.integers(n_styles))
        n_u = int(rng.integers(*examples_per_user))
        for _ in range(n_u):
            toks.append(_sample_markov(rng, base, bias[style], length))
            users.append(u)
            styles.append(style)
    data = {"tokens": np.asarray(toks, np.int32)}
    er = np.random.default_rng(seed + 1)
    ev = [_sample_markov(er, base, bias[int(er.integers(n_styles))], length)
          for _ in range(n_eval)]
    eval_data = {"tokens": np.asarray(ev, np.int32)}
    parts = natural_partition(np.asarray(users))
    return FederatedTask("synth_reddit", "tokens_lm", parts, data, eval_data, 0)


TASKS = {
    "synth_image": make_synth_image,
    "synth_flair": make_synth_flair,
    "synth_text": make_synth_text,
    "synth_reddit": make_synth_reddit,
}
