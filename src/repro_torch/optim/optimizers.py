"""Optimizers of the federated round, on tensors or nested dicts of them.

The port of `src/repro/optim/optimizers.py`: SGD (+momentum) for the
clients, Adam for the server (FedAdam, betas 0.9/0.999), with the
reference's operation order, so results agree to f32 rounding (`pow` and
`sqrt` may round differently on another library).  State stays on the
device (the step count is an int32 tensor): no host sync.  The round
applies the client step inline on the flat vector (`core/fedround.py`).
"""
from __future__ import annotations

import torch


def _tmap(f, *trees):
    if isinstance(trees[0], dict):
        return {k: _tmap(f, *(t[k] for t in trees)) for k in trees[0]}
    return f(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(leaf.float())) for leaf in _leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


# ---------------------------------------------------------------------------
# SGD (+ momentum)
# ---------------------------------------------------------------------------

def sgd_init(params):
    return {"mu": _tmap(lambda x: torch.zeros_like(x, dtype=torch.float32),
                        params)}


def sgd_update(params, grads, state, lr, momentum: float = 0.0):
    if momentum:
        mu = _tmap(lambda m, g: momentum * m + g.float(), state["mu"], grads)
        step = mu
        state = {"mu": mu}
    else:
        step = grads
    new = _tmap(lambda p, s: (p.float() - lr * s.float()).to(p.dtype),
                params, step)
    return new, state


# ---------------------------------------------------------------------------
# Adam (server-side FedAdam)
# ---------------------------------------------------------------------------

def adam_init(params):
    def z(x):
        return torch.zeros_like(x, dtype=torch.float32)
    leaf = next(_leaves(params))
    return {"m": _tmap(z, params), "v": _tmap(z, params),
            "count": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def adam_update(params, grads, state, lr, b1=0.9, b2=0.999, eps=1e-8):
    count = state["count"] + 1
    cf = count.float()
    m = _tmap(lambda m_, g: b1 * m_ + (1 - b1) * g.float(), state["m"], grads)
    v = _tmap(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.float()),
              state["v"], grads)
    mh = _tmap(lambda m_: m_ / (1 - torch.pow(b1, cf)), m)
    vh = _tmap(lambda v_: v_ / (1 - torch.pow(b2, cf)), v)
    new = _tmap(lambda p, m_, v_: (p.float() - lr * m_ / (torch.sqrt(v_) + eps)
                                   ).to(p.dtype), params, mh, vh)
    return new, {"m": m, "v": v, "count": count}
