"""Global differential privacy for FedAdam (paper §4.5, De et al. [12]).

The port of `src/repro/core/dp.py`.  Clients upload non-private updates;
the server clips each client delta to L2 norm C, sums, normalizes by n*C,
and adds Gaussian noise sigma/n.  "Neighboring datasets" = add/remove one
client's dataset (client-level DP).  Appx B.4: the reported epsilon uses a
simulated cohort size, which changes only the reported budget.

The noise comes from an explicit `torch.Generator` on the deltas' device.
The round seeds it anew every round (`core/fedround.py`): one fixed draw
replayed each round is a bias the server optimizer learns around, not DP.
Torch and JAX draw different normals, so the noise compares across the
packages only in distribution.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def clip_deltas(deltas: torch.Tensor, clip_norm: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """deltas (n_clients, p). Returns (clipped, pre-clip norms)."""
    norms = torch.linalg.vector_norm(deltas, dim=-1)
    scale = torch.clamp_max(clip_norm / torch.clamp_min(norms, 1e-12), 1.0)
    return deltas * scale[:, None], norms


def dp_aggregate(deltas: torch.Tensor, clip_norm: float, noise_mult: float,
                 generator: Optional[torch.Generator]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DP-FedAdam server aggregation: (sum clip(d_i)) / (n*C) + (sigma/n)*xi,
    xi standard normal from `generator` (unused when `noise_mult` is 0).
    Returns (the noised normalized pseudo-gradient, the pre-clip norms)."""
    n = deltas.shape[0]
    clipped, norms = clip_deltas(deltas, clip_norm)
    agg = clipped.sum(0) / (n * clip_norm)
    if noise_mult > 0.0:
        if generator is None:
            raise ValueError("dp_aggregate with noise needs a generator")
        agg = agg + (noise_mult / n) * torch.randn(
            agg.shape, generator=generator, dtype=agg.dtype,
            device=agg.device)
    return agg, norms


def simulated_noise_multiplier(sigma_at_cohort: float, simulated_cohort: int,
                               actual_cohort: int) -> float:
    """Song et al. [60] §5.1 trick: linearly scale noise down to the cohort
    actually sampled in simulation."""
    return sigma_at_cohort * actual_cohort / simulated_cohort


def gaussian_epsilon(noise_mult: float, rounds: int, sample_rate: float,
                     delta: float = 1e-6) -> float:
    """Loose RDP-style estimate of epsilon for reporting (not used in
    training).  eps ~= sample_rate * sqrt(2 * rounds * ln(1/delta)) / sigma."""
    if noise_mult <= 0:
        return float("inf")
    return sample_rate * math.sqrt(2 * rounds * math.log(1 / delta)) / noise_mult
