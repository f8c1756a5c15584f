"""Uniform symmetric quantization for FLASC messages.

The port of `src/repro/core/quantization.py`.  Composes with Top-K: mask
first, then quantize the surviving values, so the wire format is
(indices/bitmap, b-bit values, one f32 scale).  Each row of a (..., n)
input is one message with its own scale, as the reference's vmap over
clients gives.

Stochastic rounding keeps the quantizer unbiased.  Its uniform draw comes
from `rng`, which is one of:
  - None: round to nearest (half to even, as `jnp.round`);
  - a tensor `u` of uniforms shaped like the message (a test injects the
    reference's draw this way);
  - a `torch.Generator`: one draw of the last axis, shared by every row
    (one broadcast message, the reference's shared download key);
  - a sequence of generators, one per row (per-client upload keys).
Torch and JAX draw different numbers from the same seed: only injected
`u` compares across packages.

Seeds are host integers: `fold_in(seed, data)` derives a new one (the
analogue of `jax.random.fold_in`), `generator(seed, device)` makes the
`torch.Generator` that draws from it on the vector's device.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

Rng = Union[None, torch.Tensor, torch.Generator, Sequence[torch.Generator]]

_MASK64 = (1 << 64) - 1


def fold_in(seed: int, data: int) -> int:
    """Deterministic 63-bit seed for (seed, data): SplitMix64 finalizer of
    the pair, computed on the host (no device work, no sync)."""
    z = (seed * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def uniform_like(values: torch.Tensor, rng: Rng) -> Optional[torch.Tensor]:
    """The stochastic-rounding draw for `values` (see the module doc)."""
    if rng is None:
        return None
    if isinstance(rng, torch.Tensor):
        return rng.to(torch.float32).expand(values.shape)
    n = values.shape[-1]
    if isinstance(rng, torch.Generator):
        return torch.rand(n, generator=rng, device=values.device).expand(
            values.shape)
    rows = values.reshape(-1, n).shape[0]
    if len(rng) != rows:
        raise ValueError(f"{len(rng)} generators for {rows} rows")
    u = torch.empty((rows, n), dtype=torch.float32, device=values.device)
    for i, g in enumerate(rng):
        u[i] = torch.rand(n, generator=g, device=values.device)
    return u.reshape(values.shape)


def qmax_of(bits: int) -> float:
    return float(2 ** (bits - 1) - 1)


def scale_of(absmax: torch.Tensor, bits: int) -> torch.Tensor:
    """The quantizer scale max(absmax / qmax, 1e-12), computed as the
    reference computes it under jit: XLA folds the division by the
    constant qmax into a multiply by its f32 reciprocal (up to an ulp away
    from a true division)."""
    inv = float(np.float32(1.0) / np.float32(qmax_of(bits)))
    return torch.clamp_min(absmax * inv, 1e-12)


def quantize(x: torch.Tensor, bits: int, rng: Rng = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., n) f32 -> (integer levels held in f32, scale (...,)).  bits in
    [2, 8].  `rng` enables stochastic rounding (unbiased)."""
    if not 2 <= bits <= 8:
        raise ValueError(f"bits must be in [2, 8], got {bits}")
    qmax = qmax_of(bits)
    scale = scale_of(x.abs().amax(-1), bits)
    y = x / scale[..., None]
    u = uniform_like(x, rng)
    y = torch.floor(y + u) if u is not None else torch.round(y)
    return torch.clamp(y, -qmax - 1, qmax), scale


def dequantize(levels: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return levels * scale[..., None]


def quantize_roundtrip(x: torch.Tensor, bits: int,
                       rng: Rng = None) -> torch.Tensor:
    """The simulation primitive: what the receiver reconstructs."""
    if bits <= 0 or bits >= 32:
        return x
    levels, scale = quantize(x, bits, rng)
    return dequantize(levels, scale)


def message_bytes(nnz, bits: int):
    """Wire bytes for nnz quantized values (+ 4B scale)."""
    if bits <= 0 or bits >= 32:
        return nnz * 4.0
    return nnz * (bits / 8.0) + 4.0
