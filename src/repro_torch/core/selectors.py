"""Unified Top-K selector layer: one dispatch surface for FLASC's hot spot.

The port of `src/repro/core/selectors.py`, with the same registry names.
A `Selector` answers four selection questions:

    mask(flat, density)          -> (..., n) bool     static density
    mask_by_count(flat, k)       -> (..., n) bool     keep-count(s)
    sparsify(flat, density)      -> (values, nnz)
    sparsify_by_count(flat, k)   -> (values, nnz)

`flat` is one vector (n,) or a batch of rows (..., n), each row selected
on its own with its own count (int, or int32 tensor: scalar or one per
row).  The kernel-backed selectors run a batch as one launch per pass.

* ``exact``     -- stable argsort rank selection: exactly k entries,
  ties broken by position.
* ``histogram`` -- fixed-depth bisection on |x| (`iters` count passes in
  plain torch, `sparsity.threshold_histogram_count`).
* ``pallas``    -- the same bisection with each count pass one launch of
  the CUDA count kernel (`kernels/topk_mask.threshold_count`) and the
  final mask + nnz from one `topk_mask` launch.  Bit-identical to
  ``histogram`` at the same `iters`.  (The name is the reference's, whose
  TPU kernels these replace.)
* ``fused``     -- three streaming passes (`kernels/fused_transport`):
  absmax, bisection-path bins, then the mask.  `FusedSelector(levels=L)`
  is bit-identical to `HistogramSelector(iters=L)`.
  `sparsify_quantized` folds the direction's quantization into the third
  pass: the `transport.FusedTopKQuantize` stage rides it.
  `sparsify_quantized_packed` also packs the survivors in that pass.

On CUDA tensors ``pallas`` and ``fused`` launch the CUDA kernels (or
raise); on CPU tensors the kernel wrappers run their plain versions.
"""
from __future__ import annotations

from typing import ClassVar, Dict, Tuple, Type, Union

import torch

from repro_torch.core import quantization as qz
from repro_torch.core import sparsity as sp
from repro_torch.kernels import fused_transport as ft
from repro_torch.kernels import topk_mask as tm


class Selector:
    """Selection-policy protocol.  Implementations honor the
    `sparsity.clamp_count` keep-count contract: k clipped to [0, n],
    k == 0 keeps nothing."""

    name: ClassVar[str] = "base"

    # --- required -----------------------------------------------------------
    def mask(self, flat: torch.Tensor, density: float) -> torch.Tensor:
        raise NotImplementedError

    def mask_by_count(self, flat: torch.Tensor, k) -> torch.Tensor:
        raise NotImplementedError

    # --- derived (fused selectors override) ---------------------------------
    def sparsify(self, flat, density: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        m = self.mask(flat, density)
        return sp.apply_mask(flat, m), m.sum(-1, dtype=torch.int32)

    def sparsify_by_count(self, flat, k) -> Tuple[torch.Tensor, torch.Tensor]:
        m = self.mask_by_count(flat, k)
        return sp.apply_mask(flat, m), m.sum(-1, dtype=torch.int32)

    def __repr__(self):
        return f"{type(self).__name__}()"


_REGISTRY: Dict[str, Type[Selector]] = {}
_DEFAULTS: Dict[str, Selector] = {}       # lazily-built default instances


def register_selector(name: str):
    """Class decorator entering a selector in the registry under `name`."""
    def deco(cls: Type[Selector]) -> Type[Selector]:
        if not issubclass(cls, Selector):
            raise TypeError(f"{cls} is not a Selector")
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def registered_selectors() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


SelectorLike = Union[str, Selector]


def resolve_selector(obj: SelectorLike) -> Selector:
    """Selector name or instance -> Selector instance (default instances
    are cached per name)."""
    if isinstance(obj, Selector):
        return obj
    if isinstance(obj, str):
        if obj not in _REGISTRY:
            raise KeyError(f"no selector registered for {obj!r}; "
                           f"known: {registered_selectors()}")
        if obj not in _DEFAULTS:
            _DEFAULTS[obj] = _REGISTRY[obj]()
        return _DEFAULTS[obj]
    raise TypeError(f"cannot resolve {obj!r} to a Selector")


# ---------------------------------------------------------------------------
# module-level dispatch (what transport / strategies call)
# ---------------------------------------------------------------------------

def topk_mask(flat, density: float, selector: SelectorLike = "exact"):
    return resolve_selector(selector).mask(flat, density)


def topk_mask_by_count(flat, k, selector: SelectorLike = "exact"):
    return resolve_selector(selector).mask_by_count(flat, k)


def sparsify(flat, density: float, selector: SelectorLike = "exact"):
    return resolve_selector(selector).sparsify(flat, density)


def sparsify_by_count(flat, k, selector: SelectorLike = "exact"):
    return resolve_selector(selector).sparsify_by_count(flat, k)


# ---------------------------------------------------------------------------
# the built-in selectors
# ---------------------------------------------------------------------------

@register_selector("exact")
class ExactSelector(Selector):
    """Stable argsort rank selection: the exact reference semantics."""

    def mask(self, flat, density):
        return sp.topk_mask(flat, density, exact=True)

    def mask_by_count(self, flat, k):
        return sp.topk_mask_by_count(flat, k, exact=True)


@register_selector("histogram")
class HistogramSelector(Selector):
    """Plain-torch bisection threshold (`iters` count-compare halvings)."""

    def __init__(self, iters: int = 24):
        self.iters = iters

    def mask(self, flat, density):
        return sp.topk_mask(flat, density, exact=False, iters=self.iters)

    def mask_by_count(self, flat, k):
        return sp.topk_mask_by_count(flat, k, exact=False, iters=self.iters)

    def __repr__(self):
        return f"HistogramSelector(iters={self.iters})"


def _rows_and_counts(flat: torch.Tensor, k):
    """(B, n) f32 rows of `flat` and their (B,) int32 clamped counts."""
    n = flat.shape[-1]
    x = flat.float().reshape(-1, n)
    k = sp.clamp_count(k, n, flat.device)
    k = torch.broadcast_to(k, flat.shape[:-1]).reshape(-1)
    return x, k


def _finish(flat: torch.Tensor, masked: torch.Tensor, cnt: torch.Tensor,
            k: torch.Tensor):
    """The clamp_count contract's k = 0 guard on (values, nnz); selection
    ran in f32, values return in the caller's dtype (survivors are
    unmodified inputs, or quantized levels, so the cast is the caller's
    rounding)."""
    keep = k > 0
    values = masked.to(flat.dtype) * keep[:, None]
    return values.reshape(flat.shape), (cnt * keep).reshape(flat.shape[:-1])


@register_selector("pallas")
class PallasSelector(Selector):
    """Bisection with one CUDA count launch per iteration
    (`threshold_count`) and one `topk_mask` launch for the final mask and
    nnz; a batch of rows runs as one launch per pass, each row with its
    own count and threshold."""

    def __init__(self, iters: int = 24):
        self.iters = iters

    def _threshold(self, x, k):
        def count(mid):
            return tm.threshold_count(x, mid)
        return sp.threshold_histogram_count(x.abs(), k, self.iters,
                                            count_fn=count)

    def _select(self, flat, k):
        x, kk = _rows_and_counts(flat, k)
        thr = self._threshold(x, kk)
        masked, cnt = tm.topk_mask(x, torch.clamp_min(thr, sp.TINY))
        return _finish(flat, masked, cnt, kk)

    def mask(self, flat, density):
        if density >= 1.0:
            return torch.ones_like(flat, dtype=torch.bool)
        return self.mask_by_count(flat, sp.density_count(flat.shape[-1],
                                                         density))

    def mask_by_count(self, flat, k):
        values, _ = self._select(flat, k)
        return values != 0

    def sparsify(self, flat, density):
        if density >= 1.0:
            return flat, torch.full(flat.shape[:-1], flat.shape[-1],
                                    dtype=torch.int32, device=flat.device)
        return self.sparsify_by_count(flat, sp.density_count(flat.shape[-1],
                                                             density))

    def sparsify_by_count(self, flat, k):
        return self._select(flat, k)

    def __repr__(self):
        return f"PallasSelector(iters={self.iters})"


@register_selector("fused")
class FusedSelector(PallasSelector):
    """Three-pass Top-K (`kernels/fused_transport`): the `PallasSelector`
    surface with the threshold from one `absmax` and one `bin_counts`
    launch and a replay over bin suffix sums (`threshold_from_bins`)
    instead of `iters` count passes.  Bit-identical to
    `HistogramSelector(iters=levels)`.

    `sparsify_quantized` fuses the direction's quantization into the third
    pass.  Its float ops match `quantization.quantize` on the masked vector
    bit for bit: the mask keeps the argmax, so the quantizer's scale is the
    pass-1 absmax in both formulations.  The port computes that absmax
    once and uses it for both the bisection and the scale (the reference
    computes it twice, to the same bits): 1 absmax, 1 bin_counts and 1
    mask_quantize launch per call, whatever the number of rows."""

    def __init__(self, levels: int = ft.LEVELS):
        super().__init__(iters=levels)
        self.levels = levels

    def _threshold(self, x, k, hi0=None):
        hi0 = ft.absmax(x) if hi0 is None else hi0
        hist = ft.bin_counts(x, hi0, self.levels)
        return ft.threshold_from_bins(hist, hi0, k, self.levels)

    def sparsify_quantized(self, flat, *, density=None, count=None,
                           bits: int = 0, rng: qz.Rng = None):
        """(masked + quantized values, nnz) per row: Top-K mask and b-bit
        quantization of the survivors in one kernel pass.  Bit-identical
        to `sparsify`/`sparsify_by_count` followed by
        `quantization.quantize_roundtrip` with the same uniform draw."""
        if (density is None) == (count is None):
            raise ValueError("pass exactly one of density and count")
        n = flat.shape[-1]
        if bits <= 0 or bits >= 32:
            bits = 0                        # quantize_roundtrip passthrough
        if density is not None:
            if density >= 1.0:              # no mask: plain quantization
                values = qz.quantize_roundtrip(flat, bits, rng) if bits \
                    else flat
                return values, torch.full(flat.shape[:-1], n,
                                          dtype=torch.int32,
                                          device=flat.device)
            count = sp.density_count(n, density)
        x, kk, thr, scale, u = self._fused_setup(flat, count, bits, rng)
        masked, cnt = ft.fused_mask_quantize(x, thr, scale, u, bits)
        return _finish(flat, masked, cnt, kk)

    def _fused_setup(self, flat, count, bits: int, rng: qz.Rng):
        """(B, n) f32 rows, clamped counts, thresholds, quantizer scales
        and the uniform draw (None unless stochastic) of the third pass."""
        x, kk = _rows_and_counts(flat, count)
        hi0 = ft.absmax(x)
        thr = torch.clamp_min(self._threshold(x, kk, hi0), sp.TINY)
        scale = qz.scale_of(hi0, bits) if bits else torch.ones_like(hi0)
        u = qz.uniform_like(x, rng) if bits else None
        return x, kk, thr, scale, None if u is None else u.contiguous()

    def sparsify_quantized_packed(self, flat, *, count, bits: int = 0,
                                  rng: qz.Rng = None, cap: int):
        """`sparsify_quantized` that also packs the coded wire form in the
        same kernel, for one 1-D vector: returns (values, nnz, idx (cap,),
        val (cap,)).  Survivors past `cap` are dropped from the packed
        buffer (nnz still counts them, so nnz > cap flags overflow); empty
        slots sit at the sentinel index n.  A survivor that quantized to
        zero keeps its slot, with value 0.  With k == 0 every slot holds
        the sentinel."""
        if flat.ndim != 1:
            raise ValueError(f"sparsify_quantized_packed takes one (n,) "
                             f"vector, got {tuple(flat.shape)}")
        if bits <= 0 or bits >= 32:
            bits = 0
        n = flat.shape[-1]
        x, kk, thr, scale, u = self._fused_setup(flat, count, bits, rng)
        masked, idx, val, tot = ft.fused_mask_quantize_pack(
            x, thr, scale, u, bits, cap, n)
        keep = kk[0] > 0                    # clamp_count contract: k=0 -> {}
        return (masked[0].to(flat.dtype) * keep, tot[0] * keep,
                torch.where(keep, idx[0], n), val[0] * keep)

    def __repr__(self):
        return f"FusedSelector(levels={self.levels})"
