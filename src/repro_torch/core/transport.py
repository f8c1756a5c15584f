"""Composable client<->server message transport.

The port of `src/repro/core/transport.py`.  A message is a dense-embedded
sparse vector plus its accounting; a `Pipeline` is an ordered tuple of
stages:

    topk-mask / fixed-mask  ->  quantize | lowrank  ->  [coding]

Coding never changes values: it sets the wire size, which
`CommLedger.record_round` bills through `comm.coded_message_bytes`.

A message holds one vector (n,) or a batch of rows (C, n), one message
per row (the round stacks the cohort's uploads and runs each stage once
over all of them).  Stages take `rng`, the stochastic-rounding source of
`quantization.uniform_like` (None, an injected uniform tensor, a
generator, or one generator per row), where the reference takes a key.

Stages are registered like the reference's (`register_stage`,
`registered_stages()`).  ``lowrank`` is registered, and its wire format
is computed, but applying it raises: FLoCoRA-style message compression is
not ported yet (ROADMAP queue 1, item 6).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Type

import torch

from repro_torch.core import quantization as qz
from repro_torch.core import selectors as sel
from repro_torch.core import sparsity as sp
from repro_torch.core.strategies import StrategySpec, UploadRule


@dataclasses.dataclass
class Message:
    """Transmitted vector(s): dense-embedded values + accounting."""
    values: torch.Tensor                # (..., p_len), zeros off-support
    nnz: torch.Tensor                   # (...,): transmitted entry count
    value_bits: float = 32.0            # per-value wire width after coding

    @classmethod
    def dense(cls, values) -> "Message":
        return cls(values, torch.full(values.shape[:-1], values.shape[-1],
                                      dtype=torch.float32,
                                      device=values.device))


class Stage:
    """Transport stage protocol: Message -> Message."""

    stage_name: str = "base"

    def __call__(self, msg: Message, *, rng: qz.Rng = None) -> Message:
        raise NotImplementedError

    def wire(self, n: int, value_bits: float, dense: bool
             ) -> Tuple[float, bool]:
        """Static mirror of what this stage does to the wire format of an
        n-entry message: (per-value bit width, dense-coded flag)."""
        return value_bits, dense


_STAGES: Dict[str, Type[Stage]] = {}


def register_stage(name: str):
    """Class decorator entering the stage in the transport registry."""
    def deco(cls: Type[Stage]) -> Type[Stage]:
        if not issubclass(cls, Stage):
            raise TypeError(f"{cls} is not a Stage")
        cls.stage_name = name
        _STAGES[name] = cls
        return cls
    return deco


def registered_stages() -> Tuple[str, ...]:
    return tuple(sorted(_STAGES))


def resolve_stage(name: str) -> Type[Stage]:
    try:
        return _STAGES[name]
    except KeyError:
        raise KeyError(f"no transport stage registered as {name!r}; "
                       f"known: {registered_stages()}") from None


@register_stage("mask")
@dataclasses.dataclass
class MaskSparsify(Stage):
    """Multiply by a fixed mask.  `count_mask=True` bills the mask support
    (download: every selected entry is sent, zero or not); `False` bills
    the actual nonzero values (a fixed-mask upload)."""
    mask: Any
    count_mask: bool = False

    def __call__(self, msg: Message, *, rng: qz.Rng = None) -> Message:
        values = sp.apply_mask(msg.values, self.mask)
        if self.count_mask:
            nnz = self.mask.sum(-1, dtype=torch.float32)
        else:
            nnz = (values != 0).sum(-1, dtype=torch.float32)
        return dataclasses.replace(msg, values=values, nnz=nnz)

    def wire(self, n, value_bits, dense):
        # masking changes nnz, never the per-value width or coding
        return value_bits, dense


@register_stage("topk")
@dataclasses.dataclass
class TopKSparsify(Stage):
    """Magnitude Top-K.  Exactly one of `density` or `count` (an int, or an
    int32 tensor with one count per row) must be set; `selector` names the
    selection policy (`core.selectors`) or is a `Selector`."""
    density: Optional[float] = None
    count: Any = None
    selector: sel.SelectorLike = "exact"

    def __call__(self, msg: Message, *, rng: qz.Rng = None) -> Message:
        if (self.density is None) == (self.count is None):
            raise ValueError("TopKSparsify needs exactly one of density and "
                             "count")
        s = sel.resolve_selector(self.selector)
        if self.density is not None:
            values, nnz = s.sparsify(msg.values, self.density)
        else:
            values, nnz = s.sparsify_by_count(msg.values, self.count)
        return dataclasses.replace(msg, values=values, nnz=nnz)

    def wire(self, n, value_bits, dense):
        # Top-K changes nnz, never the per-value width or coding
        return value_bits, dense


@register_stage("quantize")
@dataclasses.dataclass
class Quantize(Stage):
    """Uniform symmetric b-bit quantization of the surviving values, one
    scale per row (stochastic rounding when `rng` is given: unbiased)."""
    bits: int

    def __call__(self, msg: Message, *, rng: qz.Rng = None) -> Message:
        if not self.bits:
            return msg
        values = qz.quantize_roundtrip(msg.values, self.bits, rng)
        return dataclasses.replace(msg, values=values,
                                   value_bits=float(self.bits))

    def wire(self, n, value_bits, dense):
        return (float(self.bits) if self.bits else value_bits), dense


@register_stage("fused_topk_quantize")
@dataclasses.dataclass
class FusedTopKQuantize(Stage):
    """Top-K and the direction's quantization in one fused kernel pass
    (`selectors.FusedSelector.sparsify_quantized`): the rows are streamed
    three times in all (absmax, bisection-path bins, mask + quantize), one
    launch each for the whole batch.  Bit-identical to `TopKSparsify(
    selector="fused")` followed by `Quantize(bits)` with the same draw.

    Exactly one of `density` or `count` must be set; `bits == 0` fuses
    just mask and count.  `selector` must resolve to a `FusedSelector`."""
    density: Optional[float] = None
    count: Any = None
    bits: int = 0
    selector: sel.SelectorLike = "fused"

    def __call__(self, msg: Message, *, rng: qz.Rng = None) -> Message:
        if (self.density is None) == (self.count is None):
            raise ValueError("FusedTopKQuantize needs exactly one of density "
                             "and count")
        s = sel.resolve_selector(self.selector)
        if not isinstance(s, sel.FusedSelector):
            raise TypeError(f"FusedTopKQuantize needs a FusedSelector, got "
                            f"{s!r}")
        values, nnz = s.sparsify_quantized(
            msg.values, density=self.density, count=self.count,
            bits=self.bits, rng=rng)
        bits = float(self.bits) if 0 < self.bits < 32 else msg.value_bits
        return dataclasses.replace(msg, values=values, nnz=nnz,
                                   value_bits=bits)

    def wire(self, n, value_bits, dense):
        # owns the value width when it quantizes; coding stays sparse
        return (float(self.bits) if 0 < self.bits < 32 else value_bits), \
            dense


def _factor_dims(n: int, rows: int = 0) -> Tuple[int, int]:
    """Near-square (rows, cols) embedding of an n-vector (the reference's)."""
    if n < 1:
        raise ValueError(f"cannot embed a {n}-entry message")
    rows = int(rows) if rows else math.isqrt(n - 1) + 1
    return rows, -(-n // rows)


@register_stage("lowrank")
@dataclasses.dataclass
class LowRankCompress(Stage):
    """FLoCoRA-style low-rank compression of the message (the reference's
    `transport.LowRankCompress`).  Its wire format is ported, so ledgers
    bill it; applying it raises until it is ported (ROADMAP queue 1,
    item 6)."""
    rank: int
    mode: str = "random"
    seed: int = 0
    bits: int = 0
    rows: int = 0
    fold: Any = None

    def active(self, n: int) -> bool:
        rows, cols = _factor_dims(n, self.rows)
        return 0 < self.rank < min(rows, cols)

    def __call__(self, msg: Message, *, rng: qz.Rng = None) -> Message:
        raise NotImplementedError(
            "the lowrank transport stage is not ported yet (ROADMAP queue 1, "
            "item 6)")

    def wire(self, n, value_bits, dense):
        if not self.active(n):
            return (float(self.bits) if self.bits else value_bits), dense
        return (float(self.bits) if self.bits else 32.0), True


@dataclasses.dataclass
class Pipeline:
    """Ordered stage composition.  Call with dense values (one vector or a
    batch of rows); returns the receiver-side `Message`."""
    stages: Tuple[Stage, ...] = ()

    def __call__(self, values: torch.Tensor, *, rng: qz.Rng = None
                 ) -> Message:
        msg = Message.dense(values)
        for stage in self.stages:
            msg = stage(msg, rng=rng)
        return msg

    def wire(self, n: int) -> Tuple[float, bool]:
        """Static wire format of an n-entry message after all stages."""
        bits, dense = 32.0, False
        for stage in self.stages:
            bits, dense = stage.wire(n, bits, dense)
        return bits, dense

    @property
    def value_bits(self) -> float:
        bits = 32.0
        for stage in self.stages:
            bits, _ = stage.wire(1 << 30, bits, False)
        return bits

    @property
    def value_bytes(self) -> float:
        return self.value_bits / 8.0


def lowrank_stage(spec: StrategySpec, direction: str, *,
                  fold=None) -> Optional[LowRankCompress]:
    """The spec-configured `LowRankCompress` stage for one direction
    ("down" | "up"), or None when the spec does not opt in."""
    if direction not in ("down", "up"):
        raise ValueError(f"direction must be 'down' or 'up', got {direction!r}")
    down = direction == "down"
    rank = spec.lowrank_down if down else spec.lowrank_up
    if rank <= 0:
        return None
    return LowRankCompress(
        rank=rank, mode=spec.lowrank_mode,
        seed=2 * spec.lowrank_seed + (0 if down else 1),
        bits=spec.quant_bits_down if down else spec.quant_bits_up,
        fold=fold)


def wire_format(spec: StrategySpec, p_len: int, direction: str
                ) -> Tuple[float, bool]:
    """(value_bytes, dense_coded) for one direction's messages under
    `spec`: what `CommLedger` bills."""
    lr = lowrank_stage(spec, direction)
    quant = spec.quant_bits_down if direction == "down" else spec.quant_bits_up
    stages: Tuple[Stage, ...] = ()
    if lr is not None:
        stages = (lr,)
    elif quant:
        stages = (Quantize(quant),)
    bits, dense = Pipeline(stages).wire(p_len)
    return bits / 8.0, dense


def download_pipeline(mask, quant_bits: int = 0, *,
                      lowrank: Optional[LowRankCompress] = None) -> Pipeline:
    """Server -> client: mask the weight vector, then optionally compress
    or quantize."""
    stages: Tuple[Stage, ...] = (MaskSparsify(mask, count_mask=True),)
    if lowrank is not None:
        stages += (lowrank,)
    elif quant_bits:
        stages += (Quantize(quant_bits),)
    return Pipeline(stages)


def upload_pipeline(rule: UploadRule, quant_bits: int = 0, *,
                    selector: sel.SelectorLike = "exact",
                    count=None,
                    lowrank: Optional[LowRankCompress] = None) -> Pipeline:
    """Client -> server from a strategy's `UploadRule`.  `count` overrides a
    topk rule's static density with keep-counts (one per row).  A
    `FusedSelector` on a topk rule collapses Top-K and the quantization
    into the one `FusedTopKQuantize` stage, unless `lowrank` owns the
    quantization."""
    if rule.mode == "topk":
        resolved = sel.resolve_selector(selector)
        if isinstance(resolved, sel.FusedSelector) and lowrank is None:
            fused = FusedTopKQuantize(
                density=None if count is not None else rule.density,
                count=count, bits=quant_bits, selector=resolved)
            return Pipeline((fused,))
        if count is not None:
            stage: Stage = TopKSparsify(count=count, selector=selector)
        else:
            stage = TopKSparsify(density=rule.density, selector=selector)
    else:
        stage = MaskSparsify(rule.mask)
    stages: Tuple[Stage, ...] = (stage,)
    if lowrank is not None:
        stages += (lowrank,)
    elif quant_bits:
        stages += (Quantize(quant_bits),)
    return Pipeline(stages)
