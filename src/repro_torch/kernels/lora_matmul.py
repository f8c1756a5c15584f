"""The grouped multi-adapter LoRA delta: registry, plain versions, kernel.

The multi-tenant serving hot path (punica / S-LoRA-style BGMV): one batch
whose rows belong to *different* clients' adapters.  A `GroupedLoraKernel`
computes  delta[m] = scale * (x[m] @ a[g[m]]) @ b[g[m]]  for a page pool
a (G, K, R), b (G, R, N) and per-row page indices g (M,).  The registry
names are the reference's (`src/repro/kernels/lora_matmul.py`), so a name
means the same function in both packages:

  - ``grouped_ref``    -- per-row loop: the semantics.
  - ``grouped_gather`` -- index-select + einsum: the CPU default.
  - ``grouped_pallas`` -- the hand-written CUDA kernel for sm_90a in
    `csrc/grouped_lora.cu` (the name is the reference's, whose TPU kernel
    it replaces).  CUDA tensors only; it never falls back to a plain
    version.

`resolve_grouped_kernel(None, device)` picks by the tensors' device: the
CUDA kernel for CUDA tensors, ``grouped_gather`` on the CPU (the
reference's off-TPU default).  `models/layers.py::linear` dispatches here
whenever a LoRA dict carries a `gidx` leaf.
"""
from __future__ import annotations

import ctypes
from typing import ClassVar, Dict, Optional, Tuple, Type, Union

import torch

from repro_torch.kernels import _build


class GroupedLoraKernel:
    """Batched-adapter LoRA delta protocol.

    `delta(x, a, b, gidx, scale)` with x (M, K), page pools a (G, K, R) /
    b (G, R, N), and per-row page indices gidx (M,) int32 returns the
    (M, N) LoRA contribution  scale * (x[m] @ a[g]) @ b[g]  in x.dtype:
    two contractions per row, f32 accumulation, scale applied to the
    second product.
    """

    name: ClassVar[str] = "base"

    def delta(self, x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              gidx: torch.Tensor, scale: float) -> torch.Tensor:
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}()"


_GROUPED_REGISTRY: Dict[str, Type[GroupedLoraKernel]] = {}
_GROUPED_DEFAULTS: Dict[str, GroupedLoraKernel] = {}


def register_grouped_kernel(name: str):
    """Class decorator entering a kernel in the registry under `name`."""
    def deco(cls: Type[GroupedLoraKernel]) -> Type[GroupedLoraKernel]:
        if not issubclass(cls, GroupedLoraKernel):
            raise TypeError(f"{cls} is not a GroupedLoraKernel")
        cls.name = name
        _GROUPED_REGISTRY[name] = cls
        return cls
    return deco


def registered_grouped_kernels() -> Tuple[str, ...]:
    return tuple(sorted(_GROUPED_REGISTRY))


GroupedKernelLike = Union[str, GroupedLoraKernel]


def resolve_grouped_kernel(obj: Optional[GroupedKernelLike] = None,
                           device: Union[str, torch.device, None] = None
                           ) -> GroupedLoraKernel:
    """Kernel name or instance -> instance (one shared instance per name,
    which holds the kernel's launch count).  None -> by `device`: the CUDA
    kernel on a CUDA device, ``grouped_gather`` elsewhere."""
    if obj is None:
        if device is None:
            raise ValueError("resolve_grouped_kernel(None) needs the tensors' "
                             "device to choose a kernel")
        obj = ("grouped_pallas" if torch.device(device).type == "cuda"
               else "grouped_gather")
    if isinstance(obj, GroupedLoraKernel):
        return obj
    if isinstance(obj, str):
        if obj not in _GROUPED_REGISTRY:
            raise KeyError(f"no grouped kernel registered for {obj!r}; "
                           f"known: {registered_grouped_kernels()}")
        if obj not in _GROUPED_DEFAULTS:
            _GROUPED_DEFAULTS[obj] = _GROUPED_REGISTRY[obj]()
        return _GROUPED_DEFAULTS[obj]
    raise TypeError(f"cannot resolve {obj!r} to a GroupedLoraKernel")


def grouped_lora_delta(x, a, b, gidx, scale,
                       kernel: Optional[GroupedKernelLike] = None):
    """Dispatch helper: x (..., K) with gidx broadcastable to the leading
    dims (one adapter per row; a (B,)-shaped gidx serves a (B, S, K)
    batch with one adapter per sequence).  Returns (..., N) in a.dtype
    (callers cast back, like the single-adapter path in `linear`)."""
    kern = resolve_grouped_kernel(kernel, x.device)
    lead = x.shape[:-1]
    gidx = torch.as_tensor(gidx, dtype=torch.int32, device=x.device)
    g = gidx.reshape(tuple(gidx.shape) + (1,) * (len(lead) - gidx.ndim))
    g = g.expand(lead).reshape(-1)
    x2 = x.reshape(-1, x.shape[-1]).to(a.dtype).contiguous()
    out = kern.delta(x2, a, b, g, scale)
    return out.reshape(tuple(lead) + (b.shape[-1],))


@register_grouped_kernel("grouped_ref")
class RefGroupedKernel(GroupedLoraKernel):
    """Per-row reference loop -- the semantics.  One step per row:
    xa = x_m @ a[g_m] (f32), delta = scale * (xa @ b[g_m])."""

    def delta(self, x, a, b, gidx, scale):
        rows = []
        for m, g in enumerate(gidx.tolist()):
            xa = torch.matmul(x[m:m + 1].float(), a[g].float())
            rows.append(scale * torch.matmul(xa, b[g].float()))
        if not rows:
            return x.new_zeros((0, b.shape[-1]))
        return torch.cat(rows).to(x.dtype)


@register_grouped_kernel("grouped_gather")
class GatherGroupedKernel(GroupedLoraKernel):
    """Batched gather + einsum.  The (M, K, R) gather is materialized,
    which is fine at serving batch sizes (M = lanes)."""

    def delta(self, x, a, b, gidx, scale):
        idx = gidx.long()
        ag = a.index_select(0, idx).float()          # (M, K, R)
        bg = b.index_select(0, idx).float()          # (M, R, N)
        xa = torch.einsum("mk,mkr->mr", x.float(), ag)
        return (scale * torch.einsum("mr,mrn->mn", xa, bg)).to(x.dtype)


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float]
MAX_RANK = 64


@register_grouped_kernel("grouped_pallas")
class CudaGroupedKernel(GroupedLoraKernel):
    """The hand-written CUDA kernel (`csrc/grouped_lora.cu`), built by
    `nvcc` at first use.  f32 x / a / b, int32 gidx, every tensor
    contiguous and on one CUDA device, pool rank <= 64.  Launches on the
    current stream and does not synchronise.  `launches` counts the
    launches this instance made; nothing else adds to it."""

    def __init__(self):
        self.fn = _build.CudaFunction("grouped_lora", "grouped_lora_delta_f32",
                                      _ARGTYPES)

    @property
    def launches(self) -> int:
        return self.fn.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.fn.launches = n

    def delta(self, x, a, b, gidx, scale):
        if not x.is_cuda:
            raise ValueError(
                "grouped_pallas is the CUDA kernel and takes CUDA tensors; "
                "on the CPU use grouped_ref or grouped_gather (or kernel=None)")
        M, K = x.shape
        G, Ka, R = a.shape
        Gb, Rb, N = b.shape
        if (Ka, Gb, Rb, tuple(gidx.shape)) != (K, G, R, (M,)):
            raise ValueError(f"shape mismatch: x {tuple(x.shape)}, a "
                             f"{tuple(a.shape)}, b {tuple(b.shape)}, gidx "
                             f"{tuple(gidx.shape)}")
        for t, nm in ((x, "x"), (a, "a"), (b, "b")):
            if t.dtype != torch.float32:
                raise TypeError(f"grouped_pallas takes f32 {nm}, got {t.dtype}")
        if gidx.dtype != torch.int32:
            raise TypeError(f"grouped_pallas takes int32 gidx, got {gidx.dtype}")
        for t, nm in ((x, "x"), (a, "a"), (b, "b"), (gidx, "gidx")):
            if t.device != x.device:
                raise ValueError(f"{nm} is on {t.device}, x on {x.device}")
            if not t.is_contiguous():
                raise ValueError(f"grouped_pallas needs a contiguous {nm}")
        if R > MAX_RANK:
            raise ValueError(f"pool rank {R} exceeds the kernel's {MAX_RANK}")
        if G < 1:
            raise ValueError("empty page pool")
        out = torch.empty((M, N), dtype=torch.float32, device=x.device)
        if M == 0 or N == 0:
            return out
        self.fn(x.device, x.data_ptr(), a.data_ptr(), b.data_ptr(),
                gidx.data_ptr(), out.data_ptr(), M, K, R, N, G, float(scale))
        return out
