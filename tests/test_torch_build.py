"""The port's kernel build and kernel choice, on the CPU: no nvcc, no card.

A library is named by a hash of what it is compiled from, so an edited
source, shared header or flag builds a new library instead of loading a
stale one.  The flash-attention and LoRA-matmul wrappers pick their kernel
(route) from the dtype and shape alone, before the launch, by a plain
function that these tests hold to the routes the CUDA sources take.
"""
import _torch_threads  # noqa: F401  (this process's share of the cores)
import os
import shutil
import sys

import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lora_matmul as lm


@pytest.fixture
def csrc(tmp_path):
    """A copy of csrc/ to edit."""
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst)
    return dst


def _names(csrc):
    return {n: _build.library_path(n, csrc) for n in _build.sources()}


def test_sources_are_the_cu_files_and_headers_are_shared():
    assert _build.sources() == ["flash_attention", "flash_attention_bwd",
                                "grouped_lora", "lora_matmul", "transport"]
    assert (_build.CSRC / "hopper.cuh").is_file()
    for name in ("flash_attention", "flash_attention_bwd", "lora_matmul"):
        assert '#include "hopper.cuh"' in (_build.CSRC / f"{name}.cu").read_text()


def test_library_names_depend_on_bytes_not_on_the_directory(csrc):
    assert _names(csrc) == _names(_build.CSRC)
    for path in _names(csrc).values():
        assert path.parent == _build.BUILD_DIR


@pytest.mark.parametrize("header", ["hopper.cuh", "new_header.cuh"])
def test_an_edited_or_added_header_renames_every_library(csrc, header):
    before = _names(csrc)
    path = csrc / header
    path.write_bytes((path.read_bytes() if path.exists() else b"")
                     + b"\n// one more line\n")
    after = _names(csrc)
    assert all(after[n] != before[n] for n in before)


def test_an_edited_source_renames_only_its_library(csrc):
    before = _names(csrc)
    src = csrc / "lora_matmul.cu"
    src.write_bytes(src.read_bytes() + b"\n")
    after = _names(csrc)
    assert {n for n in before if after[n] != before[n]} == {"lora_matmul"}


def test_the_flags_rename_every_library(csrc, monkeypatch):
    before = _names(csrc)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lcuda",))
    after = _names(csrc)
    assert all(after[n] != before[n] for n in before)


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "mma_sync"),
    (torch.bfloat16, 32, "mma_sync"), (torch.float32, 128, "fma"),
    (torch.float32, 64, "fma"), (torch.float32, 32, "fma"),
    (torch.bfloat16, 256, "hd256"), (torch.float32, 256, "fma")])
def test_flash_route(dtype, hd, route):
    assert fa.flash_route(dtype, hd) == route
    assert fa.ROUTES[route] in (0, 1, 2, 3)


# the backward's kernels: the forward's routes, wgmma for bf16 at hd 128,
# mma.sync at hd 32 and 64
@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "mma_sync"),
    (torch.bfloat16, 32, "mma_sync"), (torch.float32, 128, "fma"),
    (torch.float32, 32, "fma")])
def test_flash_bwd_route(dtype, hd, route):
    assert fa.flash_bwd_route(dtype, hd) == route
    with pytest.raises(ValueError, match="head size"):
        fa.flash_bwd_route(dtype, 48)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_route_refuses_hd_256(dtype):
    # gemma-7b's head size has a forward kernel and no backward yet: the
    # route raises by name, before any launch
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        fa.flash_bwd_route(dtype, 256)


@pytest.mark.parametrize("S,rows", [(1, 256), (128, 256), (129, 512),
                                    (8192, 16384)])
def test_flash_bwd_scratch_pads_the_wgmma_rows(S, rows):
    # the wgmma route's lse and D, each padded to a multiple of 128 rows;
    # the other routes' D (B, H, S) is a prefix of it
    scratch = fa.flash_bwd_scratch(2, 3, S, "cpu")
    assert scratch.shape == (2, 3, rows) and scratch.dtype == torch.float32
    assert scratch.numel() >= 2 * 3 * S


def test_flash_route_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="head size"):
        fa.flash_route(torch.bfloat16, 48)
    with pytest.raises(TypeError, match="bf16 or f32"):
        fa.flash_route(torch.float16, 128)


@pytest.mark.parametrize("dtype,K,N,route", [
    (torch.bfloat16, 4096, 4096, "wgmma"), (torch.bfloat16, 4096, 512, "wgmma"),
    (torch.bfloat16, 11008, 4096, "wgmma"), (torch.bfloat16, 8, 8, "wgmma"),
    (torch.bfloat16, 300, 200, "mma_sync"), (torch.bfloat16, 4096, 100, "mma_sync"),
    (torch.bfloat16, 33, 70, "mma_sync"), (torch.bfloat16, 0, 8, "mma_sync"),
    (torch.float32, 4096, 4096, "fma"), (torch.float32, 300, 200, "fma")])
def test_lora_route(dtype, K, N, route):
    assert lm.lora_route(dtype, K, N) == route


def test_lora_route_refuses_what_no_kernel_takes():
    with pytest.raises(TypeError, match="bf16 or f32"):
        lm.lora_route(torch.float16, 64, 64)


def test_yi_9b_takes_the_wgmma_kernels():
    # every projection of the long-prompt path and its attention
    cfg = get_config("yi-9b")
    D, H, KV, hd, F = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd,
                       cfg.d_ff)
    for K, N in ((D, H * hd), (D, KV * hd), (H * hd, D), (D, F), (F, D)):
        assert lm.lora_route(torch.bfloat16, K, N) == "wgmma", (K, N)
    assert fa.flash_route(torch.bfloat16, hd) == "wgmma"


@pytest.mark.parametrize("arch,route", [
    ("yi-9b", "wgmma"), ("minitron-8b", "wgmma"), ("qwen3-32b", "wgmma"),
    ("gemma-7b", "hd256")])
def test_every_arch_has_a_flash_forward_route(arch, route):
    # every long prompt of the registry's archs reaches a forward kernel
    assert fa.flash_route(torch.bfloat16, get_config(arch).hd) == route


def test_route_counts_start_empty_and_reset():
    f = _build.CudaFunction("lora_matmul", "lora_matmul_fwd", [])
    assert f.launches == 0 and f.launches_by_route == {}
    f.launches, f.launches_by_route["wgmma"] = 3, 3
    f.reset()
    assert f.launches == 0 and f.launches_by_route == {}


def test_tag_counts_start_empty_and_reset():
    # the flash forward tags its windowed launches
    f = _build.CudaFunction("flash_attention", "flash_attention_fwd", [])
    assert f.launches_by_tag == {}
    f.launches, f.launches_by_tag["window"] = 2, 2
    f.reset()
    assert f.launches == 0 and f.launches_by_tag == {}


# chip_smoke.py's build report names each kernel as the CUDA toolkit's
# `cu++filt -p` demangles it (these are its outputs for nvcc's manglings of
# csrc/transport.cu and csrc/grouped_lora.cu kernels)
@pytest.mark.parametrize("demangled,name", [
    ("<unnamed>::pack_fill_kernel", "pack_fill_kernel"),
    ("void <unnamed>::bin_partial_kernel<(int)12>", "bin_partial_kernel<12>"),
    ("void <unnamed>::grouped_lora_cluster_kernel<(int)4, (bool)1>",
     "grouped_lora_cluster_kernel<4, 1>"),
    ("void <unnamed>::pack_scan_kernel<<unnamed>::NonzeroRows>",
     "pack_scan_kernel<NonzeroRows>"),
    ("void <unnamed>::pack_scan_kernel<<unnamed>::MaskQuantizeRows<(bool)1, "
     "(bool)0>>", "pack_scan_kernel<MaskQuantizeRows<1, 0>>"),
    ("void <unnamed>::flash_bwd_dkdv_bf16_kernel<(int)64>",
     "flash_bwd_dkdv_bf16_kernel<64>"),
    ("<unnamed>::flash_bwd_dkdv_wgmma_kernel", "flash_bwd_dkdv_wgmma_kernel"),
    ("void <unnamed>::flash_bwd_dot_kernel<__nv_bfloat16>",
     "flash_bwd_dot_kernel<__nv_bfloat16>"),
])
def test_build_report_names_kernels_with_their_template_arguments(demangled,
                                                                  name):
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    assert chip_smoke.short_name(demangled) == name
    assert name in chip_smoke.GATED_KERNELS


def test_build_report_names_the_hd_256_forward_kernel():
    # phase 1 reports every forward kernel of csrc/flash_attention.cu with
    # its registers, shared memory and spills; the hd-256 route's wgmma
    # kernel is gated (no stack, no spill, no serialised wgmma) and the
    # mma.sync kernel it replaced is no longer looked for
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    assert chip_smoke.short_name("<unnamed>::flash_wgmma_hd256_kernel"
                                 ) == "flash_wgmma_hd256_kernel"
    assert "flash_wgmma_hd256_kernel" in chip_smoke.GATED_KERNELS
    assert "flash_wgmma_hd256_kernel" in chip_smoke.HOPPER_KERNELS
    assert "flash_bf16_kernel<256>" not in chip_smoke.FLASH_FWD_KERNELS
    assert "flash_f32_kernel<256>" in chip_smoke.FLASH_FWD_KERNELS
    assert "flash_wgmma_kernel" in chip_smoke.GATED_KERNELS
