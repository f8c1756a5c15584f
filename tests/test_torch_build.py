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
                                "grouped_lora", "lora_matmul",
                                "selective_scan", "transport"]
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
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "hd64"),
    (torch.bfloat16, 32, "mma_sync"), (torch.float32, 128, "fma"),
    (torch.float32, 64, "fma"), (torch.float32, 32, "fma"),
    (torch.bfloat16, 256, "hd256"), (torch.float32, 256, "fma")])
def test_flash_route(dtype, hd, route):
    # the forward's kernels: bf16 at gemma-7b's hd 256 takes the hd256
    # route, at hymba-1.5b's hd 64 the hd64 route, f32 the FMA one at every
    # head size
    assert fa.flash_route(dtype, hd) == route
    assert fa.ROUTES[route] in (0, 1, 2, 3, 4)


@pytest.mark.parametrize("dtype,hd,forward,backward", [
    (torch.bfloat16, 64, "hd64", "mma_sync"),
    (torch.bfloat16, 32, "mma_sync", "mma_sync"),
    (torch.bfloat16, 128, "wgmma", "wgmma"),
    (torch.bfloat16, 256, "hd256", "hd256"),
    (torch.float32, 64, "fma", "fma")])
def test_flash_route_names_the_forward_and_the_backward_apart(
        dtype, hd, forward, backward):
    # bf16 at hd 64: the forward on the hd64 kernel, its backward on the
    # mma_sync kernels (which read the lse the forward writes); every
    # other (dtype, hd) takes one route both ways
    assert fa.flash_route(dtype, hd) == forward
    assert fa.flash_route(dtype, hd, backward=False) == forward
    assert fa.flash_route(dtype, hd, backward=True) == backward
    assert fa.ROUTES["hd64"] == 4 and fa.ROUTES["mma_sync"] == 1


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
    ("gemma-7b", "hd256"), ("hymba-1.5b", "hd64")])
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
    ("void <unnamed>::selective_scan_kernel<(int)16, __nv_bfloat16>",
     "selective_scan_kernel<16, __nv_bfloat16>"),
    ("void <unnamed>::selective_scan_kernel<(int)8, float>",
     "selective_scan_kernel<8, float>"),
    ("void <unnamed>::selective_scan_chunk_kernel<(int)16, __nv_bfloat16>",
     "selective_scan_chunk_kernel<16, __nv_bfloat16>"),
    ("void <unnamed>::selective_scan_carry_kernel<(int)8>",
     "selective_scan_carry_kernel<8>"),
    ("void <unnamed>::flash_wgmma_kernel<(int)128>", "flash_wgmma_kernel<128>"),
    ("void <unnamed>::flash_wgmma_kernel<(int)64>", "flash_wgmma_kernel<64>"),
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
    assert "flash_wgmma_kernel<128>" in chip_smoke.GATED_KERNELS


def test_build_report_names_the_hd_256_backward_kernels():
    # phase 1 reports the backward's hd-256 kernels (route hd256: lse and D,
    # then the TMA + wgmma dK / dV and dQ kernels and their window twins;
    # route fma's f32 pair) with their registers, shared memory and spills;
    # the route's wgmma kernels are gated Hopper kernels (no stack, no
    # spill, no serialised wgmma), and the first version's kernels it
    # replaced (the warp-pair dK / dV, mma.sync's dQ at hd 256) are no
    # longer looked for
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    wgmma = ("flash_bwd_dkdv_wgmma_hd256_kernel",
             "flash_bwd_dq_wgmma_hd256_kernel",
             "flash_bwd_dkdv_wgmma_hd256_window_kernel",
             "flash_bwd_dq_wgmma_hd256_window_kernel")
    for name in wgmma:
        assert name in chip_smoke.HOPPER_KERNELS, name
        assert name in chip_smoke.GATED_KERNELS, name
        assert chip_smoke.short_name(f"<unnamed>::{name}") == name
    for name in ("flash_bwd_rows_kernel<128>", "flash_bwd_rows_kernel<256>",
                 "flash_bwd_dkdv_f32_kernel<256>",
                 "flash_bwd_dq_f32_kernel<256>"):
        assert name in chip_smoke.GATED_KERNELS, name
    assert chip_smoke.short_name(
        "void <unnamed>::flash_bwd_rows_kernel<(int)256>"
    ) == "flash_bwd_rows_kernel<256>"
    assert chip_smoke.FLASH_BWD_HD256 == (
        "flash_bwd_rows_kernel<256>", "flash_bwd_dkdv_wgmma_hd256_kernel",
        "flash_bwd_dq_wgmma_hd256_kernel")
    reported = (chip_smoke.GATED_KERNELS + chip_smoke.FLASH_BWD_REPORTED
                + chip_smoke.FLASH_FWD_KERNELS)
    for gone in ("flash_bwd_dkdv_hd256_kernel", "flash_bwd_dq_bf16_kernel<256>",
                 "flash_bwd_dq_bf16_window_kernel<256>",
                 "flash_bwd_rows_kernel"):
        assert gone not in reported, gone
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    for gone in ("flash_bwd_dkdv_hd256_kernel", "DkvHd256Smem",
                 "kThreadsHd256"):
        assert gone not in src, gone


# the first version's hd-256 dK / dV kernel as the parent tree declared it
# (route 3 before its TMA + wgmma redesign)
PARENT_HD256_DECL = """__global__ void __launch_bounds__(kThreadsHd256, 1)
flash_bwd_dkdv_hd256_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
"""


@pytest.mark.parametrize("tree,has", [("parent", True), ("this", True),
                                      ("neither", False)])
def test_flash_bwd_ab_finds_the_hd_256_backward_of_either_design(
        tmp_path, tree, has):
    # scripts/flash_bwd_ab.py runs the hd-256 cases and timings on every
    # tree with the bf16 hd-256 backward: the parent's first version and
    # this tree's redesign (so it times parent against child), and on no
    # tree without one
    scripts = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                           "scripts")
    sys.path.insert(0, scripts)
    try:
        import flash_bwd_ab
    finally:
        sys.path.remove(scripts)
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    text = {"parent": PARENT_HD256_DECL, "this": src,
            "neither": "\n".join(ln for ln in src.splitlines()
                                 if "hd256_kernel" not in ln)}[tree]
    (tmp_path / "flash_attention_bwd.cu").write_text(text)
    assert flash_bwd_ab.has_hd256(tmp_path) is has
    if tree == "this":
        assert flash_bwd_ab.has_hd256(_build.CSRC)
        assert flash_bwd_ab.route_of(_build.CSRC) == 0


def test_the_selective_scan_builds_from_its_source_without_a_header():
    # csrc/selective_scan.cu is in the build list, with a plain C entry
    # point; it includes no shared header, but an edited one still renames
    # its library (the hash covers every header)
    from repro_torch.kernels import selective_scan as ss
    src = (_build.CSRC / "selective_scan.cu").read_text()
    assert "selective_scan" in _build.sources()
    assert 'extern "C" int selective_scan_fwd(' in src
    assert '#include "hopper.cuh"' not in src
    assert (ss.SCAN.source, ss.SCAN.symbol) == ("selective_scan",
                                                "selective_scan_fwd")
    assert len(ss.SCAN.argtypes) == 17 and ss.SCAN.launches == 0
    assert ss.STATE_SIZES == (8, 16)


def _chip_smoke():
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    return chip_smoke


@pytest.mark.parametrize("arch,shapes", [
    ("hymba-1.5b", [(1600, 320), (1600, 1600), (1600, 6400), (3200, 1600)]),
    ("xlstm-1.3b", [(2048, 8192), (2752, 2048), (4096, 2048)])])
def test_phase_23_holds_the_grouped_kernel_at_each_decode_shape(arch, shapes):
    # chip_smoke.py's phase 23 holds grouped_pallas to grouped_ref at every
    # (K, N) that the arch's 2-D LoRA targets give its decode steps: hymba's
    # attention and Mamba projections, xLSTM's mLSTM down and sLSTM wx and
    # down (the headwise mLSTM wq / wk / wv take the per-lane gather)
    assert _chip_smoke().grouped_decode_shapes(arch) == shapes


def test_scan_bound_counts_the_sfu_and_fma_pipes_together():
    # an element of the scan is one exp2 and 4 FMA-pipe ops; a third of the
    # exps computed on the FMA pipes (4 ops each) balances the two pipes at
    # 1/24 clock an element an SM (the SFUs alone: 1/16)
    cs = _chip_smoke()
    assert cs.scan_clocks_per_element() == pytest.approx(1 / 24)
    ms, by = cs.scan_bound(1, 8192, 3200, 16, "bfloat16", False, 1.98e9, 132)
    assert by == "operations"
    assert ms == pytest.approx(8192 * 3200 * 16 / 24 / (132 * 1.98e9) * 1e3)


def test_build_report_names_the_hd_64_forward_and_the_chunked_scan():
    # phase 1 gates the hd64 route's wgmma kernel, route 0's template at hd
    # 64 (no stack, no spill, no serialised wgmma), and the scan's three
    # kernels at both state sizes; the forward's mma.sync kernel is built
    # at hd 32 alone
    cs = _chip_smoke()
    assert cs.HOPPER_KERNELS[0] == "flash_wgmma_kernel<128>"
    assert cs.HOPPER_KERNELS[-1] == "flash_wgmma_kernel<64>"
    for name in ("flash_wgmma_kernel<64>",
                 "selective_scan_chunk_kernel<16, float>",
                 "selective_scan_kernel<8, __nv_bfloat16>",
                 "selective_scan_carry_kernel<16>"):
        assert name in cs.GATED_KERNELS, name
    assert "flash_bf16_kernel<32>" in cs.FLASH_FWD_KERNELS
    assert "flash_bf16_kernel<64>" not in cs.FLASH_FWD_KERNELS
    src = (_build.CSRC / "flash_attention.cu").read_text()
    assert "route == 4 && dtype == 0 && hd == 64" in src
    assert "route == 1 && dtype == 0 && hd == 32)" in src
    assert 'extern "C" void flash_attention_hd64_config(' in src
    # one kernel template serves routes 0 and 4
    assert "launch_wgmma<128>" in src and "launch_wgmma<64>" in src
    assert "flash_wgmma_hd64_kernel" not in src


@pytest.mark.parametrize("S,scratch", [(1, False), (191, False), (192, False),
                                       (193, True), (8192, True)])
def test_scan_scratch_holds_each_chunks_state_and_dt_sum(S, scratch):
    # one chunk: no scratch (decode reads h0 itself); more: B nc di (N + 1)
    # floats, the chunks' states and their sums of dt
    from repro_torch.kernels import selective_scan as ss
    got = ss.scan_scratch(3, S, 100, 16, "cpu")
    if not scratch:
        assert got is None
    else:
        nc = -(-S // ss.CHUNK)
        assert got.dtype == torch.float32
        assert got.numel() == 3 * nc * 100 * 17


def test_scan_chunk_is_the_kernels_compile_time_length():
    # the wrapper sizes the scratch and tags chunked launches by CHUNK; the
    # kernels' chunk length is csrc/selective_scan.cu's kChunk, which the
    # entry point does not take
    from repro_torch.kernels import selective_scan as ss
    src = (_build.CSRC / "selective_scan.cu").read_text()
    assert f"constexpr int kChunk = {ss.CHUNK};" in src
    entry = src[src.index('extern "C" int selective_scan_fwd('):]
    assert "chunk" not in entry[:entry.index("{")]


def test_scan_edge_cases_straddle_the_chunk_length():
    # phase 23 (a)'s chunk edges at the kernels' L: a step short of a chunk,
    # one chunk, a step past it, two chunks and three steps, and three
    # chunks at B 4 from h0 and at N 8
    from repro_torch.kernels.selective_scan import CHUNK as L
    cases = _chip_smoke().scan_edge_cases()
    assert {S - L for B, S, *_ in cases if B == 1} == {-1, 0, 1, L + 3}
    assert all(len(c) == 6 and c[3] in (8, 16) for c in cases)
    assert {(B, N, -(-S // L)) for B, S, di, N, *_ in cases if B > 1} == {
        (4, 16, 3), (3, 8, 3)}


def test_the_ab_scripts_read_each_trees_entry_point(tmp_path):
    # scripts/scan_ab.py binds the first version's scan (no scratch) and
    # the chunked one; scripts/flash_ab.py runs hd 64 on the
    # hd64 route where a tree has it and on mma_sync where it does not
    scripts = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                           "scripts")
    sys.path.insert(0, scripts)
    try:
        import flash_ab
        import scan_ab
    finally:
        sys.path.remove(scripts)
    assert scan_ab.chunked(_build.CSRC)
    (tmp_path / "selective_scan.cu").write_text(
        'extern "C" int selective_scan_fwd(const void* u, void* h_last, '
        'int B, int dtype, void* stream) {}')
    assert not scan_ab.chunked(tmp_path)
    assert flash_ab.hd64_route(_build.CSRC) == 4
    (tmp_path / "flash_attention.cu").write_text(
        "(route == 1 && dtype == 0 && (hd == 32 || hd == 64))")
    assert flash_ab.hd64_route(tmp_path) == 1
