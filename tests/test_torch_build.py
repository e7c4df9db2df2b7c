"""The kernel libraries' build hash: any edit to a kernel's source, to a
shared header or to the compiler flags must name a new library, so a stale
one never runs the old kernel on the card; an unchanged tree must keep its
name, so it is not rebuilt. Runs on the CPU on a copy of ``csrc/``."""

import re
import shutil

import pytest

from agent_tpu_torch.kernels import build

NAMES = sorted(p.stem for p in build.SRC_DIR.glob("*.cu"))
HEADERS = sorted(p.name for p in build.SRC_DIR.glob("*.cuh"))


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A copy of csrc/ that build reads instead of the package's."""
    src = tmp_path / "csrc"
    shutil.copytree(build.SRC_DIR, src)
    monkeypatch.setattr(build, "SRC_DIR", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    return src


def _targets():
    return {name: build._target(name) for name in NAMES}


def _edit(path):
    path.write_text(path.read_text() + "\n// edited\n")


def test_sources_present():
    assert NAMES == ["flash_attention", "flash_attention_bwd"]
    assert HEADERS == ["flash_bwd_sm90.cuh", "flash_fwd_sm90.cuh", "sm90_common.cuh"]


def _includes(name):
    return re.findall(r'^#include "([^"]+)"', (build.SRC_DIR / name).read_text(), re.M)


def test_sm90_kernels_share_one_header_of_primitives():
    """The forward's and the backward's TMA + wgmma kernels include one
    header of primitives, each through its own source, and every primitive
    is defined there alone."""
    assert "sm90_common.cuh" in _includes("flash_fwd_sm90.cuh")
    assert "sm90_common.cuh" in _includes("flash_bwd_sm90.cuh")
    assert "flash_fwd_sm90.cuh" in _includes("flash_attention.cu")
    assert "flash_bwd_sm90.cuh" in _includes("flash_attention_bwd.cu")
    sources = {p.name: p.read_text() for p in build.SRC_DIR.glob("*.cu*")}
    for primitive in ("mbar_wait", "tma_load", "tma_store", "smem_desc", "wgmma_rs_m64n64",
                      "wgmma_ss_m64n64", "wgmma_pv", "fence_regs", "ex2", "pack_f32",
                      "encode_tiled_fn", "encode_map"):
        defined = [n for n, text in sources.items()
                   if re.search(rf"\b(?:void|int|float|uint32_t|uint64_t) {primitive}\(", text)]
        assert defined == ["sm90_common.cuh"], (primitive, defined)


def _sources() -> dict:
    return {p.name: p.read_text() for p in build.SRC_DIR.glob("*.cu*")}


def test_no_mma_sync_forward_is_left():
    """Every bf16 forward (serving, training, the ring's fold, T5) is the TMA
    + wgmma kernel: the mma.sync forward and its tensor-core helper are gone
    from every source, and launch_fwd's bf16 branch calls sm90::launch
    alone."""
    for name, text in _sources().items():
        assert "flash_fwd_bf16" not in text and "mma_16816" not in text, name
        assert "mma.sync" not in text, name
    text = (build.SRC_DIR / "flash_attention.cu").read_text()
    body = text[text.index("int launch_fwd("):]
    bf16 = body[body.index("if (is_bf16) {"):body.index("} else {")]
    calls = re.findall(r"(\w+(?:::\w+)*)\s*<[^<>]*>\s*\(", bf16)
    assert calls and set(calls) == {"sm90::launch"}, calls
    assert "<<<" not in bf16


def test_sm90_forward_carries_state_as_a_template_flag():
    """The ring's fold is flash_fwd_sm90's CarryState instantiation, its
    launcher has the same flags, and flash_attention_fold reaches it."""
    text = (build.SRC_DIR / "flash_fwd_sm90.cuh").read_text()
    assert re.search(r"template <int D, bool WriteLse, bool CarryState, bool RelBias>\s*"
                     r"__global__ void __launch_bounds__\([^)]*\)\s*flash_fwd_sm90\(", text)
    assert re.search(r"template <int D, bool WriteLse, bool CarryState, bool RelBias>\s*"
                     r"int launch\(", text)
    assert "flash_fwd_sm90<D, WriteLse, CarryState, RelBias>" in text
    fold = (build.SRC_DIR / "flash_attention.cu").read_text()
    assert "launch_fwd<false, true>" in fold[fold.index("int flash_attention_fold("):]


def test_bf16_backward_has_no_mma_sync_kernel():
    """The bf16 dQ and dK/dV are the TMA + wgmma kernels at every d_head;
    only the f32 FMA kernels stay beside them."""
    text = (build.SRC_DIR / "flash_attention_bwd.cu").read_text()
    assert "flash_bwd_dq_bf16" not in text and "flash_bwd_dkv_bf16" not in text
    assert "mma_16816" not in text and "launch_dq<" in text and "launch_dkv<" in text


def test_unchanged_tree_keeps_its_libraries(tree):
    first = _targets()
    assert _targets() == first
    for name, so in first.items():
        assert so.parent == build.BUILD_DIR and so.name.startswith(f"{name}-")
        assert so.suffix == ".so"


@pytest.mark.parametrize("name", NAMES)
def test_editing_a_source_renames_only_its_library(tree, name):
    before = _targets()
    _edit(tree / f"{name}.cu")
    after = _targets()
    assert after[name] != before[name]
    assert all(after[n] == before[n] for n in NAMES if n != name)


@pytest.mark.parametrize("header", HEADERS)
def test_editing_a_header_renames_every_library(tree, header):
    before = _targets()
    _edit(tree / header)
    after = _targets()
    assert all(after[n] != before[n] for n in NAMES)


def test_a_new_header_renames_every_library(tree):
    before = _targets()
    (tree / "extra.cuh").write_text("#pragma once\n")
    after = _targets()
    assert all(after[n] != before[n] for n in NAMES)


def test_other_flags_rename_every_library(tree, monkeypatch):
    before = _targets()
    monkeypatch.setattr(build, "NVCC_FLAGS", (*build.NVCC_FLAGS, "-lineinfo"))
    after = _targets()
    assert all(after[n] != before[n] for n in NAMES)
