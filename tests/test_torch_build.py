"""The kernel libraries' build hash: any edit to a kernel's source, to a
shared header or to the compiler flags must name a new library, so a stale
one never runs the old kernel on the card; an unchanged tree must keep its
name, so it is not rebuilt. Runs on the CPU on a copy of ``csrc/``."""

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
    assert "flash_fwd_sm90.cuh" in HEADERS and "mma_bf16.cuh" in HEADERS


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
