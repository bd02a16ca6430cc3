"""The kernel build's cache key: a library is named by a hash of its source,
every ``csrc/`` header the source includes and the flags, so an edited
header or a changed flag builds anew.  Nothing is compiled here."""

import pytest

from snd_vae_tpu_torch.nn.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path.resolve())
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    (tmp_path / "k.cu").write_text('#include <cstdint>\n#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text('#pragma once\n#include "a.cuh"\n')   # a cycle
    (tmp_path / "other.cuh").write_text("int unrelated;\n")
    return tmp_path


def test_sources_follow_includes(csrc):
    assert [p.name for p in build.sources("k")] == ["k.cu", "a.cuh", "b.cuh"]


@pytest.mark.parametrize("edit", ["k.cu", "a.cuh", "b.cuh"])
def test_editing_a_source_or_header_renames_the_library(csrc, edit):
    before = build.library_path("k")
    (csrc / edit).write_text((csrc / edit).read_text() + "// edited\n")
    assert build.library_path("k") != before


def test_an_unincluded_file_leaves_the_library(csrc):
    before = build.library_path("k")
    (csrc / "other.cuh").write_text("int changed;\n")
    assert build.library_path("k") == before


def test_a_changed_flag_renames_the_library(csrc, monkeypatch):
    before = build.library_path("k")
    monkeypatch.setattr(build, "NVCC_FLAGS", (*build.NVCC_FLAGS, "-DEXTRA"))
    assert build.library_path("k") != before


@pytest.mark.parametrize("name", build.KERNELS)
def test_each_port_kernel_hashes_what_it_includes(name):
    got = [p.name for p in build.sources(name)]
    assert got[0] == f"{name}.cu" and len(set(got)) == len(got)
    assert build.library_path(name).name.startswith(f"lib{name}_")
    if name == "adj_matmul":
        assert "hopper.cuh" in got
