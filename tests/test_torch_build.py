"""The kernel build's cache key (``ecoflap_tpu_torch/ops/build.py``).

``library_path`` names the library that ``build`` compiles from
``csrc/<name>.cu``; the name carries a hash of what went into it, so an
edit rebuilds and a stale library is never loaded. These tests edit a copy
of a source tree under a temporary directory and need no ``nvcc``.
"""

from __future__ import annotations

import pytest

from ecoflap_tpu_torch.ops import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text('#include "shared.cuh"\nint a() { return 1; }\n')
    (src / "b.cu").write_text("int b() { return 2; }\n")
    (src / "shared.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(build, "CSRC_DIR", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    return src


def test_library_path_is_stable_and_under_build_dir(csrc):
    first = build.library_path("a")
    assert first == build.library_path("a")
    assert first.parent == build.BUILD_DIR
    assert first.name.startswith("liba-") and first.suffix == ".so"
    assert build.library_path("b") != first


@pytest.mark.parametrize("edit", ["source", "header", "new_header", "header_renamed",
                                  "flags"])
def test_edit_changes_library_path(csrc, monkeypatch, edit):
    before = build.library_path("a")
    if edit == "source":
        (csrc / "a.cu").write_text('#include "shared.cuh"\nint a() { return 3; }\n')
    elif edit == "header":
        (csrc / "shared.cuh").write_text("#pragma once\n#define X 1\n")
    elif edit == "new_header":
        (csrc / "other.cuh").write_text("#pragma once\n")
    elif edit == "header_renamed":
        (csrc / "shared.cuh").rename(csrc / "common.cuh")
    else:
        monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path("a") != before


@pytest.mark.parametrize("edit", ["other_source", "other_file"])
def test_unrelated_edit_keeps_library_path(csrc, edit):
    before = build.library_path("a")
    if edit == "other_source":
        (csrc / "b.cu").write_text("int b() { return 4; }\n")
    else:
        (csrc / "notes.txt").write_text("not a source\n")
    assert build.library_path("a") == before


def test_build_reuses_a_current_library(csrc):
    """A library already at its current path is loaded, not rebuilt (no
    ``nvcc`` here to build it)."""
    lib = build.library_path("a")
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"")
    assert build.build(["a"]) == {"a": (lib, "")}
