"""The port's kernel-build cache key (``tpu_nexus_torch/ops/_build.py``).

The library is cached under ``build/`` by a hash of what the compiler
reads: every ``csrc/*.cu`` source, every ``csrc/*.cuh`` header a source can
include, and the compile and link flags.  A change to any of them must name
a new library, or a stale one would be loaded.  These tests edit a copy of
the ``csrc`` tree; nothing is compiled (no ``nvcc`` is needed).
"""

import shutil

import pytest

from tpu_nexus_torch.ops import _build


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def test_the_tree_has_a_header_and_the_key_is_stable(csrc_copy):
    assert sorted(p.name for p in csrc_copy.glob("*.cuh")), "csrc holds no header"
    assert _build.library_path() == _build.library_path()
    assert _build.library_path().name.startswith("libnexus_kernels_")


@pytest.mark.parametrize("suffix", [".cuh", ".cu"])
def test_a_changed_file_names_a_new_library(csrc_copy, suffix):
    before = _build.library_path()
    target = sorted(csrc_copy.glob(f"*{suffix}"))[0]
    target.write_text(target.read_text() + "\n// changed\n")
    after = _build.library_path()
    assert after != before
    target.write_text(target.read_text()[: -len("\n// changed\n")])
    assert _build.library_path() == before  # the same tree, the same library


def test_a_new_header_names_a_new_library(csrc_copy):
    before = _build.library_path()
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path() != before


def test_a_file_outside_the_sources_and_headers_does_not_matter(csrc_copy):
    before = _build.library_path()
    (csrc_copy / "notes.txt").write_text("not compiled\n")
    assert _build.library_path() == before


@pytest.mark.parametrize("flags", ["NVCC_FLAGS", "LINK_FLAGS"])
def test_a_changed_flag_names_a_new_library(csrc_copy, monkeypatch, flags):
    before = _build.library_path()
    monkeypatch.setattr(_build, flags, getattr(_build, flags) + ("-DNEXUS_PROBE",))
    assert _build.library_path() != before

