"""The port's kernel build (``tpu_kubernetes_torch/ops/_build.py``) on the
CPU: a library's name hashes its ``.cu`` source and every ``csrc/*.cuh``
header, so an edit to a shared header rebuilds each library and an edit to
one source renames no other library. Nothing here runs ``nvcc``."""

import importlib
import shutil

import pytest

_build = importlib.import_module("tpu_kubernetes_torch.ops._build")


@pytest.fixture()
def tree(tmp_path, monkeypatch):
    """A csrc/ of three sources, two of them including one header, and an
    empty build directory."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "hopper.cuh").write_text("#pragma once\n// v1\n")
    (csrc / "a.cu").write_text('#include <cuda.h>\n#include "hopper.cuh"\n'
                               "int a;\n")
    (csrc / "b.cu").write_text('#include "hopper.cuh"\nint b;\n')
    (csrc / "c.cu").write_text("#include <cuda_runtime.h>\nint c;\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "SOURCES",
                        {n: f"{n}.cu" for n in ("a", "b", "c")})
    return csrc


def _paths():
    return {n: _build.library_path(n) for n in _build.SOURCES}


def test_a_header_edit_renames_every_library_that_includes_it(tree):
    before = _paths()
    (tree / "hopper.cuh").write_text("#pragma once\n// v2\n")
    after = _paths()
    assert after["a"] != before["a"]
    assert after["b"] != before["b"]
    assert all(p.parent == _build.BUILD_DIR and p.name.startswith(f"lib{n}-")
               for n, p in after.items())


def test_an_unrelated_source_edit_renames_only_its_library(tree):
    before = _paths()
    (tree / "c.cu").write_text("#include <cuda_runtime.h>\nint c2;\n")
    after = _paths()
    assert after["a"] == before["a"] and after["b"] == before["b"]
    assert after["c"] != before["c"]


def test_the_name_is_stable_while_nothing_changes(tree):
    assert _paths() == _paths()


@pytest.mark.parametrize("library", sorted(_build.SOURCES))
def test_each_port_library_is_renamed_by_a_header_edit(
        library, tmp_path, monkeypatch):
    """The port's own sources, copied: an edit to ``hopper.cuh`` renames
    each library; an edit to another library's source renames none."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.library_path(library)
    other = next(n for n in sorted(_build.SOURCES) if n != library)
    with open(csrc / _build.SOURCES[other], "a") as f:
        f.write("\n// edited\n")
    assert _build.library_path(library) == before
    with open(csrc / "hopper.cuh", "a") as f:
        f.write("\n// edited\n")
    assert _build.library_path(library) != before
