"""``kernels/build.py`` names each library by a digest of its source, of
every shared header in ``csrc/`` and of the flags, so an edited header
builds anew instead of loading a stale library.  No ``nvcc`` is needed:
only the names are computed."""
import shutil

import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc`` and an empty build directory."""
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    return copy


@pytest.mark.parametrize("name", ["lora_matmul", "int4_matmul",
                                  "statevector_gate"])
def test_editing_a_header_renames_every_library(csrc, name):
    before = build.library_path(name)
    assert before.parent == csrc.parent / "build"
    assert build.library_path(name) == before            # stable
    header = csrc / "tf32x3.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert build.library_path(name) != before


def test_a_new_header_renames_the_library(csrc):
    before = build.library_path("lora_matmul")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert build.library_path("lora_matmul") != before


def test_editing_a_source_renames_only_its_library(csrc):
    lm, i4 = build.library_path("lora_matmul"), build.library_path(
        "int4_matmul")
    src = csrc / "lora_matmul.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert build.library_path("lora_matmul") != lm
    assert build.library_path("int4_matmul") == i4


def test_the_kernels_include_the_shared_header():
    for name in ("lora_matmul", "int4_matmul"):
        text = (build.CSRC / f"{name}.cu").read_text()
        assert '#include "tf32x3.cuh"' in text
