"""The port's kernel build on a machine without nvcc: the library's name
follows its source, every shared header under csrc/ and the flags, so that
an edit to a header rebuilds every library that may include it."""

import shutil

import pytest

from ssl_tpu_torch.ops import cuda_build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of csrc/ that the build reads instead."""
    copy = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, copy)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", copy)
    return copy


@pytest.mark.parametrize("name", ["flash_attn_fwd", "flash_attn_bwd", "ssg_loss_fwd"])
def test_header_edit_renames_the_library(csrc, name):
    before = cuda_build.library_path(name)
    assert before == cuda_build.library_path(name)          # the same files, the same name
    header = csrc / "tf32_mma.cuh"
    header.write_text(header.read_text() + "\n// an edit\n")
    edited = cuda_build.library_path(name)
    assert edited != before
    (csrc / "more_helpers.cuh").write_text("#pragma once\n")     # a new header counts too
    assert cuda_build.library_path(name) not in (before, edited)


def test_source_edit_renames_only_its_library(csrc):
    names = ("flash_attn_fwd", "flash_attn_bwd", "ssg_loss_fwd")
    before = {n: cuda_build.library_path(n) for n in names}
    src = csrc / "flash_attn_fwd.cu"
    src.write_text(src.read_text() + "\n// an edit\n")
    after = {n: cuda_build.library_path(n) for n in names}
    assert [n for n in names if after[n] != before[n]] == ["flash_attn_fwd"]
