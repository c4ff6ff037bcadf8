"""`kernels/build.lib_path` names each library by a hash of its source,
every shared header (`csrc/*.cuh`) and the nvcc flags, so an edited source
or header is never served a stale library. Runs on the CPU: it only hashes
files in a copy of `csrc/` and needs no nvcc."""
import shutil

import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    return copy


@pytest.mark.parametrize("name", build.SOURCES)
def test_lib_path_changes_with_a_shared_header(csrc, name):
    before = build.lib_path(name)
    assert build.lib_path(name) == before
    header = csrc / "mma_bf16.cuh"
    header.write_bytes(header.read_bytes() + b"\n// one more line\n")
    after = build.lib_path(name)
    assert after != before
    assert after.parent == before.parent and after.name.startswith(name)
    assert not build.BUILD_DIR.exists()      # naming builds nothing


def test_lib_path_changes_with_a_new_header(csrc):
    before = build.lib_path("flash_attention")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert build.lib_path("flash_attention") != before


def test_lib_path_follows_only_its_own_source(csrc):
    flash, paged = (build.lib_path(n) for n in ("flash_attention",
                                                "paged_attention"))
    src = csrc / "flash_attention.cu"
    src.write_bytes(src.read_bytes() + b"\n")
    assert build.lib_path("flash_attention") != flash
    assert build.lib_path("paged_attention") == paged
