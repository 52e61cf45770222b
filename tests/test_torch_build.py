"""The kernel build's cache key: ``build.library_path`` names a library by
a hash of its source, of every shared header ``csrc/*.cuh`` and of the
flags, so an edit to any of them loads a fresh build and never a stale
one. Checked on a copy of ``csrc/`` (nothing is compiled here)."""
import shutil

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build as B  # noqa: E402


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(B.CSRC, copy)
    monkeypatch.setattr(B, "CSRC", copy)
    return copy


@pytest.mark.parametrize("name", B.KERNEL_SOURCES)
def test_library_path_follows_every_header(csrc, name):
    before = B.library_path(name)
    assert B.library_path(name) == before          # stable
    for header in sorted(csrc.glob("*.cuh")):
        header.write_bytes(header.read_bytes() + b"\n// edited\n")
        after = B.library_path(name)
        assert after != before, header.name
        before = after
    (csrc / "added.cuh").write_text("#pragma once\n")
    assert B.library_path(name) != before


def test_library_path_follows_its_source_and_no_other(csrc):
    flash = B.library_path("flash_attention")
    scan = B.library_path("ssd_scan")
    src = csrc / "ssd_scan.cu"
    src.write_bytes(src.read_bytes() + b"\n")
    assert B.library_path("ssd_scan") != scan
    assert B.library_path("flash_attention") == flash
