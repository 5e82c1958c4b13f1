"""The kernel library's build cache (``kernels/build.py``), on the CPU: no
compiler runs here, so these tests hold the cache's bookkeeping, not nvcc."""

import shutil

import pytest

from lyricalignment_tpu_torch.kernels import build


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, src)
    monkeypatch.setattr(build, "CSRC_DIR", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    return src


@pytest.mark.parametrize("name", ["hopper.cuh", "attention.cuh", "attention.cu"])
def test_digest_covers_sources_and_headers(csrc_copy, name):
    before = build._digest()
    path = csrc_copy / name
    path.write_text(path.read_text() + "\n// edited\n")
    assert build._digest() != before


def test_reused_library_reports_its_build_log(csrc_copy, monkeypatch):
    """A library already built from the same sources is reused without
    nvcc, and the log written beside it (ptxas' register and spill lines)
    comes back in ``build_info``."""
    monkeypatch.setattr(build, "build_info", {})
    target = build.BUILD_DIR / f"libla_kernels-{build._digest()}.so"
    target.parent.mkdir(parents=True)
    target.write_bytes(b"")
    log = "== attention.cu\nptxas info    : Used 128 registers\n"
    target.with_suffix(".log").write_text(log)
    monkeypatch.setattr(build, "_nvcc", lambda: pytest.fail("nvcc must not run"))
    assert build.build() == target
    assert build.build_info["cached"] is True
    assert build.build_info["log"] == log
