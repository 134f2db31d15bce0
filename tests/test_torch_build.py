"""The kernel build (``sasvqa_torch/ops/_build.py``) with a stand-in nvcc:
a library named by the hash of its sources and flags, nvcc's log kept
beside it so that a run reusing a built library still reports ptxas's
registers and spills, and no library left by a failed compile."""

import os

import pytest

from sasvqa_torch.ops import _build

FAKE_NVCC = """#!/bin/sh
# writes the file named after -o and prints one ptxas line
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
echo "ptxas info    : Used 128 registers, 0 bytes spill stores"
[ -n "$FAIL" ] && exit 1
: > "$out"
"""


@pytest.fixture
def fake_cuda(tmp_path, monkeypatch):
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.delenv("FAIL", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "build_logs", {})
    return monkeypatch


def test_a_built_library_keeps_its_nvcc_log(fake_cuda):
    assert set(_build.build_all(["flash_fwd"])) == {"flash_fwd"}
    assert os.path.exists(_build.library_path("flash_fwd"))
    assert "128 registers" in _build.build_logs["flash_fwd"]
    # a second build finds the library, runs no nvcc and reads the log
    _build.build_logs.clear()
    assert _build.build_all(["flash_fwd"]) == {}
    assert "128 registers" in _build.build_logs["flash_fwd"]


def test_a_failed_compile_raises_and_leaves_no_library(fake_cuda):
    fake_cuda.setenv("FAIL", "1")
    with pytest.raises(RuntimeError, match="flash_fwd: nvcc exited 1"):
        _build.build_all(["flash_fwd"])
    assert not os.path.exists(_build.library_path("flash_fwd"))
    assert not os.path.exists(_build.library_path("flash_fwd") + ".log")
