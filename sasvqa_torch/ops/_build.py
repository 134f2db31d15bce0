"""Build and load the port's hand-written CUDA kernels.

Each source under ``ops/csrc`` is compiled by ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, under ``ops/build/`` (listed
in .gitignore), at first use, and loaded with ``ctypes``.  The library's
file name carries a hash of its source and flags, so an edited source is
rebuilt.  :func:`build_all` starts one ``nvcc`` per source, all at once.

``launch_counts`` holds one integer per kernel.  A wrapper adds one where
it launches its kernel and nowhere else, so a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")

# kernel name -> source file under csrc/
SOURCES = {"git_flash_fwd": "git_flash_fwd.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launch_counts: Dict[str, int] = {name: 0 for name in SOURCES}
# nvcc's output per kernel from the last build in this process
# (-Xptxas -v: registers, shared memory, spills)
build_logs: Dict[str, str] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def count_launch(name: str) -> None:
    launch_counts[name] += 1


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(cuda_home, "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, SOURCES[name])
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile each named kernel (default: all) whose library is not
    built yet.  Returns the wall seconds until each compile finished."""
    names = list(SOURCES if names is None else names)
    with _lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = None
        procs = {}
        t0 = time.perf_counter()
        try:
            for name in names:
                out = library_path(name)
                if os.path.exists(out):
                    continue
                nvcc = nvcc or _nvcc()
                tmp = f"{out}.{os.getpid()}.tmp"
                cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
                       os.path.join(CSRC_DIR, SOURCES[name])]
                procs[name] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True), tmp, out)
            seconds, errors = {}, []
            for name, (proc, tmp, out) in procs.items():
                log, _ = proc.communicate()
                seconds[name] = time.perf_counter() - t0
                build_logs[name] = log
                if proc.returncode != 0:
                    errors.append(f"{name}: nvcc exited {proc.returncode}\n"
                                  f"{log}")
                else:
                    os.replace(tmp, out)  # atomic: no half-written library
        finally:
            for proc, _, _ in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if errors:
            raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
        return seconds


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(library_path(name))
                _libs[name] = lib
    return lib
