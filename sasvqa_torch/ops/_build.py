"""Build and load the port's hand-written CUDA kernels.

Each source under ``ops/csrc`` is compiled by ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, under ``ops/build/`` (listed
in .gitignore), at first use, and loaded with ``ctypes``.  The library's
file name carries a hash of its source and flags, so an edited source is
rebuilt: the hash covers the source and every header it includes from
``csrc/``.  :func:`build_all` starts one ``nvcc`` per source, all at
once.

``launch_counts`` holds one integer per kernel.  A wrapper adds one where
it launches its kernel and nowhere else, so a run can show that its main
path went through the kernels.  ``HASH_DROPOUT`` counts the kernel
launches that ran the in-kernel dropout hash (``rate`` > 0): K1, K2, and
each of K3's two kernels.  The libraries ``git_flash_bwd_split`` (K3)
and ``flash_bwd`` (K6) hold two kernels each, counted apart as
``git_flash_bwd_dq``/``git_flash_bwd_dkv`` and
``flash_bwd_dq``/``flash_bwd_dkv``; ``git_flash_bwd`` (K2) also holds
its reduction-only instrument, which no counter counts.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")

# kernel name -> source file under csrc/
SOURCES = {"git_flash_fwd": "git_flash_fwd.cu",
           "git_flash_bwd": "git_flash_bwd.cu",
           "git_flash_bwd_split": "git_flash_bwd_split.cu",
           "flash_fwd": "flash_fwd.cu",
           "flash_bwd": "flash_bwd.cu"}
HASH_DROPOUT = "hash_dropout"
COUNTERS = ("git_flash_fwd", "git_flash_bwd", "git_flash_bwd_dq",
            "git_flash_bwd_dkv", HASH_DROPOUT, "flash_fwd", "flash_bwd_dq",
            "flash_bwd_dkv")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launch_counts: Dict[str, int] = {name: 0 for name in COUNTERS}
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


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _source_files(name: str):
    """The kernel's source and, transitively, every header it includes
    from ``csrc/`` (quoted includes), in a fixed order."""
    seen, todo = [], [SOURCES[name]]
    while todo:
        rel = todo.pop(0)
        if rel in seen:
            continue
        seen.append(rel)
        with open(os.path.join(CSRC_DIR, rel), "rb") as f:
            todo += [m.decode() for m in _INCLUDE.findall(f.read())
                     if os.path.exists(os.path.join(CSRC_DIR, m.decode()))]
    return seen


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for rel in _source_files(name):
        with open(os.path.join(CSRC_DIR, rel), "rb") as f:
            digest.update(rel.encode() + b"\0" + f.read())
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


def raise_on_error(name: str, err: int) -> None:
    """Raise if the C launcher of library ``name`` returned a CUDA error
    (a refused launch never runs, and a later synchronize does not report
    it)."""
    if err != 0:
        fn = load(name).kernel_error_string
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name} launch failed (code {err}): "
                           + fn(err).decode())


def kernel_ready(x):
    """A bf16 (B, H, S, 64) view the kernels can read through its strides:
    unit stride on Dh, 16-byte aligned rows.  Anything else is copied."""
    aligned = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
               and all(st % 8 == 0 for st in x.stride()[:-1]))
    return x if aligned else x.contiguous()


def tma_ready(x):
    """:func:`kernel_ready`, and a copy where an axis of extent > 1 has
    stride 0 (an expanded view): a TMA tensor map takes no zero stride."""
    x = kernel_ready(x)
    if any(st == 0 and n > 1 for st, n in zip(x.stride(), x.shape)):
        return x.contiguous()
    return x
