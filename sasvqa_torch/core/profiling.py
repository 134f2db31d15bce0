"""Timing and tracing helpers (counterpart of sasvqa_tpu/core/profiling.py).

- ``Timer``: tic/toc wall-clock averaging, with the API of the
  reference's never-called Timer (preprocessing/datautils/utils.py:
  118-140);
- ``StepTimer``: per-stage wall-clock meters with percentiles;
- ``annotate`` / ``trace``: a named range in a ``torch.profiler`` trace,
  and a profile of a block written as a Chrome trace;
- ``synced``: waits for the GPU work that produces a tensor, so that a
  host clock read after it times the work and not its enqueue.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch


class Timer:
    """tic/toc averaging timer."""

    def __init__(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0
        self.average_time = 0.0

    def tic(self):
        self.start_time = time.time()

    def toc(self, average: bool = True) -> float:
        self.diff = time.time() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        self.average_time = self.total_time / self.calls
        return self.average_time if average else self.diff


def _tensors(x: Any) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def synced(x: Any) -> Any:
    """Synchronize every CUDA device that holds a tensor of ``x`` (a
    tensor, or a dict / list / tuple of them); CPU tensors and other
    values pass as they are.  Returns ``x``."""
    for dev in {t.device for t in _tensors(x) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return x


class StepTimer:
    """Per-stage wall-clock meters: use ``with step_timer.stage("data"):``.

    ``summary()`` -> {stage: {mean_ms, p50_ms, p95_ms, count}}.
    """

    def __init__(self, max_samples: int = 1000):
        self._samples: Dict[str, list] = defaultdict(list)
        self._max = max_samples

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            samples = self._samples[name]
            samples.append(time.perf_counter() - t0)
            if len(samples) > self._max:
                del samples[: len(samples) - self._max]

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, samples in self._samples.items():
            arr = np.asarray(samples) * 1e3
            out[name] = dict(mean_ms=float(arr.mean()),
                             p50_ms=float(np.percentile(arr, 50)),
                             p95_ms=float(np.percentile(arr, 95)),
                             count=len(arr))
        return out


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range in the ``torch.profiler`` trace."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Profile the block (CPU, and CUDA where a GPU is visible) and write
    ``log_dir``/trace.json, a Chrome trace; no-op if ``log_dir`` is
    None."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
