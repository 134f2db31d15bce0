"""Logging + scalar metrics (counterpart of sasvqa_tpu/core/logging.py).

Configures the package logger only, never the root logger, so an
embedding application keeps its own logging policy.  The scalar log is
plain JSONL (``scalars.jsonl``), mirrored to TensorBoard when the
``tensorboard`` package is importable (reference: src/utils/logger.py).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

_LOG_FMT = "%(asctime)s - %(levelname)s - %(name)s -   %(message)s"
_DATE_FMT = "%m/%d/%Y %H:%M:%S"

LOGGER = logging.getLogger("sasvqa_torch")
if not LOGGER.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter(_LOG_FMT, datefmt=_DATE_FMT))
    LOGGER.addHandler(_h)
    LOGGER.setLevel(logging.INFO)
    LOGGER.propagate = False


def add_log_to_file(log_path: str) -> logging.FileHandler:
    """Attach a file handler (reference: src/utils/logger.py:15-19) and
    return it, for the caller to remove and close when its run ends."""
    parent = os.path.dirname(log_path)
    if parent:                       # makedirs("") raises on bare names
        os.makedirs(parent, exist_ok=True)
    fh = logging.FileHandler(log_path)
    fh.setFormatter(logging.Formatter(_LOG_FMT, datefmt=_DATE_FMT))
    LOGGER.addHandler(fh)
    return fh


class ScalarLogger:
    """Step-indexed scalar logger.

    Writes JSONL to ``<dir>/scalars.jsonl`` and, when the ``tensorboard``
    package is importable, mirrors to TB summaries.  API mirrors the
    reference TensorboardLogger (src/utils/logger.py:22-64): a mutable
    ``global_step`` plus ``log_scalar_dict`` with recursive dict flatten.
    """

    def __init__(self):
        self._file = None
        self._tb = None
        self.global_step = 0

    def create(self, path: str) -> None:
        self.close()   # re-create in one process must not leak handles
        os.makedirs(path, exist_ok=True)
        self._file = open(os.path.join(path, "scalars.jsonl"), "a")
        try:  # optional tensorboard mirror
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(path)

    def add_scalar(self, tag: str, value: float, step: Optional[int] = None):
        if self._file is None:
            return
        step = self.global_step if step is None else step
        self._file.write(json.dumps(
            {"step": step, "tag": tag, "value": float(value),
             "time": time.time()}) + "\n")
        self._file.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def log_scalar_dict(self, log_dict: Dict, prefix: str = ""):
        """Concatenate prefixes for nested dicts (ref logger.py:44-56)."""
        if self._file is None:
            return
        if prefix:
            prefix = f"{prefix}_"
        for key, value in log_dict.items():
            if isinstance(value, dict):
                self.log_scalar_dict(value, prefix=f"{prefix}{key}")
            else:
                try:
                    self.add_scalar(f"{prefix}{key}", float(value))
                except (TypeError, ValueError):
                    pass

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None


TB_LOGGER = ScalarLogger()


class RunningMeter:
    """Exponential moving-average meter (reference: src/utils/logger.py:67-89)."""

    def __init__(self, name: str, val: Optional[float] = None,
                 smooth: float = 0.99):
        assert 0 < smooth < 1
        self._name = name
        self._sm = smooth
        self._val = val

    def __call__(self, value: float):
        value = float(value)
        if value != value:  # skip NaN, same as reference
            return
        self._val = (value if self._val is None
                     else value * (1 - self._sm) + self._val * self._sm)

    def __str__(self):
        return f"{self._name}: {self._val:.4f}" if self._val is not None \
            else f"{self._name}: None"

    @property
    def val(self) -> float:
        return self._val if self._val is not None else 0.0


class AverageMeter:
    """Running average (reference: src/utils/basic_utils.py:125-150)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class NoOp:
    """Swallow any call — for non-primary hosts (reference: src/utils/misc.py:26-31)."""

    def __getattr__(self, name):
        return lambda *args, **kwargs: None
