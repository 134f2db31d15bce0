"""Package logger (counterpart of sasvqa_tpu/core/logging.py ``LOGGER``).

Configures the package logger only, never the root logger, so an
embedding application keeps its own logging policy.
"""

from __future__ import annotations

import logging

_LOG_FMT = "%(asctime)s - %(levelname)s - %(name)s -   %(message)s"
_DATE_FMT = "%m/%d/%Y %H:%M:%S"

LOGGER = logging.getLogger("sasvqa_torch")
if not LOGGER.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter(_LOG_FMT, datefmt=_DATE_FMT))
    LOGGER.addHandler(_h)
    LOGGER.setLevel(logging.INFO)
    LOGGER.propagate = False
