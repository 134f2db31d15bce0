"""Device resolution for the port's entry points.

Entry points default to ``device="cuda"``.  Nothing falls back to the
CPU on its own: without a GPU the caller must ask for ``device="cpu"``
(the CPU tests do), otherwise :func:`resolve_device` raises.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    GPU is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
