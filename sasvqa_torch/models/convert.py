"""Flax parameter tree -> port state dict.

The port's submodules carry the Flax parameter paths' names, so the
carry-over is one rule per leaf (the inverse of the naming in
sasvqa_tpu/models/convert.py):

- ``kernel`` (in, out)  -> ``weight`` (out, in), transposed
- ``scale``             -> ``weight``   (LayerNorm)
- ``embedding``         -> ``weight``   (Embed)
- ``bias``              -> ``bias``
- ``class_embedding``, ``position_embedding`` (raw parameters, BLIP's
  vision tower) -> themselves
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested dict of arrays (``model.init(...)["params"]`` as numpy, or
    the whole ``{"params": ...}`` variables) -> ``{dotted name: tensor}``
    for ``load_state_dict(strict=True)``."""
    if set(params) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}

    def tensor(arr) -> torch.Tensor:
        return torch.from_numpy(np.array(arr, dtype=np.float32))

    def walk(tree: Mapping[str, Any], prefix: str) -> None:
        for key, val in tree.items():
            path = f"{prefix}.{key}" if prefix else key
            if isinstance(val, Mapping):
                walk(val, path)
            elif key == "kernel":
                out[f"{prefix}.weight"] = tensor(np.asarray(val).T)
            elif key in ("scale", "embedding"):
                out[f"{prefix}.weight"] = tensor(val)
            elif key in ("bias", "class_embedding", "position_embedding"):
                out[path] = tensor(val)
            else:
                raise KeyError(f"no conversion rule for Flax leaf {path!r}")

    walk(params, "")
    return out
