"""Seeded checkpoints in a published model's key names.

One generator on the device draws every leaf in one call: N(0, 0.02)
for weights, embeddings and biases, 1 + N(0, 0.02) for LayerNorm scales.
The state dict goes to ``pytorch_model.bin`` as f32 (the type the
programs train and load), one storage shared by every leaf.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Tuple

import torch


def seeded_state_dict(shapes: Dict[str, Tuple[int, ...]], seed: int,
                      device, is_ln_weight: Callable[[str], bool]
                      ) -> Dict[str, torch.Tensor]:
    sizes = [int(torch.Size(s).numel()) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device) * 0.02
    out, at = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        leaf = flat[at:at + n].view(shape)
        if len(shape) == 1 and is_ln_weight(name):
            leaf += 1.0
        out[name] = leaf
        at += n
    return out


def write(root: str, sd: Dict[str, torch.Tensor]) -> str:
    """``root/pytorch_model.bin`` from ``sd`` (one host copy); returns
    ``root``."""
    os.makedirs(root, exist_ok=True)
    names = list(sd)
    flat = torch.cat([sd[n].reshape(-1) for n in names]).cpu()
    host, at = {}, 0
    for n in names:
        k = sd[n].numel()
        host[n] = flat[at:at + k].view(sd[n].shape)
        at += k
    torch.save(host, os.path.join(root, "pytorch_model.bin"))
    return root


def load(root: str, device) -> Dict[str, torch.Tensor]:
    sd = torch.load(os.path.join(root, "pytorch_model.bin"),
                    map_location="cpu", weights_only=True)
    return {k: v.to(device=device, dtype=torch.float32) for k, v in sd.items()}
