"""Attention-probability dropout from a coordinate hash.

The keep decision for element (b, h, row, col) of a (B, H, S, S)
attention matrix is a function of that coordinate and a 32-bit seed
alone: a lowbias32 finalizer (Wellons' constants) of

    seed + (b*H + h) * 0x9E3779B9 + row * 0x85EBCA6B + col * 0xC2B2AE35

in wrapping uint32 arithmetic; the element is kept when the low 31 bits
of the hash reach ``rate * 2**31``, and a kept probability is scaled by
``1 / (1 - rate)`` (that scale rounded to f32).  uint32 is emulated in
int64 here: every product is split at 16 bits so that no intermediate
leaves int64's range.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

M32 = 0xFFFFFFFF


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """Low 32 bits of ``x * c`` for ``x`` in [0, 2**32)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def coordinates(bh: torch.Tensor, rows: torch.Tensor,
                cols: torch.Tensor) -> torch.Tensor:
    """The seed-free part of the hash's input, mod 2**32."""
    return (mul32(bh, 0x9E3779B9) + mul32(rows, 0x85EBCA6B)
            + mul32(cols, 0xC2B2AE35)) & M32


@functools.lru_cache(maxsize=1)
def _coordinate_rows(b: int, nh: int, s: int, device: str):
    """:func:`coordinates` of every (b, h, row, col), one (H, S, S)
    tensor a batch row; kept for the next call of the same shape (every
    layer and micro-batch of a run has one)."""
    dev = torch.device(device)
    idx = torch.arange(s, dtype=torch.int64, device=dev)
    return [coordinates(torch.arange(i * nh, (i + 1) * nh,
                                     dtype=torch.int64,
                                     device=dev)[:, None, None],
                        idx[None, :, None], idx[None, None, :])
            for i in range(b)]


def keep_bits(coords: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """The low 31 bits of the hash of ``coords`` (:func:`coordinates`)
    under ``seed``."""
    h = ((seed.to(torch.int64) & M32) + coords) & M32
    h = h ^ (h >> 16)
    h = mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return h & 0x7FFFFFFF


def factor(b: int, nh: int, s: int, seed: torch.Tensor,
           rate: float) -> torch.Tensor:
    """(B, H, S, S) f32 factors in {0, 1/(1 - rate)} on ``seed``'s
    device.  ``seed`` is a one-element integer tensor; only its low 32
    bits count (as a two's-complement int32 reading them would)."""
    dev = seed.device
    seed = seed.reshape(()).to(torch.int64) & M32
    thresh = int(rate * (1 << 31))
    scale = float(np.float32(1.0 / (1.0 - rate)))
    out = torch.empty((b, nh, s, s), dtype=torch.float32, device=dev)
    # one batch row at a time bounds the temporaries
    for i, coords in enumerate(_coordinate_rows(b, nh, s, str(dev))):
        out[i] = (keep_bits(coords, seed) >= thresh).to(torch.float32) \
            * scale
    return out
