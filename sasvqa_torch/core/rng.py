"""Deterministic RNG plumbing (counterpart of sasvqa_tpu/core/rng.py).

The reference seeds python/numpy/torch RNGs globally
(src/utils/misc.py:21-25).  The port is explicit: one seeded
``torch.Generator`` for weights, dropout seeds folded from the run seed,
and a seeded numpy Generator on the host, never the global singleton.
The numpy stream is the JAX package's, so both loops draw the same
batches from the same seed.
"""

from __future__ import annotations

import random
from typing import Tuple

import numpy as np
import torch


def set_random_seed(seed: int) -> Tuple[torch.Generator, np.random.Generator]:
    """Seed host RNGs and return (torch Generator, numpy Generator)."""
    random.seed(seed)
    np.random.seed(seed)  # for any library that reaches the global RNG
    return torch.Generator().manual_seed(seed), np.random.default_rng(seed)


def host_fold(seed: int, *data: int) -> np.random.Generator:
    """Derive an independent host Generator purely from (seed, *data):
    the same (seed, epoch/step/...) always yields the same stream,
    independent of call order or count."""
    seed_seq = np.random.SeedSequence(entropy=int(seed),
                                      spawn_key=tuple(data))
    return np.random.default_rng(seed_seq)
