"""Online frame re-sampling policies (host-side numpy).

Counterpart of sasvqa_tpu/sampling/policies.py, with the reference
collator's semantics:

- ``uniform``:   indices 0, n, 2n, ... (stride = nframe; keeps
  ceil(K/nframe) frames, not nframe of them)
- ``random``:    nframe distinct index-weighted picks (frame i drawn with
  probability proportional to i, without replacement), as Gumbel-top-k
- ``single``:    the middle frame (K//2)
- ``question-caption``: first nframe of the precomputed ``sampled_inds``
- ``importance``: first nframe stored frames
"""

from __future__ import annotations

from typing import Optional

import numpy as np

POLICIES = ("uniform", "random", "single", "question-caption", "importance")


def num_output_frames(policy: str, num_stored: int, nframe: int) -> int:
    """Static output frame count per policy."""
    if policy == "uniform":
        return num_stored // nframe + (1 if num_stored % nframe else 0)
    if policy == "single":
        return 1
    if policy in ("random", "question-caption", "importance"):
        return nframe
    raise ValueError(f"unknown samp_policy {policy!r}")


def sample_indices(policy: str, num_stored: int, nframe: int,
                   rng: Optional[np.random.Generator] = None,
                   sampled_inds: Optional[np.ndarray] = None,
                   batch_size: int = 1) -> np.ndarray:
    """Return (batch_size, T_out) int32 frame indices into the K stored
    frames."""
    t_out = num_output_frames(policy, num_stored, nframe)
    if policy == "uniform":
        inds = np.arange(t_out, dtype=np.int64) * nframe
        return np.broadcast_to(inds, (batch_size, t_out)).astype(np.int32)
    if policy == "single":
        mid = num_stored // 2
        return np.full((batch_size, 1), mid, dtype=np.int32)
    if policy == "random":
        if rng is None:
            raise ValueError("random policy needs an rng")
        if nframe > num_stored - 1:
            raise ValueError(
                f"random policy: nframe={nframe} > {num_stored - 1} "
                "nonzero-weight frames (frame 0 has probability 0)")
        with np.errstate(divide="ignore"):  # log(0) -> -inf for frame 0
            logw = np.log(np.arange(num_stored, dtype=np.float64))
        if isinstance(rng, (list, tuple)):
            # one independent generator per row
            if len(rng) != batch_size:
                raise ValueError(f"{len(rng)} rngs for {batch_size} rows")
            noise = np.stack([r.gumbel(size=num_stored) for r in rng])
        else:
            noise = rng.gumbel(size=(batch_size, num_stored))
        keys = logw + noise
        order = np.argsort(-keys, axis=1)[:, :nframe]
        return order.astype(np.int32)
    if policy == "question-caption":
        if sampled_inds is None:
            raise ValueError("question-caption policy needs sampled_inds")
        si = np.asarray(sampled_inds)[:, :nframe]
        if si.shape != (batch_size, nframe):
            raise ValueError(f"sampled_inds shape {si.shape}, expected "
                             f"{(batch_size, nframe)}")
        return si.astype(np.int32)
    if policy == "importance":
        inds = np.arange(nframe, dtype=np.int32)
        return np.broadcast_to(inds, (batch_size, nframe)).copy()
    raise ValueError(f"unknown samp_policy {policy!r}")


def gather_frames(frames: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """frames (B, K, ...) + indices (B, T) -> (B, T, ...)."""
    b = frames.shape[0]
    return frames[np.arange(b)[:, None], indices]
