"""MDF: most-dominant-frame sampling on the device (counterpart of
sasvqa_tpu/sampling/mdf.py).

1. every decoded frame goes through a frozen vision encoder; the pooled
   features are L2-normalised;
2. windowed local-average cosine similarity
   ``lcl[i] = (sum_{j in [i-W, i+W)} f_i . f_j - 1) / (2W - 1)`` for
   ``i in [W, N-W)``, 0 elsewhere, as a banded row-sum from a cumulative
   feature sum in f32 (``S_i = cs[i+W] - cs[i-W]``): no N x N tensor
   exists at any point;
3. K masked argmaxes with the suppression window ``[idx-W, idx+W)`` (the
   interval arithmetic of the reference's heap search), in importance
   order; when the mask empties before K picks, the plain top-K of
   ``lcl`` in a stable order (the lower index first among ties).

The loop runs on the tensor's device and reads nothing back to the host:
the caller copies the picks once.  :func:`mdf_reference_numpy` is the
reference's dense ``lcl`` and heap search on the host, the oracle of the
device path; :func:`heap_select_numpy` runs the heap search alone on
given scores.
"""

from __future__ import annotations

import heapq
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

NEG = -3.0e38

NValid = Union[int, torch.Tensor]


def local_average_similarity(feats: torch.Tensor, window: int,
                             n_valid: Optional[NValid] = None
                             ) -> torch.Tensor:
    """Banded local-average cosine similarity, (N, D) -> (N,) f32.

    ``feats`` must be L2-normalised.  Values for i in [W, n_valid-W),
    zero at the boundaries.  Rows past ``n_valid`` must be zero vectors;
    no valid position reads their band."""
    n = feats.shape[0]
    if n_valid is None:
        n_valid = n
    w = window
    feats = feats.float()
    cs = torch.cumsum(feats, dim=0)
    cs = torch.cat([torch.zeros_like(cs[:1]), cs], dim=0)   # (N+1, D)
    idx = torch.arange(n, device=feats.device)
    lo = (idx - w).clamp(0, n)
    hi = (idx + w).clamp(0, n)
    dots = (feats * (cs[hi] - cs[lo])).sum(dim=-1)
    lcl = (dots - 1.0) / (2 * w - 1)
    valid = (idx >= w) & (idx < n_valid - w)
    return torch.where(valid, lcl, torch.zeros_like(lcl))


def suppression_topk(lcl_avg: torch.Tensor, k: int, window: int,
                     valid: Optional[torch.Tensor] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K masked argmaxes with the suppression window [idx-W, idx+W).

    Equivalent to the reference's heap interval search: the intervals
    partition the unsuppressed positions and each contributes its
    maximum, so popping the best interval is the global masked argmax.
    ``valid`` (N,) bool marks the rows that exist (bucket pad rows are
    False): the exhaustion check counts valid rows only, since pad rows
    are never suppressed.

    Returns (indices (k,) int64 in importance order, exhausted flag (a
    0-d bool tensor)).  When the mask empties before k picks, the picks
    are replaced by the plain top-k of ``lcl_avg``, as the reference
    does."""
    n = lcl_avg.shape[0]
    dev = lcl_avg.device
    w = window
    pos = torch.arange(n, device=dev)
    mask = (torch.ones(n, dtype=torch.bool, device=dev) if valid is None
            else valid.clone())
    neg = torch.full_like(lcl_avg, NEG)
    picks = torch.zeros(k, dtype=torch.int64, device=dev)
    exhausted = torch.zeros((), dtype=torch.bool, device=dev)
    for i in range(k):
        idx = torch.argmax(torch.where(mask, lcl_avg, neg))
        exhausted |= ~mask.any()
        picks[i] = idx
        mask &= ~((pos >= idx - w) & (pos < idx + w))
    # a stable descending sort puts the lower index first among ties, as
    # the JAX top_k and the oracle's stable argsort do (topk's order among
    # ties is not defined on CUDA)
    fallback = torch.sort(lcl_avg, descending=True, stable=True).indices[:k]
    return torch.where(exhausted, fallback, picks), exhausted


def mdf_select(feats: torch.Tensor, k: int, window: int = -1,
               interval: int = 20) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pooled features (N, D) -> (indices (k,), exhausted flag).

    ``window == -1`` is the adaptive width N // interval (the reference's
    INTERVAL=20); W is clamped to at least 1 (W = 0 would flip the sign
    of the lcl denominator and empty the suppression interval)."""
    n = feats.shape[0]
    if window == -1:
        window = n // interval
    window = max(window, 1)
    feats = feats.float()
    feats = feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
    return suppression_topk(local_average_similarity(feats, window), k,
                            window)


def mdf_select_batched(feats: torch.Tensor, k: int, window: int = -1,
                       interval: int = 20
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`mdf_select` over (B, N, D) feature stacks -> (B, k)
    indices and (B,) flags."""
    picks, flags = zip(*(mdf_select(f, k, window, interval) for f in feats))
    return torch.stack(picks), torch.stack(flags)


def padded_lcl(feats: torch.Tensor, n_valid: NValid, window: int
               ) -> torch.Tensor:
    """The scores :func:`mdf_select_padded` selects on: ``lcl`` of a
    bucket-padded (B, D) feature array with ``n_valid`` real rows, whose
    pad rows count as zero features and score ``NEG``."""
    b = feats.shape[0]
    feats = feats.float()
    norms = torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
    f = feats / norms.clamp(min=1e-12)
    in_range = torch.arange(b, device=feats.device) < n_valid
    f = torch.where(in_range[:, None], f, torch.zeros_like(f))
    lcl = local_average_similarity(f, window, n_valid=n_valid)
    return torch.where(in_range, lcl, torch.full_like(lcl, NEG))


def mdf_select_padded(feats: torch.Tensor, n_valid: NValid, k: int,
                      window: int, interval: int = 20
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MDF over a bucket-padded feature array (B, D) with ``n_valid``
    real rows; ``window`` is resolved by the caller (the adaptive
    N // interval on the true N).

    Pad rows get zero features and a ``NEG`` score, so neither the
    suppression loop nor the fallback picks them, and they are left out
    of the exhaustion check.  Picks are clamped to ``n_valid - 1``.  The
    result equals :func:`mdf_select` on the unpadded array."""
    window = max(window, 1)
    valid = torch.arange(feats.shape[0], device=feats.device) < n_valid
    picks, exhausted = suppression_topk(padded_lcl(feats, n_valid, window),
                                        k, window, valid=valid)
    return torch.clamp(picks, max=n_valid - 1), exhausted


# --------------------------------------------------------------------------
# the host oracle: the reference's heap search


def lcl_reference_numpy(feats: np.ndarray, window: int) -> np.ndarray:
    """The reference's dense ``lcl`` (f64 sums of an N x N similarity
    matrix) of (N, D) unnormalised features."""
    n, w = feats.shape[0], window
    f = feats / np.linalg.norm(feats, axis=-1, keepdims=True)
    sims = f @ f.T
    lcl = np.zeros(n, dtype=np.float64)
    for i in range(w, n - w):
        sub = sims[i][i - w:i + w]
        lcl[i] = (sub.sum() - 1) / (len(sub) - 1)
    return lcl


def heap_select_numpy(lcl: np.ndarray, k: int, window: int) -> np.ndarray:
    """The reference's heap interval search over scores ``lcl`` (N,),
    with its plain top-k fallback -> (k,) int32 indices in importance
    order."""
    n, w = len(lcl), window
    top = int(lcl.argmax())
    res = [top]
    heap: list = []
    counter = 0  # tie-breaker so the heap never compares the intervals

    def push(l, r):
        nonlocal counter
        if r > l:
            seg = lcl[l:r]
            heapq.heappush(heap, (-seg.max(), counter, (l, r),
                                  l + int(seg.argmax())))
            counter += 1

    if top - w > 0:
        push(0, top - w)
    if top + w < n:
        push(top + w, n)

    while len(res) < k and heap:
        _, _, (l, r), idx = heapq.heappop(heap)
        res.append(idx)
        if idx - w > l:
            push(l, idx - w)
        if idx + w < r:
            push(idx + w, r)

    if len(res) < k:
        # the reference replaces every pick with the plain top-k
        res = np.argsort(-lcl, kind="stable")[:k].tolist()
    return np.asarray(res, dtype=np.int32)


def mdf_reference_numpy(feats: np.ndarray, k: int, window: int = -1,
                        interval: int = 20) -> np.ndarray:
    """The reference's MDF on the host: (N, D) unnormalised pooled
    features -> (k,) int32 indices in importance order."""
    w = feats.shape[0] // interval if window == -1 else window
    w = max(w, 1)
    return heap_select_numpy(lcl_reference_numpy(feats, w), k, w)


def make_mdf_pipeline(encode_fn: Callable[[torch.Tensor], torch.Tensor],
                      k: int, window: int = -1, interval: int = 20):
    """frames -> (indices, exhausted flag) through ``encode_fn`` ((N, H,
    W, C) -> (N, D) pooled features, e.g. the GIT vision tower's pooled
    output), under ``torch.inference_mode()``."""
    def pipeline(frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.inference_mode():
            return mdf_select(encode_fn(frames), k, window, interval)

    return pipeline
