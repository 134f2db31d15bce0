"""Retrieval helpers (counterpart of sasvqa_tpu/train/retrieval.py): for
now only the multi-clip score pooling that classifier validation uses
(``inference_n_clips`` > 1 with ``score_agg_func``).  The retrieval task
itself is not ported yet (ROADMAP.md)."""

from __future__ import annotations

import torch


def aggregate_clip_scores(scores: torch.Tensor, agg: str = "lse",
                          dim: int = -1) -> torch.Tensor:
    """Pool per-clip scores along ``dim``: mean / max / LogSumExp."""
    if agg == "mean":
        return scores.mean(dim=dim)
    if agg == "max":
        return scores.amax(dim=dim)
    if agg == "lse":
        return torch.logsumexp(scores, dim=dim)
    raise ValueError(f"unknown score_agg_func {agg!r}")
