"""Video-text retrieval metrics and multi-clip score pooling (counterpart
of sasvqa_tpu/train/retrieval.py): Recall@K / MedR / MeanR over a
text-to-video score matrix, cosine similarity of embeddings, and the
mean / max / LogSumExp pooling of per-clip scores that the retrieval task
(``tasks/run_retrieval.py``) and classifier validation
(``inference_n_clips`` > 1 with ``score_agg_func``) use."""

from __future__ import annotations

from typing import Dict

import numpy as np
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


def retrieval_metrics(score_matrix: np.ndarray) -> Dict[str, float]:
    """score_matrix (N_text, N_video), diagonal = ground truth.

    Returns text->video R@1/5/10 (%), MedR, MeanR.  The ranks come from
    numpy's ``argsort`` of the negated scores on the host, as in the JAX
    package, so that tied scores rank the same way."""
    score_matrix = np.asarray(score_matrix)
    n = score_matrix.shape[0]
    # rank of the true video for each text query (0-based)
    order = np.argsort(-score_matrix, axis=1)
    ranks = np.empty(n, dtype=np.int64)
    for i in range(n):
        ranks[i] = int(np.where(order[i] == i)[0][0])
    return {
        "r1": float(100.0 * np.mean(ranks < 1)),
        "r5": float(100.0 * np.mean(ranks < 5)),
        "r10": float(100.0 * np.mean(ranks < 10)),
        "medianR": float(np.median(ranks) + 1),
        "meanR": float(np.mean(ranks) + 1),
    }


def similarity_matrix(text_embeds: torch.Tensor, video_embeds: torch.Tensor,
                      normalize: bool = True) -> torch.Tensor:
    """(Nt, D) x (Nv, D) -> (Nt, Nv) cosine (or, unnormalised, dot)
    similarity, on the embeddings' device."""
    if normalize:
        text_embeds = text_embeds / torch.linalg.vector_norm(
            text_embeds, dim=-1, keepdim=True)
        video_embeds = video_embeds / torch.linalg.vector_norm(
            video_embeds, dim=-1, keepdim=True)
    return text_embeds @ video_embeds.T
