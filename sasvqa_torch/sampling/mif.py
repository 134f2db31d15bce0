"""MIF: most-informative-frame sampling, offline stage B (counterpart of
sasvqa_tpu/sampling/mif.py).

- stage 1: caption every stored frame with a GIT captioner ('[CLS]'
  prompt, greedy, 30 tokens) -> ``frame_captions.json`` {row: [K
  captions]};
- stage 2: for each QA pair, score (question, caption_k) with a BERT
  sequence classifier (``logits[:, 0]``), optionally downsample by
  ``ds_rate``, take the top K in importance order and scale back by
  ds_rate -> ``sampled_inds`` in ``qa_winds_{split}.json``.

Frames caption in (rows x K) batches through the cached greedy decode;
one question's K captions score in one forward.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch


def topk_downsampled(scores: np.ndarray, k: int, ds_rate: int = 1,
                     ) -> List[int]:
    """scores (K,) -> importance-ordered indices,
    ``scores[::ds_rate].topk(K)[1] * ds_rate``, the lower index first
    among equal scores (a stable sort)."""
    sub = np.asarray(scores)[::ds_rate]
    order = np.argsort(-sub, kind="stable")[:min(k, len(sub))]
    return [int(i) * ds_rate for i in order]


def caption_frames(generate_fn: Callable[[torch.Tensor], torch.Tensor],
                   frames_iter, decode_fn: Callable[[Sequence[int]], str],
                   ) -> Dict[int, List[str]]:
    """Stage 1 over many videos.  ``generate_fn``: (B, 1, H, W, C)
    frames -> (B, L) generated token ids; ``frames_iter`` yields (row,
    (K, H, W, C) stored frames); ``decode_fn`` maps ids to caption
    text."""
    captions: Dict[int, List[str]] = {}
    for row, frames in frames_iter:
        ids = generate_fn(torch.as_tensor(np.asarray(frames))[:, None])
        ids = ids.cpu().numpy()
        captions[row] = [decode_fn(ids[i]) for i in range(len(ids))]
    return captions


def score_question_captions(score_fn: Callable[..., torch.Tensor],
                            tokenizer, question: str,
                            captions: Sequence[str],
                            max_length: int = 64) -> np.ndarray:
    """Stage 2 scores of one question: -> (K,) float32.

    ``score_fn(input_ids, attention_mask, token_type_ids)`` -> logits
    (B, num_labels); the score is ``logits[:, 0]``.  The captions are the
    second segment (token type 1), as the reference's text-pair
    tokenization gives the scorer."""
    k = len(captions)
    enc = tokenizer([question] * k, max_length=max_length,
                    text_pairs=list(captions))
    logits = score_fn(torch.from_numpy(enc["input_ids"]),
                      torch.from_numpy(enc["attention_mask"]),
                      torch.from_numpy(enc["token_type_ids"]))
    return logits[:, 0].float().cpu().numpy()


def generate_inds_for_split(score_fn, tokenizer, qa_list: List[dict],
                            all_captions: Dict[str, List[str]],
                            caption_key_fn: Callable[[dict], str],
                            k: int, ds_rate: int = 1,
                            max_length: int = 64) -> List[dict]:
    """Stage 2 over one split: each sample gains ``sampled_inds``.
    ``caption_key_fn(sample)`` is the sample's key in ``all_captions``
    (the tools key captions by store row through vidmapping)."""
    out = []
    for sample in qa_list:
        scores = score_question_captions(
            score_fn, tokenizer, sample["question"],
            all_captions[caption_key_fn(sample)], max_length)
        sample = dict(sample)
        sample["sampled_inds"] = topk_downsampled(scores, k, ds_rate)
        out.append(sample)
    return out
