"""MLM token masking, 80/10/10 (counterpart of sasvqa_tpu/data/mlm.py).

Preserved from the reference's pretrain path (src/datasets/data_utils.py:
20-67): select 15% of the tokens that are not special; of those, 80%
become [MASK], 10% a random token and 10% stay; unselected positions get
the label ``IGNORE``.  :func:`mask_tokens` draws from a
``torch.Generator`` on the ids' device and hands the draws to the pure
:func:`mask_tokens_from_draws`; :func:`mask_tokens_numpy` is the host
version for the input pipeline.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

IGNORE = -100


def mask_tokens_from_draws(input_ids: torch.Tensor, u: torch.Tensor,
                           u2: torch.Tensor, rand_tok: torch.Tensor,
                           mask_token_id: int, special_mask: torch.Tensor,
                           mlm_prob: float = 0.15
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (masked_ids, labels) from the draws: ``u`` selects (u <
    mlm_prob, off special positions), ``u2`` picks [MASK] (< 0.8) or
    ``rand_tok`` ([0.8, 0.9)); every draw has the ids' shape.
    special_mask (B, L): 1 = never mask."""
    select = (u < mlm_prob) & (special_mask == 0)
    labels = torch.where(select, input_ids,
                         torch.full_like(input_ids, IGNORE))
    use_mask = select & (u2 < 0.8)
    use_rand = select & (u2 >= 0.8) & (u2 < 0.9)
    out = torch.where(use_mask, torch.full_like(input_ids, mask_token_id),
                      input_ids)
    out = torch.where(use_rand, rand_tok.to(input_ids.dtype), out)
    return out, labels


def mask_tokens(generator: torch.Generator, input_ids: torch.Tensor,
                mask_token_id: int, vocab_size: int,
                special_mask: torch.Tensor, mlm_prob: float = 0.15
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (masked_ids, labels), the draws taken from ``generator`` (on
    the ids' device) in the order u, u2, rand_tok."""
    shape, dev = input_ids.shape, input_ids.device
    u = torch.rand(shape, generator=generator, device=dev)
    u2 = torch.rand(shape, generator=generator, device=dev)
    rand_tok = torch.randint(0, vocab_size, shape, generator=generator,
                             device=dev)
    return mask_tokens_from_draws(input_ids, u, u2, rand_tok, mask_token_id,
                                  special_mask, mlm_prob)


def mask_tokens_numpy(rng: np.random.Generator, input_ids: np.ndarray,
                      mask_token_id: int, vocab_size: int,
                      special_mask: np.ndarray,
                      mlm_prob: float = 0.15) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side twin of :func:`mask_tokens` (the JAX package's code)."""
    u = rng.random(input_ids.shape)
    select = (u < mlm_prob) & (special_mask == 0)
    labels = np.where(select, input_ids, IGNORE)
    u2 = rng.random(input_ids.shape)
    out = np.array(input_ids)
    out[select & (u2 < 0.8)] = mask_token_id
    rand_pos = select & (u2 >= 0.8) & (u2 < 0.9)
    out[rand_pos] = rng.integers(0, vocab_size, rand_pos.sum())
    return out, labels
