"""GIT (``GitForCausalLM``): the family of ``configs/git_base.json``.

- ``checkpoint_shapes``, ``is_layer_norm_weight``, ``trainable``: the
  published checkpoint, as the benchmark writes it from the seed;
- ``micro_loss`` and ``next_token_logits``: the plain f32 reference
  (:mod:`port_bench.reference.git`) over annotation rows;
- ``prompt``: a question's prompt ids, as the engine builds them;
- ``leaf_norms``: norms of the program's leaves by checkpoint key;
- ``update_flops`` and ``profiled``: model FLOPs of an update, and the
  git-flash kernels' device seconds and least seconds in a profiled
  update (K1 ``flash_fwd_sm90``, K2 ``flash_bwd_fused_sm90``)."""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from port_bench import flops, trace
from port_bench.families.git_names import leaf_norms  # noqa: F401
from port_bench.reference.git import (hf_git_shapes as checkpoint_shapes,  # noqa: F401
                                      is_layer_norm_weight, next_token_logits,
                                      train_loss, trainable)
from port_bench.reference.text import git_prompt as prompt  # noqa: F401
from port_bench.reference.text import git_train_row


def micro_loss(params: Mapping[str, torch.Tensor], c: Mapping,
               rows: List[Dict[str, Any]], pixels: torch.Tensor,
               vocab_map: Dict[str, int], text_len: int,
               gen: torch.Generator, ar) -> torch.Tensor:
    """The LM loss of one training micro-batch: ``rows`` its
    annotations, ``pixels`` (rows, frames, 3, H, W)."""
    ids, mask, labels = (torch.from_numpy(np.stack(x)).to(pixels.device)
                         for x in zip(*[git_train_row(
                             vocab_map, a["question"], a["answer"], text_len)
                             for a in rows]))
    return train_loss(params, c, pixels, ids, mask, labels, gen, ar)


def update_flops(c: Mapping, shape, lens) -> float:
    """Model FLOPs of one update: ``shape`` is (micros, rows, frames,
    text length), ``lens`` each row's unpadded text length a micro."""
    return sum(flops.git_train_micro(c, shape[2], shape[3], micro)
               for micro in lens)


def profiled(c: Mapping, p: Dict[str, Any]) -> Dict[str, Any]:
    prof, shape = p["prof"], p["shape"]
    m = shape[2] * flops.tokens_per_frame(c)
    bounds = {"fwd": 0.0, "bwd": 0.0}
    for micro in p["lens"]:
        b = flops.git_flash_bounds(c, m, shape[3], micro)
        for key in bounds:
            bounds[key] += c["num_hidden_layers"] * b[key]
    return {"summary": trace.summary(prof), "micros": int(shape[0]),
            "k1": trace.device_seconds(prof, "flash_fwd_sm90"),
            "k2": trace.device_seconds(prof, "flash_bwd_fused_sm90"),
            "bound_s": bounds, "prof": prof}
