"""Eval steps (counterpart of sasvqa_tpu/train/steps.py).

Only the generative GIT eval step is ported so far; the train steps and
the optimizer come with the training slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from sasvqa_torch.core.device import DeviceLike, resolve_device
from sasvqa_torch.models.git import GITForCausalLM, greedy_generate


def make_git_eval_step(model: GITForCausalLM, max_text_len: int = 50,
                       max_new_tokens: Optional[int] = None,
                       device: DeviceLike = "cuda"
                       ) -> Callable[[Dict[str, Any]], torch.Tensor]:
    """Generative eval: batch -> (B, max_new) greedy token ids on
    ``device``, computed under ``torch.inference_mode()`` (greedy_generate
    enters it).  ``max_new_tokens=None`` decodes to the full
    ``max_text_len`` budget, with the all-done early exit."""
    dev = resolve_device(device)

    def step(batch: Dict[str, Any]) -> torch.Tensor:
        return greedy_generate(
            model, batch["text_input_ids"], batch["prompt_len"],
            batch["visual_inputs"], max_text_len=max_text_len,
            max_new_tokens=max_new_tokens, device=dev)

    return step
