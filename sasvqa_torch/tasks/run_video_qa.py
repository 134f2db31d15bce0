"""Video-QA task helpers (counterpart of sasvqa_tpu/tasks/run_video_qa.py).

Only what serving needs is ported so far: the WordPiece tokenizer choice
and the generated-ids -> answer mapping.  The training/validation loop
comes with the training slice.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np

from sasvqa_torch.core.logging import LOGGER
from sasvqa_torch.data.tokenization import (WordPieceTokenizer,
                                            make_test_wordpiece)


def build_tokenizer(cfg: Mapping[str, Any], family: str):
    tok_dir = cfg.get("tokenizer_dir")
    if family == "clip":
        raise NotImplementedError(
            "the CLIP BPE tokenizer comes with the classifier families")
    if tok_dir:
        vocab_txt = os.path.join(tok_dir, "vocab.txt")
        if os.path.exists(vocab_txt):
            return WordPieceTokenizer.from_vocab_file(vocab_txt)
        raise FileNotFoundError(f"no vocab.txt under {tok_dir}")
    LOGGER.warning("no tokenizer_dir configured; using the built-in test "
                   "WordPiece vocab (synthetic runs only)")
    return make_test_wordpiece()


def decode_answers(tokenizer, generated: np.ndarray,
                   ans2label: Dict[str, int]) -> Tuple[List[int], List[str]]:
    """Generated ids -> answer text -> label of its last word
    (reference run_video_qa.py:325-326)."""
    preds, strs = [], []
    for row in generated:
        text = tokenizer.decode(row, skip_special_tokens=True).strip()
        strs.append(text)
        word = text.split()[-1] if text.split() else ""
        preds.append(ans2label.get(word, -1))
    return preds, strs
