"""The WordPiece vocabulary file of a BERT-style (uncased) model, holding
every word of the benchmark's traffic whole.

Layout of ``bert-base-uncased``: [PAD] at 0, [unused0..98], [UNK] 100,
[CLS] 101, [SEP] 102, [MASK] 103; then the traffic's words, then
fillers ``w<i>`` up to the model's vocabulary size (distinct words, so
every id decodes to a word of its own).
"""

from __future__ import annotations

import os
from typing import List


def entries(size: int, words: List[str]) -> List[str]:
    head = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
            + ["[UNK]", "[CLS]", "[SEP]", "[MASK]", "?"] + list(words))
    if len(head) > size:
        raise ValueError(f"{len(head)} entries do not fit a vocabulary of "
                         f"{size}")
    return head + [f"w{i}" for i in range(size - len(head))]


def write(root: str, size: int, words: List[str]) -> str:
    """``root/vocab.txt``; returns ``root``."""
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(entries(size, words)) + "\n")
    return root
