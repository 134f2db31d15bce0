"""Plain tokenization of the benchmark's texts and GIT's sequences.

The benchmark's vocabulary holds every word its traffic uses whole, so a
text's tokens are its lowercased words with each punctuation character
split off, looked up one by one; a word outside the vocabulary is an
error, not a silent [UNK].
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List, Tuple

import numpy as np


def read_vocab(path: str) -> Dict[str, int]:
    with open(path, encoding="utf-8") as f:
        return {line.rstrip("\n"): i for i, line in enumerate(f)}


def _punct(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 \
            or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def words(text: str) -> List[str]:
    out, cur = [], []
    for ch in text.lower():
        if ch.isspace() or _punct(ch):
            if cur:
                out.append("".join(cur))
                cur = []
            if not ch.isspace():
                out.append(ch)
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out


def ids(vocab: Dict[str, int], text: str) -> List[int]:
    return [vocab[w] for w in words(text)]


def git_train_row(vocab: Dict[str, int], question: str, answer: str,
                  length: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """[CLS] question answer [SEP], right-padded to ``length``: (ids,
    mask, labels); labels are the ids with the [CLS]-and-question prefix
    set to -100 (padding stays a [PAD] target, as GIT's training recipe
    has it)."""
    q = [vocab["[CLS]"]] + ids(vocab, question)
    full = (q + ids(vocab, answer) + [vocab["[SEP]"]])[:length]
    pad = vocab["[PAD]"]
    row = np.full(length, pad, np.int64)
    row[:len(full)] = full
    mask = np.zeros(length, np.int64)
    mask[:len(full)] = 1
    labels = row.copy()
    labels[:min(len(q), length)] = -100
    return row, mask, labels


def git_prompt(vocab: Dict[str, int], question: str) -> List[int]:
    return [vocab["[CLS]"]] + ids(vocab, question)
