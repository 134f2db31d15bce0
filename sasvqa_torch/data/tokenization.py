"""Offline tokenizers: WordPiece (BERT/GIT/BLIP vocabularies) and CLIP's
byte-level BPE (counterpart of sasvqa_tpu/data/tokenization.py), read from
local vocabulary files.  Both pad to a fixed ``max_length`` so every
batch has one shape.

API:
    tok(texts, max_length) -> {"input_ids": (B, L) int32,
                               "attention_mask": (B, L) int32, ...}
    tok.decode(ids)        -> str (skipping special tokens)
"""

from __future__ import annotations

import json
import re
import unicodedata
from functools import lru_cache
from typing import Dict, List, Optional, Sequence

import numpy as np


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) \
            or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def basic_tokenize(text: str, lowercase: bool = True) -> List[str]:
    """BERT BasicTokenizer equivalent: lowercase, strip accents, split on
    whitespace and punctuation."""
    if lowercase:
        text = text.lower()
        text = unicodedata.normalize("NFD", text)
        text = "".join(c for c in text if unicodedata.category(c) != "Mn")
    tokens: List[str] = []
    cur = []
    for ch in text:
        if ch.isspace():
            if cur:
                tokens.append("".join(cur))
                cur = []
        elif _is_punctuation(ch):
            if cur:
                tokens.append("".join(cur))
                cur = []
            tokens.append(ch)
        else:
            cur.append(ch)
    if cur:
        tokens.append("".join(cur))
    return tokens


def _trim_longest_first(ids: List[int], pair: List[int], budget: int):
    """HF 'longest_first' truncation; ties trim the pair."""
    while len(ids) + len(pair) > budget:
        if len(ids) > len(pair):
            ids = ids[:-1]
        else:
            pair = pair[:-1]
    return ids, pair


class WordPieceTokenizer:
    """BERT-style WordPiece with [CLS]/[SEP]/[PAD]/[UNK] specials."""

    def __init__(self, vocab: Dict[str, int], lowercase: bool = True,
                 unk_token: str = "[UNK]", cls_token: str = "[CLS]",
                 sep_token: str = "[SEP]", pad_token: str = "[PAD]",
                 max_input_chars_per_word: int = 100):
        self.vocab = vocab
        self.ids_to_tokens = {v: k for k, v in vocab.items()}
        self.lowercase = lowercase
        self.unk_token = unk_token
        self.cls_token_id = vocab[cls_token]
        self.sep_token_id = vocab[sep_token]
        self.pad_token_id = vocab[pad_token]
        self.unk_token_id = vocab[unk_token]
        self._special_ids = {self.cls_token_id, self.sep_token_id,
                             self.pad_token_id}
        self.max_input_chars_per_word = max_input_chars_per_word

    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        vocab = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, **kw)

    def wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_input_chars_per_word:
            return [self.unk_token]
        tokens, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            tokens.append(cur)
            start = end
        return tokens

    def tokenize(self, text: str) -> List[str]:
        out = []
        for word in basic_tokenize(text, self.lowercase):
            out.extend(self.wordpiece(word))
        return out

    def _ids(self, text: str) -> List[int]:
        return [self.vocab.get(t, self.unk_token_id)
                for t in self.tokenize(text)]

    def encode(self, text: str, text_pair: Optional[str] = None,
               add_special_tokens: bool = True,
               max_length: Optional[int] = None) -> List[int]:
        """HF-style 'longest_first' truncation: content tokens drop
        before special tokens, so the [CLS]/[SEP] structure survives."""
        ids = self._ids(text)
        pair = None if text_pair is None else self._ids(text_pair)
        if not add_special_tokens:
            if pair is not None:
                if max_length is not None:
                    ids, pair = _trim_longest_first(ids, pair, max_length)
                return ids + pair
            return ids if max_length is None else ids[:max_length]
        if max_length is not None:
            n_special = 2 + (1 if pair is not None else 0)
            budget = max(max_length - n_special, 0)
            if pair is None:
                ids = ids[:budget]
            else:
                ids, pair = _trim_longest_first(ids, pair, budget)
        out = [self.cls_token_id] + ids + [self.sep_token_id]
        if pair is not None:
            out += pair + [self.sep_token_id]
        return out

    def num_first_segment_tokens(self, text: str, text_pair: str,
                                 add_special_tokens: bool,
                                 max_length: Optional[int]) -> int:
        """Length of segment 0 in ``encode``'s pair output ([CLS] a [SEP]
        are type 0), under the same truncation walk."""
        ids, pair = self._ids(text), self._ids(text_pair)
        if max_length is not None:
            budget = (max(max_length - 3, 0) if add_special_tokens
                      else max_length)
            ids, pair = _trim_longest_first(ids, pair, budget)
        return len(ids) + (2 if add_special_tokens else 0)

    def __call__(self, texts: Sequence[str], max_length: int = 20,
                 text_pairs: Optional[Sequence[str]] = None,
                 add_special_tokens: bool = True) -> Dict[str, np.ndarray]:
        b = len(texts)
        ids = np.full((b, max_length), self.pad_token_id, dtype=np.int32)
        mask = np.zeros((b, max_length), dtype=np.int32)
        types = np.zeros((b, max_length), dtype=np.int32)
        for i, text in enumerate(texts):
            pair = text_pairs[i] if text_pairs is not None else None
            enc = self.encode(text, pair, add_special_tokens,
                              max_length=max_length)
            ids[i, :len(enc)] = enc
            mask[i, :len(enc)] = 1
            if pair is not None:
                n0 = self.num_first_segment_tokens(
                    text, pair, add_special_tokens, max_length)
                types[i, n0:len(enc)] = 1
        return {"input_ids": ids, "attention_mask": mask,
                "token_type_ids": types}

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        toks = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i in self._special_ids:
                continue
            toks.append(self.ids_to_tokens.get(i, self.unk_token))
        return " ".join(toks).replace(" ##", "")

    def batch_decode(self, batch_ids, skip_special_tokens=True) -> List[str]:
        return [self.decode(row, skip_special_tokens) for row in batch_ids]


@lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP byte <-> unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


class CLIPBPETokenizer:
    """CLIP's lowercased byte-level BPE with ``</w>`` end-of-word markers,
    from a checkpoint's ``vocab.json`` + ``merges.txt``.  Rows are
    ``<|startoftext|>`` + tokens + ``<|endoftext|>`` (kept on truncation),
    padded with ``<|endoftext|>`` (HF CLIP's convention)."""

    # HF CLIP's pre-tokenization pattern needs \p{L}/\p{N} from the
    # `regex` module; without it the `re` pattern approximates them with
    # [^\W\d_]+ and \d (number characters outside Nd, such as '½', then
    # join the letter run instead of standing alone)
    try:
        import regex as _regex
        _PAT = _regex.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
            r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+", _regex.IGNORECASE)
    except ImportError:
        _PAT = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
            r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+", re.IGNORECASE | re.UNICODE)

    def __init__(self, vocab: Dict[str, int], merges: List[str]):
        self.encoder = vocab
        self.decoder = {v: k for k, v in vocab.items()}
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        ranks = [tuple(m.split()) for m in merges]
        self.bpe_ranks = dict(zip(ranks, range(len(ranks))))
        self.bos_token_id = vocab["<|startoftext|>"]
        self.eos_token_id = vocab["<|endoftext|>"]
        self.pad_token_id = self.eos_token_id
        self._cache: Dict[str, str] = {}

    @classmethod
    def from_files(cls, vocab_json: str, merges_txt: str
                   ) -> "CLIPBPETokenizer":
        with open(vocab_json, encoding="utf-8") as f:
            vocab = json.load(f)
        with open(merges_txt, encoding="utf-8") as f:
            merges = f.read().split("\n")
        # HF CLIPTokenizer skips exactly the first line (the "#version"
        # header): a merge rule may itself start with the '#' character
        merges = [m for m in merges[1:] if m.strip()]
        return cls(vocab, merges)

    def bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def tokenize_ids(self, text: str) -> List[int]:
        text = " ".join(text.lower().strip().split())
        ids: List[int] = []
        for tok in self._PAT.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            for piece in self.bpe(tok).split(" "):
                ids.append(self.encoder[piece])
        return ids

    def __call__(self, texts: Sequence[str], max_length: int = 77
                 ) -> Dict[str, np.ndarray]:
        b = len(texts)
        ids = np.full((b, max_length), self.pad_token_id, dtype=np.int32)
        mask = np.zeros((b, max_length), dtype=np.int32)
        for i, text in enumerate(texts):
            enc = ([self.bos_token_id] + self.tokenize_ids(text)
                   + [self.eos_token_id])[:max_length]
            enc[-1] = self.eos_token_id  # truncation keeps EOS
            ids[i, :len(enc)] = enc
            mask[i, :len(enc)] = 1
        return {"input_ids": ids, "attention_mask": mask}

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        toks = []
        for i in ids:
            tok = self.decoder.get(int(i), "")
            if skip_special_tokens and tok in ("<|startoftext|>",
                                               "<|endoftext|>"):
                continue
            toks.append(tok)
        text = "".join(toks)
        data = bytearray(self.byte_decoder.get(c, 32) for c in text)
        return bytes(data).decode("utf-8", errors="replace") \
            .replace("</w>", " ").strip()


def make_test_wordpiece(extra_words: Sequence[str] = ()) -> WordPieceTokenizer:
    """Deterministic tiny WordPiece vocab for tests/synthetic data."""
    words = ["what", "who", "how", "where", "when", "is", "the", "a", "in",
             "on", "doing", "color", "man", "woman", "dog", "cat", "ball",
             "red", "blue", "green", "running", "jumping", "playing",
             "video", "frame", "answer"]
    words += list(extra_words)
    vocab = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3, "[MASK]": 4}
    for w in words:
        if w not in vocab:
            vocab[w] = len(vocab)
    for ch in "abcdefghijklmnopqrstuvwxyz0123456789?.!,":
        if ch not in vocab:
            vocab[ch] = len(vocab)
        cont = "##" + ch
        if cont not in vocab:
            vocab[cont] = len(vocab)
    return WordPieceTokenizer(
        vocab, cls_token="[CLS]", sep_token="[SEP]", pad_token="[PAD]",
        unk_token="[UNK]")
