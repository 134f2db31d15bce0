"""The video-QA dataset and its batch collators (counterpart of
sasvqa_tpu/data/dataset.py): GIT generative batches and CLIP/BLIP
classification batches.

Text pads to a fixed ``max_txt_len``; frames are re-sampled on the host
by sampling/policies.py into a static (B_groups, T, H, W, C) array.
Pixel staging dtypes: ``"bf16"`` (the default of a bf16 run, as in the
JAX package; bf16 bit patterns in a ``uint16`` array, core/pixels.py),
``"f32"`` and ``"u8"`` (core/pixels.py).
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from sasvqa_torch.core.logging import LOGGER
from sasvqa_torch.core.pixels import bf16_bits, quantize_u8
from sasvqa_torch.data.annotations import IGNORE_INDEX
from sasvqa_torch.data.frame_store import LazyVideoFrames
from sasvqa_torch.sampling import policies

# host staging dtype of each pixel wire format: bf16 travels as its bit
# patterns (numpy has no bfloat16)
PIXEL_DTYPES = {"bf16": np.uint16, "f32": np.float32, "u8": np.uint8}


def _pixel_dtype(name: str):
    if name not in PIXEL_DTYPES:
        raise ValueError(f"unknown pixel_dtype {name!r}")
    return PIXEL_DTYPES[name]


class VideoQADataset:
    """Grouped datalist + frame store (reference dataset_video_qa.py:17-100).

    ``frame_store`` is a :class:`~sasvqa_torch.data.frame_store.
    FrameStoreReader` or any object with its ``shape`` and
    ``read_frames_nhwc``; groups hand collators a
    :class:`~sasvqa_torch.data.frame_store.LazyVideoFrames` handle, so
    only the frames a policy selects are read."""

    def __init__(self, task_type: str,
                 grouped_datalist: List[Tuple[str, List[Dict[str, Any]]]],
                 frame_store, vid2id: Dict[str, int],
                 ans2label: Dict[str, int], return_label: bool = True,
                 is_train: bool = True):
        self.task_type = task_type
        self.datalist = grouped_datalist
        self.store = frame_store
        self.vid2id = vid2id
        self.ans2label = ans2label
        self.return_label = return_label
        self.is_train = is_train
        self.open_ended = task_type in ("frameqa", "msrvtt_qa", "msvd_qa")
        self.qid2data = {d["question_id"]: d
                         for _, group in grouped_datalist for d in group}

    def __len__(self) -> int:
        return len(self.datalist)

    def get_group(self, index: int, _retries: int = 3) -> Dict[str, Any]:
        """A missing or unreadable video is replaced by a random other
        group in training, at most ``_retries`` times.  Eval never
        substitutes: predictions are attributed by batch-plan position,
        so a swap would score the substitute's answer against the
        original question; it raises instead."""
        vid, examples = self.datalist[index]
        try:
            row = self.vid2id[vid]
            if not 0 <= int(row) < self.store.shape[0]:
                raise IndexError(f"vidmapping row {row} outside store "
                                 f"{self.store.shape}")
            frames = LazyVideoFrames(self.store, row)
        except (KeyError, IndexError, OSError) as e:
            if _retries <= 0 or not self.is_train:
                raise RuntimeError(
                    f"failed to fetch video {vid!r}"
                    + ("" if self.is_train else
                       " (eval never substitutes — fix the store)")) from e
            LOGGER.warning(f"failed to load video {vid!r} ({e}); "
                           f"substituting a random group")
            return self.get_group(random.randrange(len(self)),
                                  _retries=_retries - 1)
        exs = [self._single_example(e) for e in examples]
        # the group's sampled_inds are its first example's, as the
        # reference's (dataset_video_qa.py:74)
        return dict(vid=frames, examples=exs, n_examples=len(exs),
                    sampled_inds=exs[0].get("sampled_inds"))

    def _single_example(self, data: Dict[str, Any]) -> Dict[str, Any]:
        ex = dict(q_str=data["question"], question_id=data["question_id"],
                  label=data["answer"])
        if data.get("sampled_inds") is not None:
            ex["sampled_inds"] = data["sampled_inds"]
        if self.task_type in ("action", "transition"):
            ex["options_str_list"] = data["options"]
        elif self.open_ended and self.return_label:
            ex["str_label"] = ex["label"]
            ex["label"] = self.ans2label.get(ex["label"], IGNORE_INDEX)
        if not self.return_label:
            ex["label"] = None
        return ex


def _resample_frames(items: List[Dict[str, Any]], policy: str, nframe: int,
                     rng: Optional[np.random.Generator],
                     out_dtype=np.float32) -> np.ndarray:
    """(B_groups stored frames) -> (B_groups, T_out, H, W, C).

    Selects indices first, then copies only the selected frames once into
    a preallocated output in the staging dtype."""
    b = len(items)
    k = items[0]["vid"].shape[0]
    sampled_inds = None
    if policy == "question-caption":
        missing = [i for i, d in enumerate(items)
                   if d.get("sampled_inds") is None]
        if missing:
            raise ValueError(
                "samp_policy='question-caption' (MIF) needs per-question "
                f"'sampled_inds' but {len(missing)} of {len(items)} "
                "groups lack them")
        sampled_inds = np.stack(
            [np.asarray(d["sampled_inds"]) for d in items])
    inds = policies.sample_indices(policy, k, nframe, rng=rng,
                                   sampled_inds=sampled_inds, batch_size=b)
    frame_shape = items[0]["vid"].shape[1:]
    out = np.empty((b, inds.shape[1]) + frame_shape, dtype=out_dtype)
    if out_dtype == np.uint8:
        # u8 wire format: invert the store's normalize affine (a plain
        # cast-assign would truncate floats)
        for i, d in enumerate(items):
            out[i] = quantize_u8(d["vid"][inds[i]])
    elif out_dtype == np.uint16:
        for i, d in enumerate(items):
            out[i] = bf16_bits(d["vid"][inds[i]])
    else:
        for i, d in enumerate(items):
            out[i] = d["vid"][inds[i]]
    return out


def _flatten_examples(items: List[Dict[str, Any]]):
    examples = [e for d in items for e in d["examples"]]
    n_examples = [d["n_examples"] for d in items]
    return examples, n_examples


def _check_uniform_groups(n_examples: Sequence[int]) -> None:
    """Groups must be uniformly sized so the model can infer the
    video->example repeat factor from shapes."""
    if len(set(n_examples)) > 1:
        raise ValueError(
            f"non-uniform group sizes {sorted(set(n_examples))}; "
            "mk_input_group with pad_to_divisible produces uniform groups")


class ClassifierCollator:
    """CLIP / BLIP classification batches: the question (or, for the
    TGIF ``action``/``transition`` tasks, question + option, one row per
    option) padded to ``max_txt_len``, integer labels when the examples
    carry them."""

    def __init__(self, tokenizer, max_txt_len: int = 20,
                 task_type: str = "msvd_qa", n_options: int = 5,
                 nframe: int = 4, samp_policy: str = "random",
                 pixel_dtype: str = "f32"):
        self.tokenizer = tokenizer
        self.max_txt_len = max_txt_len
        self.task_type = task_type
        self.n_options = n_options
        self.nframe = nframe
        self.samp_policy = samp_policy
        self.pixel_dtype = _pixel_dtype(pixel_dtype)

    def __call__(self, items: List[Dict[str, Any]],
                 rng: Optional[np.random.Generator] = None,
                 ) -> Dict[str, Any]:
        visual = _resample_frames(items, self.samp_policy, self.nframe,
                                  rng, out_dtype=self.pixel_dtype)
        examples, n_examples = _flatten_examples(items)
        _check_uniform_groups(n_examples)
        if self.task_type in ("action", "transition"):
            texts = [f"{d['q_str']} {d['options_str_list'][i]}"
                     for d in examples for i in range(self.n_options)]
        else:
            texts = [d["q_str"] for d in examples]
        enc = self.tokenizer(texts, max_length=self.max_txt_len)
        labels = None
        if examples[0]["label"] is not None:
            labels = np.asarray([int(d["label"]) for d in examples],
                                dtype=np.int32)
        return dict(
            visual_inputs=visual,
            text_input_ids=enc["input_ids"],
            text_attention_mask=enc["attention_mask"],
            labels=labels,
            question_ids=[d["question_id"] for d in examples],
            n_examples_list=n_examples,
        )


class GITCollator:
    """GIT generative batches.

    Train (add_ans=True): input = [CLS] q + answer + [SEP], labels mask
    the question prefix to -100 (padding positions stay supervised unless
    ``mask_pad_labels=True``, as in the reference).
    Eval: prompt = [CLS] q (no trailing SEP), right-padded with
    per-example lengths.
    """

    def __init__(self, tokenizer, max_txt_len: int = 20,
                 max_seq_len: int = 32, task_type: str = "msvd_qa",
                 nframe: int = 4, samp_policy: str = "random",
                 add_ans: bool = True, mask_pad_labels: bool = False,
                 pixel_dtype: str = "f32"):
        self.tokenizer = tokenizer
        self.max_txt_len = max_txt_len
        self.max_seq_len = max_seq_len
        self.task_type = task_type
        self.nframe = nframe
        self.samp_policy = samp_policy
        self.add_ans = add_ans
        self.mask_pad_labels = mask_pad_labels
        self.pixel_dtype = _pixel_dtype(pixel_dtype)
        # truncation accounting: the fixed max_seq_len bucket can clip
        # the answer off, so count it and warn
        self.n_truncated = 0
        self.n_answer_lost = 0

    def __call__(self, items: List[Dict[str, Any]],
                 rng: Optional[np.random.Generator] = None,
                 ) -> Dict[str, Any]:
        visual = _resample_frames(items, self.samp_policy, self.nframe,
                                  rng, out_dtype=self.pixel_dtype)
        examples, n_examples = _flatten_examples(items)
        _check_uniform_groups(n_examples)
        tok = self.tokenizer
        b = len(examples)

        if self.add_ans:  # training: [CLS] q ans [SEP]
            l = self.max_seq_len
            ids = np.full((b, l), tok.pad_token_id, dtype=np.int32)
            mask = np.zeros((b, l), dtype=np.int32)
            labels = np.full((b, l), tok.pad_token_id, dtype=np.int32)
            for i, d in enumerate(examples):
                q_ids = [tok.cls_token_id] + tok.encode(
                    d["q_str"], add_special_tokens=False)
                a_ids = tok.encode(str(d["str_label"]),
                                   add_special_tokens=False)
                full = q_ids + a_ids + [tok.sep_token_id]
                seq = full[:l]
                if len(full) > l:
                    self.n_truncated += 1
                    if len(q_ids) >= l:
                        self.n_answer_lost += 1
                    if self.n_truncated in (1, 10, 100) \
                            or self.n_truncated % 1000 == 0:
                        LOGGER.warning(
                            f"GIT collator truncated {self.n_truncated} "
                            f"train sequences to max_seq_len={l} "
                            f"({self.n_answer_lost} lost ALL answer "
                            f"supervision) — raise --max_seq_len")
                ids[i, :len(seq)] = seq
                mask[i, :len(seq)] = 1
                lab = np.array(ids[i])
                lab[:min(len(q_ids), l)] = IGNORE_INDEX
                if self.mask_pad_labels:
                    lab[len(seq):] = IGNORE_INDEX
                labels[i] = lab
            return dict(
                visual_inputs=visual,
                text_input_ids=ids, text_attention_mask=mask,
                labels=labels,
                question_ids=[d["question_id"] for d in examples],
                n_examples_list=n_examples,
            )

        # eval: [CLS] q, right-padded + explicit lengths
        l = self.max_txt_len
        ids = np.full((b, l), tok.pad_token_id, dtype=np.int32)
        prompt_len = np.zeros((b,), dtype=np.int32)
        for i, d in enumerate(examples):
            seq = ([tok.cls_token_id]
                   + tok.encode(d["q_str"], add_special_tokens=False))[:l]
            ids[i, :len(seq)] = seq
            prompt_len[i] = len(seq)
        return dict(
            visual_inputs=visual,
            text_input_ids=ids, prompt_len=prompt_len,
            labels=None,
            question_ids=[d["question_id"] for d in examples],
            n_examples_list=n_examples,
        )


def pixel_dtype_for(cfg: Mapping[str, Any]) -> str:
    """The JAX package's rule: ``"u8"`` under ``stage_pixels_u8``; else
    ``"bf16"`` when the run computes in bf16 (``bf16``, default on) and
    ``stage_pixels_bf16`` (default on), half the bytes of f32 with the
    values the model's first product rounds to anyway; else ``"f32"``."""
    if cfg.get("stage_pixels_u8", 0):
        return "u8"
    if cfg.get("bf16", True) and cfg.get("stage_pixels_bf16", 1):
        return "bf16"
    return "f32"


def make_collator(family: str, tokenizer, cfg: Mapping[str, Any]):
    """The training collator of a model family, from a task config."""
    common = dict(max_txt_len=cfg.get("max_txt_len", 20),
                  task_type=cfg.get("task", "msvd_qa"),
                  nframe=cfg.get("nframe", 4),
                  samp_policy=cfg.get("samp_policy", "random"),
                  pixel_dtype=pixel_dtype_for(cfg))
    if family in ("clip", "blip"):
        return ClassifierCollator(tokenizer, **common)
    if family == "git":
        return GITCollator(tokenizer, add_ans=True,
                           max_seq_len=cfg.get("max_seq_len",
                                               common["max_txt_len"] + 12),
                           **common)
    raise ValueError(family)

