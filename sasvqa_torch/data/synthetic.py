"""Deterministic synthetic fixtures: fake videos, frame stores and QA
annotations (counterpart of sasvqa_tpu/data/synthetic.py, with the same
arrays and JSON for the same arguments).

Frames are piecewise-constant 'scenes' plus slow drift, so samplers have
real structure to find; annotations come in the msvd_qa / msrvtt_qa JSON,
TGIF frameqa JSONL and TGIF multiple-choice JSONL formats.  ``writer``
builds the frame store: the HDF5 :class:`FrameStoreWriter` by default, or
any callable of the same arguments that returns an object with its
``write`` and context-manager methods (an in-memory store where there is
no h5py).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List

import numpy as np

from sasvqa_torch.data.frame_store import FrameStoreWriter, save_vidmapping
from sasvqa_torch.utils.basic import save_json, save_jsonl

_QUESTION_WORDS = ["what", "who", "how", "where", "when"]
_SUBJECTS = ["man", "woman", "dog", "cat"]
_VERBS = ["running", "jumping", "playing"]
_ANSWERS = ["red", "blue", "green", "ball", "dog", "cat", "man", "woman"]

Writer = Callable[[str, int, int, int], Any]


def make_video_frames(video_idx: int, num_frames: int, img_hw: int,
                      num_scenes: int = 3) -> np.ndarray:
    """(N, H, W, 3) float32 frames with piecewise-constant 'scenes' plus
    slow drift — gives MDF-style samplers real structure to detect."""
    rng = np.random.default_rng(1000 + video_idx)
    scene_vals = rng.uniform(-1, 1, size=(num_scenes, 3))
    bounds = np.sort(rng.choice(
        np.arange(1, num_frames), size=num_scenes - 1, replace=False)) \
        if num_scenes > 1 else np.array([], dtype=int)
    frames = np.zeros((num_frames, img_hw, img_hw, 3), np.float32)
    scene = 0
    for t in range(num_frames):
        if scene < len(bounds) and t >= bounds[scene]:
            scene += 1
        base = scene_vals[scene]
        drift = 0.05 * np.sin(t / 7.0 + video_idx)
        noise = rng.normal(scale=0.02, size=(img_hw, img_hw, 3))
        frames[t] = base[None, None, :] + drift + noise
    return frames.astype(np.float32)


def _write_store(path: str, num_videos: int, stored_frames: int,
                 img_hw: int, writer: Writer) -> None:
    with writer(path, num_videos, stored_frames, img_hw) as w:
        for i in range(num_videos):
            frames = make_video_frames(i, stored_frames, img_hw)
            w.write(i, frames.transpose(0, 3, 1, 2))  # store CHW


def make_synthetic_dataset(root: str, task: str = "msvd_qa",
                           num_videos: int = 6, stored_frames: int = 8,
                           img_hw: int = 32,
                           questions_per_video: int = 3,
                           with_sampled_inds: bool = True,
                           seed: int = 0,
                           writer: Writer = FrameStoreWriter
                           ) -> Dict[str, str]:
    """Create a frame store + vidmapping + qa_{train,val,test}.json under
    root.  Returns paths dict {h5, vidmapping, train, val, test}."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    if task == "msvd_qa":
        video_ids = [f"vid{i:04d}" for i in range(num_videos)]
    else:
        video_ids = [f"video{i}" for i in range(num_videos)]

    h5_path = os.path.join(root, f"{task}_video_feat.h5")
    _write_store(h5_path, num_videos, stored_frames, img_hw, writer)
    map_path = os.path.join(root, "vidmapping.json")
    save_vidmapping(video_ids, map_path)

    paths = {"h5": h5_path, "vidmapping": map_path}
    for split in ("train", "val", "test"):
        annos: List[dict] = []
        for i, vid in enumerate(video_ids):
            for q in range(questions_per_video):
                qw = _QUESTION_WORDS[(i + q) % len(_QUESTION_WORDS)]
                question = (f"{qw} is the "
                            f"{_SUBJECTS[(i + q) % len(_SUBJECTS)]} "
                            f"{_VERBS[q % len(_VERBS)]}?")
                answer = _ANSWERS[(i * questions_per_video + q)
                                  % len(_ANSWERS)]
                if task == "msvd_qa":
                    d = dict(question=question, answer=answer,
                             video=f"{vid}.avi", answer_type=qw)
                else:
                    d = dict(question=question, answer=answer,
                             video_id=i)
                if with_sampled_inds:
                    d["sampled_inds"] = rng.permutation(
                        stored_frames).tolist()
                annos.append(d)
        p = os.path.join(root, f"qa_{split}.json")
        save_json(annos, p)
        paths[split] = p
    return paths


def make_synthetic_frameqa_dataset(root: str, num_videos: int = 4,
                                   stored_frames: int = 8, img_hw: int = 32,
                                   seed: int = 0,
                                   writer: Writer = FrameStoreWriter
                                   ) -> Dict[str, str]:
    """TGIF frameqa fixtures: JSONL open-ended annotations with the
    frameqa answer types (object/number/color/location).  ``seed`` is
    kept for the JAX package's signature; nothing here draws from it."""
    os.makedirs(root, exist_ok=True)
    video_ids = [f"gif{i:04d}" for i in range(num_videos)]
    h5_path = os.path.join(root, "frameqa_video_feat.h5")
    _write_store(h5_path, num_videos, stored_frames, img_hw, writer)
    map_path = os.path.join(root, "vidmapping.json")
    save_vidmapping(video_ids, map_path)

    types = ["object", "number", "color", "location"]
    type_answers = {"object": ["ball", "dog"], "number": ["2", "3"],
                    "color": ["red", "blue"], "location": ["room", "park"]}
    paths = {"h5": h5_path, "vidmapping": map_path}
    for split in ("train", "val", "test"):
        annos: List[dict] = []
        for i, vid in enumerate(video_ids):
            for q in range(2):
                at = types[(i + q) % len(types)]
                annos.append(dict(
                    gif_name=vid,
                    question=f"what {at} is in the video ?",
                    answer=type_answers[at][(i + q) % 2],
                    answer_type=at))
        p = os.path.join(root, f"frameqa_{split}.jsonl")
        save_jsonl(annos, p)
        paths[split] = p
    return paths


def make_synthetic_mc_dataset(root: str, task: str = "action",
                              num_videos: int = 6, stored_frames: int = 8,
                              img_hw: int = 32, n_options: int = 5,
                              seed: int = 0,
                              writer: Writer = FrameStoreWriter
                              ) -> Dict[str, str]:
    """TGIF-QA style multiple-choice fixtures: JSONL with options and an
    integer answer index (reference tgif format, run_video_qa.py:95-120)."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    video_ids = [f"gif{i:04d}" for i in range(num_videos)]
    h5_path = os.path.join(root, f"{task}_video_feat.h5")
    _write_store(h5_path, num_videos, stored_frames, img_hw, writer)
    map_path = os.path.join(root, "vidmapping.json")
    save_vidmapping(video_ids, map_path)

    paths = {"h5": h5_path, "vidmapping": map_path}
    for split in ("train", "val", "test"):
        annos: List[dict] = []
        for vid in video_ids:
            options = [f"{_SUBJECTS[j % len(_SUBJECTS)]} "
                       f"{_VERBS[j % len(_VERBS)]}"
                       for j in range(n_options)]
            annos.append(dict(
                gif_name=vid,
                question="what does the person do ?",
                options=options,
                answer=int(rng.integers(0, n_options))))
        p = os.path.join(root, f"{task}_{split}.jsonl")
        save_jsonl(annos, p)
        paths[split] = p
    return paths
