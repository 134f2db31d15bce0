"""The benchmark's data: an MSVD-QA-scale frame store in host memory and
its annotations, made from the seed.

A frozen copy of the scale-store generator the program ships
(``make_scale_store``): the same draws in the same order, so the same
seed gives the same frames and questions.

- frames: ``(num_videos, K, 3 * img * img)`` f32, channel-first rows as
  stage A writes them; one random template a frame slot plus a
  per-video offset ``0.001 * (i % 997)``;
- questions: ``"<wh> is the <subject> <verb>?"`` with MSVD-QA's mix of
  question words, answers ``ans0000``.. drawn from a Zipf law over 1,800,
  a uniform video, and ``sampled_inds`` (a permutation of the K frames,
  for the caption-ranked policies).

Nothing goes to disk here; :func:`write_annotations` writes the JSON
files the task loop reads.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

import numpy as np

QW = ["what", "who", "how", "where", "when"]
QW_P = [0.61, 0.24, 0.07, 0.05, 0.03]
SUBJ = ["person", "man", "woman", "dog", "cat", "group", "child",
        "player", "car", "animal"]
VERB = ["doing", "holding", "playing", "riding", "cooking", "singing",
        "throwing", "cutting", "driving", "watching"]
N_ANSWERS = 1800
SPLITS = ("train", "val", "test")


def answers() -> List[str]:
    return [f"ans{i:04d}" for i in range(N_ANSWERS)]


def words() -> List[str]:
    """Every word the questions and answers use."""
    return sorted(set(QW + SUBJ + VERB + ["is", "the"])) + answers()


def video_ids(num_videos: int) -> List[str]:
    return [f"vid{i:04d}" for i in range(num_videos)]


def make(num_videos: int, k: int, img_size: int,
         n_questions: Dict[str, int], seed: int) -> Dict[str, Any]:
    """{"frames": (V, K, 3*img*img) f32, "annotations": {split: [..]},
    "video_ids": [...]}."""
    rng = np.random.default_rng(seed)
    template = rng.normal(0.0, 1.0, size=(k, 3 * img_size * img_size)) \
        .astype(np.float32)
    frames = np.empty((num_videos, k, template.shape[1]), np.float32)
    offsets = (0.001 * (np.arange(num_videos) % 997)).astype(np.float32)
    step = 64
    for i in range(0, num_videos, step):
        np.add(template[None], offsets[i:i + step, None, None],
               out=frames[i:i + step])
    vids = video_ids(num_videos)
    ans = answers()
    zipf_p = 1.0 / np.arange(1, len(ans) + 1)
    zipf_p /= zipf_p.sum()
    annos: Dict[str, List[Dict[str, Any]]] = {}
    for split, n_q in n_questions.items():
        qw = rng.choice(len(QW), size=n_q, p=QW_P)
        subj = rng.integers(0, len(SUBJ), size=n_q)
        verb = rng.integers(0, len(VERB), size=n_q)
        vid = rng.integers(0, num_videos, size=n_q)
        a = rng.choice(len(ans), size=n_q, p=zipf_p)
        annos[split] = [dict(
            question=f"{QW[qw[j]]} is the {SUBJ[subj[j]]} {VERB[verb[j]]}?",
            answer=ans[a[j]], video=f"{vids[vid[j]]}.avi",
            answer_type=QW[qw[j]],
            sampled_inds=rng.permutation(k).tolist()) for j in range(n_q)]
    return {"frames": frames, "annotations": annos, "video_ids": vids}


def msrvtt_format(data: Dict[str, Any]) -> Dict[str, Any]:
    """The same data in MSRVTT-QA's annotation format: an integer
    ``video_id`` a question, videos named ``video<id>``."""
    row = {v: i for i, v in enumerate(data["video_ids"])}
    annos = {split: [{"question": a["question"], "answer": a["answer"],
                      "video_id": row[a["video"].split(".")[0]],
                      "sampled_inds": a["sampled_inds"]} for a in rows]
             for split, rows in data["annotations"].items()}
    return dict(data, annotations=annos,
                video_ids=[f"video{i}" for i in range(len(row))])


def video_row(anno: Dict[str, Any]) -> int:
    """The store row of an annotation in either format."""
    if "video_id" in anno:
        return int(anno["video_id"])
    return int(anno["video"].split(".")[0][len("vid"):])


def write_annotations(data: Dict[str, Any], root: str) -> Dict[str, str]:
    """The splits' JSON files and ``vidmapping.json`` under ``root``;
    returns their paths."""
    os.makedirs(root, exist_ok=True)
    paths = {}
    for split, annos in data["annotations"].items():
        paths[split] = os.path.join(root, f"qa_{split}.json")
        with open(paths[split], "w") as f:
            json.dump(annos, f)
    paths["vidmapping"] = os.path.join(root, "vidmapping.json")
    with open(paths["vidmapping"], "w") as f:
        json.dump({v: i for i, v in enumerate(data["video_ids"])}, f)
    return paths
