"""A synthetic MSVD-scale frame store and annotations (counterpart of
sasvqa_tpu/tools/make_scale_store.py, with the same bytes and JSON for
the same arguments).

For performance work at the reference's true shapes, without the real
dataset:

- the frame store: ``sampled_frames`` float32 ``(num_videos, K,
  3*img*img)``, by default MSVD's 1970 x 16 x 150528 (about 19 GB), the
  format stage A writes;
- ``vidmapping.json``;
- ``qa_{train,val,test}.json`` at MSVD-QA's question counts (about
  30.9k / 6.4k / 13.2k) with a Zipf answer distribution, so that the
  top-1000 answer vocabulary covers most answers as in the real
  dataset, and ``sampled_inds`` so that the MIF policies run.

Frames are one random template a frame slot plus a per-video offset:
every row differs, and writing is bound by the disk, not by the RNG.
``writer`` builds the store (the HDF5 :class:`FrameStoreWriter` by
default; any callable of its arguments that returns an object with its
``write`` and context-manager methods, e.g. an in-memory store).

    python -m sasvqa_torch.tools.make_scale_store --root scale_store \\
        --num_videos 1970 --k 16 --img_size 224
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from sasvqa_torch.core.logging import LOGGER
from sasvqa_torch.data.frame_store import FrameStoreWriter, save_vidmapping
from sasvqa_torch.utils.basic import save_json

_QW = ["what", "who", "how", "where", "when"]
# MSVD-QA's answer-type mix is mostly 'what' (about 60%)
_QW_P = [0.61, 0.24, 0.07, 0.05, 0.03]
_SUBJ = ["person", "man", "woman", "dog", "cat", "group", "child",
         "player", "car", "animal"]
_VERB = ["doing", "holding", "playing", "riding", "cooking", "singing",
         "throwing", "cutting", "driving", "watching"]


def _answers(n_vocab: int = 1800) -> List[str]:
    return [f"ans{i:04d}" for i in range(n_vocab)]


def make_scale_store(root: str, num_videos: int = 1970, k: int = 16,
                     img_size: int = 224,
                     n_questions: Optional[Dict[str, int]] = None,
                     seed: int = 0,
                     writer: Callable[..., Any] = FrameStoreWriter
                     ) -> Dict[str, str]:
    """Build the store and the annotations under ``root``; returns the
    paths dict.  When ``root/manifest.json`` matches the request and every
    file exists, the files are reused (the store takes minutes)."""
    os.makedirs(root, exist_ok=True)
    n_questions = n_questions or {"train": 30933, "val": 6415,
                                  "test": 13157}
    manifest = {"num_videos": num_videos, "k": k, "img_size": img_size,
                "n_questions": n_questions, "seed": seed, "version": 1}
    man_path = os.path.join(root, "manifest.json")
    paths = {
        "h5": os.path.join(root, "msvd_qa_video_feat.h5"),
        "vidmapping": os.path.join(root, "vidmapping.json"),
        "train": os.path.join(root, "qa_train.json"),
        "val": os.path.join(root, "qa_val.json"),
        "test": os.path.join(root, "qa_test.json"),
    }
    if os.path.exists(man_path):
        with open(man_path) as f:
            if json.load(f) == manifest and all(
                    os.path.exists(p) for p in paths.values()):
                LOGGER.info(f"reusing scale store at {root}")
                return paths

    rng = np.random.default_rng(seed)
    video_ids = [f"vid{i:04d}" for i in range(num_videos)]

    t0 = time.time()
    template = rng.normal(0.0, 1.0, size=(k, 3 * img_size * img_size)) \
        .astype(np.float32)
    with writer(paths["h5"], num_videos, k, img_size) as w:
        for i in range(num_videos):
            w.write(i, template + np.float32(0.001 * (i % 997)))
    LOGGER.info(f"store {num_videos}x{k}x{3 * img_size * img_size} "
                f"written in {time.time() - t0:.0f}s")

    save_vidmapping(video_ids, paths["vidmapping"])

    answers = _answers()
    zipf_p = 1.0 / np.arange(1, len(answers) + 1)
    zipf_p /= zipf_p.sum()
    for split, n_q in n_questions.items():
        qw = rng.choice(len(_QW), size=n_q, p=_QW_P)
        subj = rng.integers(0, len(_SUBJ), size=n_q)
        verb = rng.integers(0, len(_VERB), size=n_q)
        vids = rng.integers(0, num_videos, size=n_q)
        ans = rng.choice(len(answers), size=n_q, p=zipf_p)
        annos = []
        for j in range(n_q):
            annos.append(dict(
                question=(f"{_QW[qw[j]]} is the {_SUBJ[subj[j]]} "
                          f"{_VERB[verb[j]]}?"),
                answer=answers[ans[j]],
                video=f"{video_ids[vids[j]]}.avi",
                answer_type=_QW[qw[j]],
                sampled_inds=rng.permutation(k).tolist()))
        save_json(annos, paths[split])
        LOGGER.info(f"{split}: {n_q} questions")

    with open(man_path, "w") as f:
        json.dump(manifest, f)
    return paths


def main(argv=None, *, writer: Callable[..., Any] = FrameStoreWriter) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", required=True,
                   help="directory for the store and the annotations")
    p.add_argument("--num_videos", type=int, default=1970)
    p.add_argument("--k", type=int, default=16)
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--train_q", type=int, default=30933)
    p.add_argument("--val_q", type=int, default=6415)
    p.add_argument("--test_q", type=int, default=13157)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    paths = make_scale_store(
        args.root, args.num_videos, args.k, args.img_size,
        {"train": args.train_q, "val": args.val_q, "test": args.test_q},
        args.seed, writer=writer)
    print(json.dumps(paths))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
