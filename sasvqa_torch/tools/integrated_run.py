"""Production-shape integrated run (counterpart of integrated_run.py at
the repo root): the real task loop, ``tasks/run_video_qa``, at
configs/msvd_qa_base.json against an MSVD-size frame store, for a bounded
window, on the GPU.

Unlike an isolated train step on device-resident inputs, this drives the
integrated system: annotation loading, the answer vocabulary, frame reads
through ``open_store``, collation, ``DevicePrefetcher`` staging (bf16 by
default, uint8 with ``--stage_pixels_u8 1``), the scan-accumulated train
step, in-loop validation with generative decode, eval snapshots and
restore checkpoints.  What runs is GIT-base over all 6 stored frames a
question (``samp_policy: uniform`` reads ``nframe: 1`` as its stride over
the K = 6 frames), 6 questions a micro and 72 micros an update: S = 6 x
197 + 32 text tokens = 1214, past the git-flash route's 512, so the text
stack runs the git-flash kernels (K1 forward, K2 backward, the K4
dropout hash inside both).  It prints one JSON line:

    steady steps/s and QA pairs/s, ms per micro over the steady window
    (the first to the last ``step N/M ... (Ts)`` mark of the loop's log,
    less the in-loop validation walls), the first window, each
    validation's wall and QA pairs/s, the final train loss.

    python -m sasvqa_torch.tools.integrated_run [--steps 200] [--root DIR]
        [--val_limit N] [--stage_pixels_u8 1] [--platform cpu]

Epochs are derived from ``--steps`` (at least one: 30,933 questions make
72 updates an epoch).  It runs on the GPU unless ``--platform cpu``.  The
store is synthetic (``tools/make_scale_store``: 1970 videos x 6 frames of
224x224 f32, about 7.1 GB), the weights are random (no convergence claim)
and the tokenizer is the built-in test WordPiece.  ``main``'s ``writer``
and ``open_store`` build and read the store (HDF5 by default; a
``data.frame_store.MemoryFrameStores`` pair where there is no h5py).  A
second run into the same ``--out`` resumes from that run's restore
checkpoint, as the loop does.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import tempfile
import time
from typing import Any, Callable, Dict, List, Tuple

from sasvqa_torch.core.device import resolve_device
from sasvqa_torch.data.frame_store import FrameStoreReader, FrameStoreWriter

CONFIG = os.path.join("configs", "msvd_qa_base.json")
_STEP_MARK = re.compile(r"step (\d+)/(\d+) .*\((\d+)s\)")
_EVAL_WALL = re.compile(r"\[(valid|test|final_valid|final_test)\] (\d+) "
                        r"examples in ([0-9.]+)s")


def read_log(lines) -> Tuple[List[Tuple[int, int]],
                             List[Tuple[str, int, float]]]:
    """The loop's log lines -> (step marks as (step, seconds since the
    loop started), validation walls as (tag, examples, seconds))."""
    step_marks, val_walls = [], []
    for line in lines:
        m = _STEP_MARK.search(line)
        if m:
            step_marks.append((int(m.group(1)), int(m.group(3))))
        m = _EVAL_WALL.search(line)
        if m:
            val_walls.append((m.group(1), int(m.group(2)),
                              float(m.group(3))))
    return step_marks, val_walls


def window_report(step_marks, val_walls, global_batch: int,
                  accum: int) -> Dict[str, Any]:
    """The steady window's rates, from the first to the last step mark
    less every in-loop validation wall (the loop validates both the valid
    and the test split; final_* runs after the last mark), and each
    validation's wall and rate."""
    report: Dict[str, Any] = {}
    if len(step_marks) >= 2:
        (s0, t0), (s1, t1) = step_marks[0], step_marks[-1]
        val_inside = sum(w for tag, _, w in val_walls
                         if tag in ("valid", "test"))
        steady = (t1 - t0) - val_inside
        steps = s1 - s0
        if steady > 0:
            report.update({
                "steady_steps_per_s": round(steps / steady, 4),
                "steady_qa_pairs_per_s": round(
                    steps * global_batch / steady, 1),
                "steady_ms_per_micro": round(
                    1000 * steady / (steps * accum), 2),
                "first_window_s": t0,   # the loop's set-up and warm-up
            })
        else:
            report["steady_window_note"] = (
                "in-loop eval walls exceed the step-mark window; "
                "rerun with more --steps or --val_limit")
    for tag, n, w in val_walls:
        report[f"eval_{tag}_s"] = w
        report[f"eval_{tag}_qa_per_s"] = round(n / w, 1)
    return report


def main(argv=None, *, writer: Callable[..., Any] = FrameStoreWriter,
         open_store: Callable[[str], Any] = FrameStoreReader
         ) -> Dict[str, Any]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=200,
                   help="target global steps (epochs derived)")
    p.add_argument("--root", default=os.path.join(tempfile.gettempdir(),
                                                  "scale_store"))
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                 "integrated_run"))
    p.add_argument("--platform", default=None,
                   help="'cpu' runs on the CPU; default: the GPU")
    p.add_argument("--train_q", type=int, default=30933)
    p.add_argument("--val_q", type=int, default=6415)
    p.add_argument("--num_videos", type=int, default=1970)
    p.add_argument("--store_name", default="main_k6",
                   help="sub-directory under --root (the store is reused "
                        "when its manifest matches)")
    p.add_argument("--stage_pixels_u8", type=int, default=0, choices=[0, 1],
                   help="stage pixels as uint8 (core/pixels.py): half the "
                        "host-to-device bytes of the bf16 default")
    p.add_argument("--val_limit", type=int, default=0,
                   help="evaluate only the first N val/test QA pairs "
                        "(0 = all); the store stays full-size")
    args = p.parse_args(argv)
    resolve_device("cpu" if args.platform == "cpu" else "cuda")

    from sasvqa_torch.tools.make_scale_store import make_scale_store
    # configs/msvd_qa_base.json reads a stage-A store of K = 6 frames a
    # video (its uniform policy at stride 1 takes all six): the store at
    # MSVD's video count
    paths = make_scale_store(
        os.path.join(args.root, args.store_name),
        num_videos=args.num_videos, k=6,
        n_questions={"train": args.train_q, "val": args.val_q,
                     "test": args.val_q}, writer=writer)

    os.makedirs(args.out, exist_ok=True)
    if args.val_limit:
        for split in ("val", "test"):
            with open(paths[split]) as f:
                anno = json.load(f)
            cut = os.path.join(args.out, f"qa_{split}_limit.json")
            with open(cut, "w") as f:
                json.dump(anno[:args.val_limit], f)
            paths[split] = cut

    with open(CONFIG) as f:
        cfg = json.load(f)
    b, accum = cfg["train_batch_size"], cfg["gradient_accumulation_steps"]
    global_batch = b * accum
    epochs = max(1, math.ceil(args.steps * global_batch / args.train_q))
    cfg.update({
        "train_datasets": [{"name": "msvd_qa", "txt": paths["train"],
                            "img": paths["h5"]}],
        "val_datasets": [{"name": "msvd_qa", "txt": paths["val"],
                          "img": paths["h5"]}],
        "inference_txt_db": paths["test"],
        "inference_img_db": paths["h5"],
        "vid_mapping": paths["vidmapping"],
        "tokenizer_dir": None,
        "num_train_epochs": epochs,
        "num_valid": 2,            # one in-loop validation and the final
        "output_dir": os.path.join(args.out, "run"),
        "zero_eval": 0,
        "stage_pixels_u8": args.stage_pixels_u8,
    })
    cfg["model"].pop("pretrained_weights", None)   # random weights
    if args.platform:
        cfg["platform"] = args.platform
    cfg_path = os.path.join(args.out, "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=1)

    # the loop appends to rank 0's log.txt: read only this run's lines
    log_file = os.path.join(cfg["output_dir"], "log", "log.txt")
    start = os.path.getsize(log_file) if os.path.exists(log_file) else 0

    from sasvqa_torch.tasks.run_video_qa import main as run_main
    t0 = time.time()
    res = run_main(["--task", "msvd_qa", "--config", cfg_path],
                   open_store=open_store)
    wall = time.time() - t0

    with open(log_file) as f:
        f.seek(start)
        step_marks, val_walls = read_log(f)
    report = {"config": "integrated_msvd_qa_base",
              "global_steps": int(res["global_step"]),
              "global_batch_qa": global_batch,
              "wall_s": round(wall, 1),
              "train_loss": float(res["train_loss"]),
              **window_report(step_marks, val_walls, global_batch, accum)}
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
