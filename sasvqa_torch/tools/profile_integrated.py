"""The integrated run on the GPU, beside the isolated update at its shape.

    python3 -m sasvqa_torch.tools.profile_integrated [--steps 60]
        [--val_limit 256] [--num_videos 1970] [--train_q 30933]
        [--val_q 6415] [--out DIR]

For each pixel staging (``bf16``, the loop's default, then ``u8``),
``tools/integrated_run.main`` at its defaults (configs/msvd_qa_base.json:
GIT-base, 6 frames a question, S = 1214, 6 questions a micro, 72 micros
an update,
over a 1970-video K = 6 store of 30,933 / 6,415 questions) with the flags
above, its store built and read in host memory
(``data.frame_store.MemoryFrameStores``: no h5py needed).  The loop's
third update (past the first two, which warm up) runs under
``torch.profiler``: its
host wall (ending in a synchronize), the device busy share, the kernel
time and launches, the kernels that took the most device time.  Each run
prints one JSON line: the integrated report, the profiled update, the
run's ``train/loss`` curve and the peak device memory.

Then the isolated update at the same shape: ``make_scan_train_step(72,
"git")`` over 72 device-resident micros of ``profile_step.GitShape(
"microsoft/git-base-msrvtt-qa", batch=6, frames=6, text_len=32)`` (the
loop's text length: ``max_txt_len`` 20 + 12) with AdamW, seeded weights,
the same dropouts: the host wall of an update after a warm-up, and one
update under the profiler.  The gap between the two is what the loop,
its input path and the host add.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import torch

from sasvqa_torch.data.frame_store import MemoryFrameStores
from sasvqa_torch.models.presets import build_model
from sasvqa_torch.tools import integrated_run
from sasvqa_torch.tools.profile_serve import profile_part
from sasvqa_torch.tools.profile_step import OPTIM, GitShape, git_batch
from sasvqa_torch.train import steps as train_steps

SHAPE = GitShape("microsoft/git-base-msrvtt-qa", batch=6, frames=6,
                 text_len=32)
K_MICRO = 72
STAGINGS = ("bf16", "u8")
PROFILE_UPDATE = 3


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def integrated(argv, profile_update: int) -> dict:
    """One integrated run; its loop's update number ``profile_update``
    (from 1) under the profiler."""
    stores = MemoryFrameStores()
    profiled = {}
    real_factory = train_steps.make_scan_train_step

    def factory(*a, **kw):
        step = real_factory(*a, **kw)
        calls = [0]

        def run(state, batch, seed):
            calls[0] += 1
            if calls[0] != profile_update:
                return step(state, batch, seed)
            out = []
            profiled.update(profile_part(
                "integrated_update",
                lambda: out.append(step(state, batch, seed))))
            return out[0]
        return run

    torch.cuda.reset_peak_memory_stats()
    train_steps.make_scan_train_step = factory
    try:
        report = integrated_run.main(argv, writer=stores.writer,
                                     open_store=stores.open_store)
    finally:
        train_steps.make_scan_train_step = real_factory
    out = argv[argv.index("--out") + 1]
    with open(os.path.join(out, "run", "log", "scalars.jsonl")) as f:
        losses = [(r["step"], r["value"]) for r in map(json.loads, f)
                  if r["tag"] == "train/loss"]
    return {"report": report, "profiled_update": profiled,
            "profile_update": profile_update, "train_loss_curve": losses,
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 2 ** 30}


def isolated(reps: int = 3) -> dict:
    """The update at the loop's shape on device-resident micros."""
    dev = torch.device("cuda")
    _, model = build_model(SHAPE.cfg(), dtype=torch.bfloat16, device=dev,
                           generator=torch.Generator().manual_seed(0))
    state = train_steps.create_train_state(model, OPTIM, total_steps=1000,
                                           device=dev)
    step = train_steps.make_scan_train_step(K_MICRO, "git", device=dev)
    micro = git_batch(SHAPE, dev)
    batch = {k: v.unsqueeze(0).expand(K_MICRO, *v.shape)
             for k, v in micro.items()}

    def update():
        nonlocal state
        state, metrics = step(state, batch, 0)
        return metrics["loss"]

    update().item()                              # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        update()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / reps * 1e3
    prof = profile_part("isolated_update", update)
    return {"shape": {"model": SHAPE.model, "batch": SHAPE.batch,
                      "frames": SHAPE.frames, "text_len": SHAPE.text_len,
                      "seq": SHAPE.seq, "k_micro": K_MICRO},
            "update_ms": wall_ms, "ms_per_micro": wall_ms / K_MICRO,
            "reps": reps, "profiled_update": prof}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--val_limit", type=int, default=256)
    p.add_argument("--num_videos", type=int, default=1970)
    p.add_argument("--train_q", type=int, default=30933)
    p.add_argument("--val_q", type=int, default=6415)
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                 "profile_integrated"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_integrated measures the GPU: no CUDA "
                           "device is visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"card": card(),
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    for staging in STAGINGS:
        run_argv = ["--steps", str(args.steps), "--val_limit",
                    str(args.val_limit), "--num_videos",
                    str(args.num_videos), "--train_q", str(args.train_q),
                    "--val_q", str(args.val_q), "--stage_pixels_u8",
                    str(int(staging == "u8")),
                    "--root", os.path.join(args.out, "store"),
                    "--out", os.path.join(args.out, staging)]
        row = integrated(run_argv, PROFILE_UPDATE)
        print(json.dumps({"run": "integrated", "staging": staging,
                          "argv": run_argv, **row}), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"run": "isolated", **isolated()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
