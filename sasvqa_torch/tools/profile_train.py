"""Where a GIT-base training update spends its time on the GPU.

    python3 -m sasvqa_torch.tools.profile_train [--trace DIR]

Runs ``torch.profiler`` over one ``make_scan_train_step`` update of
GIT-base at full width (seeded random weights, bf16 activations, f32
params, dropout 0.1 and attention dropout 0.1, 2 micro-batches of 16
questions over 8 frames of 224x224, text length 32, S = 1608: the train
phase of chip_smoke.py) after one warm-up update.  Prints one JSON line:
host wall ms (ending in a synchronize), the device time of every CUDA
kernel summed, the device busy share, the launch count, the kernels that
took the most device time, and the device time of the kernel groups
(the port's git-flash kernels, GEMMs, the rest).  A second line splits
one micro-batch's time (host clock, ending in a synchronize) into the
vision tower's forward, the whole forward, forward+backward, and the
optimizer update.  ``--trace DIR`` also writes a Chrome trace there.
Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from sasvqa_torch.models.presets import build_model
from sasvqa_torch.tools.profile_serve import profile_part
from sasvqa_torch.train.steps import (_git_loss, create_train_state,
                                      make_scan_train_step)

K_MICRO, BATCH, FRAMES, IMG, TEXT_LEN = 2, 16, 8, 224, 32
OPTIM = {"optim": "adamw", "learning_rate": 2e-4, "betas": [0.9, 0.98],
         "weight_decay": 1e-3, "grad_norm": 5.0, "decay": "constant"}


def _batch(seed: int):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1000, 2000, (K_MICRO, BATCH, TEXT_LEN))
    mask = np.ones_like(ids)
    mask[:, :, 20:] = 0
    labels = np.where(mask == 1, ids, 0)
    labels[:, :, :8] = -100
    px = rng.standard_normal((K_MICRO, BATCH, FRAMES, IMG, IMG, 3),
                             dtype=np.float32)
    return {"text_input_ids": ids, "text_attention_mask": mask,
            "visual_inputs": px, "labels": labels}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trace", default=None)
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, model = build_model(
        {"model": {"pretrained_model": "microsoft/git-base-msrvtt-qa"}},
        dtype=torch.bfloat16, device="cuda",
        generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, OPTIM, total_steps=100)
    step = make_scan_train_step(K_MICRO, "git")
    batch = _batch(0)

    def update():
        nonlocal state
        state, metrics = step(state, batch, 0)
        metrics["loss"].item()

    update()                                   # warm-up
    row = profile_part("train_update", update, args.trace, top=12,
                       keep_all=True)
    groups = {"git_flash": 0.0, "gemm": 0.0, "other": 0.0}
    for item in row["top_all"]:
        name = item["kernel"]
        key = ("git_flash" if "git_flash" in name else
               "gemm" if any(t in name.lower() for t in
                             ("gemm", "cutlass", "sm90_xmma", "nvjet"))
               else "other")
        groups[key] += item["ms"]
    del row["top_all"]
    row.update(k_micro=K_MICRO, batch_size=BATCH, frames=FRAMES,
               seq_len=FRAMES * 197 + TEXT_LEN, group_ms=groups)
    print(json.dumps(row), flush=True)
    print(json.dumps(_parts(state, batch)), flush=True)
    return 0


def _wall_ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _parts(state, batch):
    """Host-clock ms of the pieces of one micro-batch and of the update."""
    model, dev = state.model, torch.device("cuda")
    micro = {k: batch[k][0] for k in ("text_input_ids",
                                       "text_attention_mask",
                                       "visual_inputs", "labels")}
    px = torch.from_numpy(micro["visual_inputs"]).to(dev)

    def loss():
        gen = torch.Generator(device=dev).manual_seed(0)
        return _git_loss(model, micro, gen, dev)

    def vision():
        with torch.no_grad():
            model.encode_frames(px)

    def forward():
        with torch.no_grad():
            loss()

    def fwd_bwd():
        loss().backward()

    grads = [p.grad for p in state.optimizer.params]
    # the last item applies further updates: the state is not used after
    return {"part": "micro_split", "vision_fwd_ms": _wall_ms(vision),
            "fwd_ms": _wall_ms(forward), "fwd_bwd_ms": _wall_ms(fwd_bwd),
            "h2d_pixels_ms": _wall_ms(lambda: torch.from_numpy(
                micro["visual_inputs"]).to(dev)),
            "optimizer_update_ms": _wall_ms(
                lambda: state.optimizer.update(grads))}


if __name__ == "__main__":
    raise SystemExit(main())
