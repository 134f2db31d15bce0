"""Where a serving batch spends its time on the GPU.

    python3 -m sasvqa_torch.tools.profile_serve [--family git|blip|mdf]
                                                [--trace DIR]

Runs ``torch.profiler`` at full width (seeded random weights, bf16
activations) at the serving shapes of chip_smoke.py:

- ``git``: one ``prompt_fill`` and 8 decode steps of GIT-base, batch 8,
  8 frames of 224x224, 20 prompt tokens, 50-token budget;
- ``blip``: the BLIP-base classifier's vision tower alone and its whole
  eval forward, batch 16, 4 frames of 384x384 (577 tokens a frame), 20
  text tokens, 1000 labels;
- ``mdf``: stage A's MDF encoder (GIT-base's vision tower in bf16, its
  plain attention in f32) over the 2,048-frame bucket of 224x224 frames,
  then the selection (K 16, W 8) on its pooled features.

Prints one JSON line per part: host wall ms (ending in a synchronize),
the device time of every CUDA kernel summed, the device busy share (union
of kernel intervals over the wall time), the kernel launch count, and the
kernels that took the most device time.  ``--trace DIR`` also writes
Chrome traces there.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from sasvqa_torch.models.presets import build_model

STEPS = 8


def _busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def profile_part(name, fn, trace_dir=None, top=8, keep_all=False):
    """Profile one call of ``fn``; ``keep_all`` adds every kernel's
    summed device time under ``top_all``."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    per_name = {}
    for e in kernels:
        per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.json"))
    ranked = [{"kernel": k[:80], "ms": v / 1e3} for k, v in
              sorted(per_name.items(), key=lambda kv: -kv[1])]
    row = {"part": name, "wall_ms": wall_us / 1e3,
           "kernel_ms": sum(per_name.values()) / 1e3,
           "busy_share": busy / wall_us, "launches": len(kernels),
           "top": ranked[:top]}
    if keep_all:
        row["top_all"] = ranked
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--family", choices=("git", "blip", "mdf"),
                   default="git")
    p.add_argument("--trace", default=None)
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.family == "blip":
        return _profile_blip(args.trace)
    if args.family == "mdf":
        return _profile_mdf(args.trace)
    _, model = build_model(
        {"model": {"pretrained_model": "microsoft/git-base-msrvtt-qa"}},
        dtype=torch.bfloat16, device="cuda",
        generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, frames, img, lp, max_text_len = 8, 8, 224, 20, 50
    ids = torch.randint(5, 1000, (b, lp), generator=gen, device="cuda")
    plen = torch.randint(3, lp + 1, (b,), generator=gen, device="cuda")
    px = torch.randn((b, frames, img, img, 3), generator=gen, device="cuda")

    with torch.inference_mode():
        def fill():
            return model.prompt_fill(ids, plen, px, max_text_len)

        logits, cache = fill()                  # warm-up
        tok = logits.argmax(-1)
        model.decode_step(tok, cache)

        def decode():
            nonlocal cache
            for _ in range(STEPS):
                _, cache = model.decode_step(tok, cache)

        _, cache = fill()
        for name, fn in (("prompt_fill", fill), ("decode_steps", decode)):
            row = profile_part(name, fn, args.trace)
            if name == "decode_steps":
                row["steps"] = STEPS
            print(json.dumps(row), flush=True)
    return 0


def _profile_blip(trace_dir) -> int:
    _, model = build_model(
        {"model": {"pretrained_model": "Salesforce/blip-base"},
         "num_labels": 1000, "classifier": "mlp"},
        dtype=torch.bfloat16, device="cuda",
        generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, frames, img, l = 16, 4, 384, 20
    ids = torch.randint(1000, 2000, (b, l), generator=gen, device="cuda")
    mask = torch.ones_like(ids)
    mask[:, 12:] = 0
    px = torch.randn((b, frames, img, img, 3), generator=gen, device="cuda")
    with torch.inference_mode():
        def vision():
            model.vis_model(px.to(torch.bfloat16).flatten(0, 1))

        def forward():
            model(ids, mask, px)["logits"].argmax(-1)

        forward()                               # warm-up
        for name, fn in (("vision_tower", vision),
                         ("classifier_forward", forward)):
            row = profile_part(name, fn, trace_dir)
            row.update(batch=b, frames=frames, img=img)
            print(json.dumps(row), flush=True)
    return 0


def _profile_mdf(trace_dir) -> int:
    from sasvqa_torch.sampling.mdf import mdf_select_padded
    from sasvqa_torch.tools.extract_frames import MDFEncoder
    enc = MDFEncoder(16, 8, device="cuda")
    n = 2048
    frames = torch.randn((n, 224, 224, 3),
                         generator=torch.Generator().manual_seed(0)).numpy()
    feats = enc.encode(frames)                  # warm-up
    with torch.inference_mode():
        for name, fn in (("mdf_encode", lambda: enc.encode(frames)),
                         ("mdf_select", lambda: mdf_select_padded(
                             feats, n - 100, 16, 8))):
            row = profile_part(name, fn, trace_dir)
            row.update(frames=n, img=224)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
