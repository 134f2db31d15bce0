#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sasvqa_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the serving and training paths from the
sources in the checkout and holds each kernel against its plain PyTorch
version at the shapes the paths give it (the LayerNorm kernels at
BLIP-large's and GIT-base's activation rows, timed on cold inputs beside
their HBM bound, the plain formula's ATen chain and ``F.layer_norm``).
Then it drives the main paths at full width (seeded random weights),
checking that each went through its kernels:

- GIT-base serving through ``QAEngine`` (8 frames of 224x224 a request),
  a check of the GIT training route's gradients against the dense
  route's, and GIT-base training with ``make_scan_train_step`` at the
  bench's flagship shape (B=16, 8 frames, S=1608, dropout on);
- BLIP-base classifier serving through ``QAEngine(family="blip")``
  (batch 16, 4 frames of 384x384, 577 tokens a frame), a check of the
  BLIP kernel route's gradients against the plain route's at three seeds,
  and BLIP-base training with ``make_scan_train_step(family="classifier")``
  (4 micros of 8 questions, adam);
- GIT with the ViT-L/14 tower at 16 frames (S = 4144, remat, dropout
  0.1/0.1): K3 (the split backward) against its plain version and against
  K2 (the fused one, and K2 against its own plain version) over
  S = 604..4144 at rates 0 and 0.1 (the crossover in S, reported beside
  the route ``FUSED_BWD``), a
  gradient check of the K3 route against the K2 route and of remat on
  against off on the routed backward, and the task loop itself,
  ``start_training`` from a config file (4 updates, validation,
  snapshots, frames from an in-memory store);
- the classifier branch of the same loop on configs/msvd_qa_base3.json:
  CLIP ViT-B/16 as shipped, its ``model.pretrained_weights`` a seeded
  full-width checkpoint in HF CLIPModel names (written by
  ``sasvqa_torch.tools.hf_checkpoint`` without transformers) and its
  ``tokenizer_dir`` a BPE vocabulary of its questions (6 updates; every
  loaded leaf checked against the port converter's tree of the
  checkpoint, three of them against its raw tensors), then BLIP-base at
  384x384 (6 updates, through K5 and K6, each of whose shapes in the run
  was held against its plain version above);
- TGIF-QA multiple choice through the same loop (TGIF-format JSONL
  annotations written here, 5 options a question): ``action`` with
  BLIP-base at 384x384 (6 updates, K5 and K6, each shape held as above)
  and ``transition`` with CLIP ViT-B/16 loaded from the same seeded
  checkpoint (the loader keeps only ``mc_head`` from init);
- the loop's other single-device options on the CLIP config, 2 updates
  each: MultiSteps accumulation (``scan_accum: 0``), bf16 Adam moments,
  adamax, sgd, collation in 2 worker processes (its first batch the
  same bytes as the thread's) and f32 pixel staging against the default
  bf16 (the pixel bytes an update of both);
  and a seeded full-width GIT-base checkpoint in HF GitForCausalLM names
  loaded by ``load_pretrained_params`` and served one batch;
- the offline stages and the CLIs: stage A (``extract`` with repr over 4
  in-memory videos of 300-2,500 frames, GIT-base vision in bf16, the
  selection held to the host oracle on the features read back), stage B
  (``gen_sample.main``: captions of 8 x 32 stored frames by GIT-base,
  then BERT-base-dims scores of 64 questions x 32 captions, the scorer
  held to the CPU), and the single-video ``predict`` and JSONL
  ``serve`` CLIs through ``main(argv)`` on raw AVI files at 6 frames
  (GIT-mask forward K1 in the prompt fill, also held at both CLI shapes
  against its plain version);
- the retrieval task (``run_retrieval.main``: CLIP ViT-B/16's projected
  towers loaded from the same seeded checkpoint, 256 videos of 4 frames,
  its metrics held to ranks recomputed in f64 from its embeddings), the
  vision tower's remat policies at vitl16 (full recompute, the two
  dot-saving named policies, no remat: ms an update, peak memory, K1/K2/K4
  launches, and each policy's loss and gradients held to full
  recompute's), ``profile_step``'s flagship probes, and ``quickstart
  --family git`` through its store seams; every K1 and K2 shape of the
  sweep and of the probes was held against the plain versions above
  (the sweep's B 4 among the training shapes);
- multi-process training on one card (``dist_task_loop``):
  ``start_training`` on configs/msvd_qa_base.json (GIT-base, 8 frames,
  S = 1608, dropout on, 3 updates of 2 micros of 8, one validation)
  without a process group, then under a real 1-rank NCCL group on the
  data route (gradient all-reduce) and on the FSDP2 route (``data
  fsdp`` [1, 1]): each update's loss held to the run without a group,
  the FSDP run's snapshot loaded into a fresh model, ms an update, peak
  memory and the NCCL kernels' device time of each run;
- the production-shape integrated run before it (``integrated_run``:
  ``tools/integrated_run.main`` on configs/msvd_qa_base.json, GIT-base
  over the 6 frames a question of a K = 6 store built in host memory, S =
  1214, so K1, K2 and K4; cut to 64 videos, 720 questions and 4 micros an
  update; its report's keys, steps, eval counts, losses, snapshots and
  steady window checked, its K1/K2 shapes held above).

Every kernel row carries the kernel's device time from ``torch.profiler``
beside CUDA events round its Python call (the backward rows: every
kernel the launcher runs), and SDPA's time on the same inputs by device
time (the backwards: fwd+bwd window minus fwd window) with the kernels
it ran.

A train step replays its micros from a captured CUDA graph, which no
kernel wrapper sees: the two train phases count the port's kernels in
the profiler's device records of one more update and hold those counts,
and the kernels line reports launches so measured, the wrappers' own
and the train phases' traced ones, never the counts a replay adds from
its capture (``ops._build.replayed_counts``).

Each phase prints one JSON line; the line before the last lists the
kernels, the last is ``{"ok": true, "device": {...}}``.  Exits non-zero,
with no result, when there is no GPU or any check fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from sasvqa_torch.data.dataset import (ClassifierCollator, GITCollator,
                                       pixel_dtype_for)
from sasvqa_torch.data.frame_store import MemoryFrameStores
from sasvqa_torch.data.pipeline import stack_microbatches
from sasvqa_torch.data.tokenization import make_test_wordpiece
from sasvqa_torch.models.git import (GITForCausalLM, git_attention_bias,
                                     greedy_generate)
from sasvqa_torch.models import convert as cv
from sasvqa_torch.models.presets import (_clip_configs, _git_config,
                                         build_model, load_pretrained_params)
from sasvqa_torch.ops import _build
from sasvqa_torch.ops.attention import padding_bias
from sasvqa_torch.ops.flash_attention import (_launch_dkv, _launch_dq,
                                              flash_attention_reference,
                                              flash_backward_reference,
                                              flash_forward)
from sasvqa_torch.ops import flash_attention as fa
from sasvqa_torch.ops import git_flash as gf
from sasvqa_torch.ops.git_flash import (git_flash_attention,
                                        git_flash_attention_reference,
                                        git_flash_backward_reference,
                                        git_mask_ok, hash_dropout_factor)
from sasvqa_torch.tasks import run_video_qa
from sasvqa_torch.tasks.serve import QAEngine
from sasvqa_torch.tools.bwd_yardstick import (LEAD_FILLS, MARK, MARK_CYCLES,
                                              PROFILER_STATS, cuda_ms,
                                              device_window, sdpa_backward)
from sasvqa_torch.tools.hf_checkpoint import (check_loaded, hf_clip_shapes,
                                              hf_git_shapes,
                                              write_hf_checkpoint)
from sasvqa_torch.tools import profile_config as pc
from sasvqa_torch.tools import profile_step as ps
from sasvqa_torch.train import steps as train_steps
from sasvqa_torch.train.steps import create_train_state, make_scan_train_step

# H100 SXM dense peaks (NVIDIA data sheet; ``profile_step`` holds the bf16
# and memory rates) for the roofline bound; the dropout hash is scalar
# integer work, bounded here by the 67 TFLOP/s non-tensor f32 rate (the
# card's integer rate is not higher)
PEAK_BF16_FLOPS = ps.PEAK_BF16_FLOPS
PEAK_BYTES_PER_S = ps.PEAK_BYTES_PER_S
PEAK_SCALAR_OPS = 67e12
# integer operations of hash_keep per (row, col) pair: 5 multiplies,
# 3 adds, 3 xors, 3 shifts, 1 and, 1 compare
HASH_OPS_PER_PAIR = 16

# kernel vs plain: O is rounded to bf16 (a relative step of 2^-8) and P
# enters P.V in bf16, rounded against a running max in the kernel and
# the global max in the plain version; LSE is f32 throughout and differs
# only by summation order
TOL_O, TOL_LSE = 2e-2, 1e-3
# prompt_fill first-token logits, kernel route vs dense-bias route, both
# bf16: the two round P and O at different points in each of the 6
# layers and every residual adds its own bf16 rounding; allowed error
# 2^-4 of the logit scale
TOL_LOGITS_REL = 2.0 ** -4
# port on the GPU vs the port on the CPU, f32 with TF32 off
TOL_F32 = 1e-4
# K2 vs its plain version: dQ, dK, dV are rounded to bf16 (a relative step
# of 2^-8), dS is rounded to bf16 from f32 values that differ in their
# last bits (P from a different exp and summation order), and dQ sums its
# 128-key tiles by TMA reductions in run-dependent order; allowed error
# 2^-6 of each gradient's largest magnitude
TOL_GRAD_REL = 2.0 ** -6
# training forward/backward at GIT-base width, kernel route vs dense route,
# both bf16 with the same weights, batch and dropout draws: the routes
# round P, O and dS at different points in each of the 6 layers; the loss
# within 2^-6 relative, each parameter's gradient within 2^-4 of its norm
TOL_LOSS_REL = 2.0 ** -6
TOL_PARAM_GRAD_REL = 2.0 ** -4

SLICE = dict(batch_size=8, frames=8, stored_frames=16, img=224,
             max_txt_len=20, max_text_len=50, requests=16, seed=0)
# the bench's flagship train step (bench.py): B=16, 8 frames of 224x224,
# text length 32, S = 8*197 + 32 = 1608; the shipped msvd_qa_base optimizer
# groups (betas 0.9/0.98, weight decay 1e-3, grad_norm 5) with a learning
# rate that moves random weights within a few updates; the warm-up
# updates cover the step's eager warm-up micros and its graph's capture
TRAIN = dict(batch_size=16, frames=8, max_seq_len=32, k_micro=2,
             warmup_updates=2, timed_updates=3, seed=0,
             optim={"optim": "adamw", "learning_rate": 2e-4,
                    "betas": [0.9, 0.98], "weight_decay": 1e-3,
                    "grad_norm": 5.0, "decay": "constant"})
# the gradient check's batch: rows the dense route's f32 scores fit
GRAD_CHECK_ROWS = 2

# BLIP-base classifier at configs/msvd_qa_base3.json's head (1000 labels,
# mlp, cls_hidden_scale 2, dec-only, hidden dropout 0.1): 384x384 frames,
# patch 16, 577 tokens a frame
BLIP_CFG = {"model": {"pretrained_model": "Salesforce/blip-vqa-base",
                      "hidden_dropout_prob": 0.1},
            "num_labels": 1000, "classifier": "mlp", "cls_hidden_scale": 2}
# serving: the config's val_batch_size 16, nframe 4 of 16 stored frames
# (uniform strides by nframe: 16 / 4 = 4 frames), 64 frames a batch
BLIP = dict(batch_size=16, nframe=4, frames=4, stored_frames=16, img=384,
            max_txt_len=20, requests=32, seed=0)
# training: train_batch_size 8, gradient_accumulation_steps 4, adam with
# betas 0.9/0.999 and grad_norm 5 (the config), at a learning rate that
# moves random weights within 4 updates; one repeated batch
BLIP_TRAIN = dict(batch_size=8, k_micro=4, warmup_updates=1,
                  timed_updates=3, seed=0,
                  optim={"optim": "adam", "learning_rate": 2e-4,
                         "betas": [0.9, 0.999], "grad_norm": 5.0,
                         "decay": "constant"})
BLIP_GRAD_CHECK_ROWS = 4
# the BLIP gradient check compares two bf16 routes whose distance is
# bf16's noise (PERF.md): a change of where P, dS or a LayerNorm round
# draws a new sample of it, so the check runs at these seeds too (weights,
# batch and dropout draws), each under the same gate
BLIP_GRAD_EXTRA_SEEDS = (1, 2)
# K5/K6 vs their plain versions: TOL_O/TOL_LSE and TOL_GRAD_REL above.  K5
# rounds P to bf16 for P.V where the plain version keeps f32, O is bf16;
# K6 rounds P and dS to bf16 before the products (f32 in the plain
# version) and writes bf16 gradients


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def device_ms(fn, reps: int, kernel: str = "flash_fwd_sm90") -> float:
    """Mean device time per call of ``fn`` of the CUDA kernels whose name
    holds ``kernel``, from ``torch.profiler`` (``device_window``): the
    kernel's own time, which ``cuda_ms`` exceeds when the launcher's host
    time does."""
    _, names = device_window(fn, reps)
    return sum(ms for name, ms in names.items() if kernel in name)


def launches_made():
    """The kernel wrappers' own launch counts: ``launch_counts`` less what
    the replays of captured graphs added to it, which no wrapper saw."""
    return {name: n - _build.replayed_counts[name]
            for name, n in _build.launch_counts.items()}


# a device record of K1/K2/K3/K5/K6: (kernel, mask kind, dropout); the
# mask kind kGitMask (2) is the GIT kernels'
_PORT_KERNEL = re.compile(r"(flash_fwd|flash_bwd_fused|flash_bwd_dq|"
                          r"flash_bwd_dkv)_sm90_kernel<(\d+), (true|false)>")
ROWSUM = "rowsum_product"


def traced_launches(fn, tries=3):
    """The port's kernels the card ran in one call of ``fn``, counted from
    ``torch.profiler``'s device records by kernel name under the launch
    counters' names, with ``rowsum_product`` (a backward's prologue).
    Where ``fn`` replays a captured graph this is what ran, which the
    wrappers cannot count.  As in ``device_window``, the profiler's
    warm-up step runs ``fn`` once uncounted, and the recorded step runs
    small fills and a marker kernel before the counted call, whose
    records are those that start after the marker; a step whose marker
    was lost is taken again."""
    pad = torch.zeros(1, device="cuda")
    for _ in range(tries):
        sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA],
                schedule=sched) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(LEAD_FILLS):
                pad.zero_()
            torch.cuda._sleep(MARK_CYCLES)
            fn()
            torch.cuda.synchronize()
            prof.step()
        events = [e for e in prof.events() if e.self_device_time_total > 0]
        marks = [e for e in events if MARK in e.name]
        if marks:
            break
    else:
        raise RuntimeError(f"torch.profiler lost the marker in {tries} "
                           f"steps")
    t0 = max(m.time_range.end for m in marks)
    counts = dict.fromkeys(KERNELS + (ROWSUM,), 0)
    for e in events:
        if e.time_range.start < t0:
            continue
        if f"{ROWSUM}_kernel" in e.name:
            counts[ROWSUM] += 1
            continue
        # a LayerNorm backward is its row kernel and, when a parameter
        # needs its gradient, a column pass, which is not counted
        ln = next((k for k in LN_KERNELS if f"{k}_kernel<" in e.name), None)
        if ln is not None:
            counts[ln] += 1
            continue
        m = _PORT_KERNEL.search(e.name)
        if m is None:
            continue
        base, git = m.group(1), m.group(2) == "2"
        name = {"flash_fwd": "flash_fwd", "flash_bwd_fused": "flash_bwd",
                "flash_bwd_dq": "flash_bwd_dq",
                "flash_bwd_dkv": "flash_bwd_dkv"}[base]
        counts[f"git_{name}" if git else name] += 1
        counts[_build.HASH_DROPOUT] += m.group(3) == "true"
    return counts


def roofline(ops, nbytes, peak=PEAK_BF16_FLOPS):
    """(bound_ms, bound_by): the larger of ops at ``peak`` and bytes at
    the memory rate."""
    t_ops = ops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def rates(flop, bound_ms, ms):
    """Achieved TFLOP/s (the work the inputs need, over the kernel's
    time) and the share of the bound reached (bound_ms / kernel ms)."""
    return {"tflops": flop / ms / 1e9, "bound_share": bound_ms / ms}


def sdpa_yardstick(row, q, k, v, do, mask, reps):
    """Adds to a backward row SDPA's backward on the same inputs: the
    device time of its fwd+bwd window minus its fwd window (every kernel,
    no selection by name), the same by CUDA events, the kernels each
    window ran (which name the backend), and the row's device-time factor
    (kernel / SDPA backward)."""
    sd = sdpa_backward(q, k, v, do, mask, reps)
    row.update(library_ms=sd["device_ms"], library_events_ms=sd["events_ms"],
               library_kernels={"fwd_bwd": sd["fwd_bwd_kernels"],
                                "fwd": sd["fwd_kernels"]},
               library="SDPA: device time of fwd+bwd minus fwd",
               factor=row["device_ms"] / sd["device_ms"])


def sdpa_forward(q, k, v, mask, reps):
    """SDPA's forward on a forward row's inputs: the device time of every
    kernel it runs, the same by CUDA events, and its kernels."""
    def fn():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    dev, names = device_window(fn, reps)
    return {"library_ms": dev, "library_events_ms": cuda_ms(fn, reps),
            "library_kernels": names}


def k1_tiles(num_img, s):
    """K1's key tiles a (b, h) visits and those that run mask code
    (``fwd_tile_plan``)."""
    plan = gf.fwd_tile_plan(num_img, s)
    return {"visited": sum(len(t) for t in plan.values()),
            "masked": sum(m for t in plan.values() for _, m in t)}


def attended_pairs(num_img, text_mask, h):
    return int(git_mask_ok(num_img, text_mask).sum().item()) * h


def git_flash_bound(num_img, text_mask, h, dh):
    """(bound_ms, bound_by, attended pairs) for one forward call on these
    inputs: attended (row, col) pairs at 4*Dh FLOP each against q/k/v/O
    in bf16 + LSE in f32 + the int32 text mask, each moved once."""
    b, l = text_mask.shape
    s = num_img + l
    pairs = attended_pairs(num_img, text_mask, h)
    nbytes = 4 * b * h * s * dh * 2 + b * h * s * 4 + b * l * 4
    return (*roofline(4 * dh * pairs, nbytes), pairs)


def bwd_kernels():
    """The backward kernels the route (``FUSED_BWD``) launches at every
    length and rate: K2, or K3's two."""
    return (("git_flash_bwd",) if gf.FUSED_BWD
            else ("git_flash_bwd_dq", "git_flash_bwd_dkv"))


def k2_repeat(got, args):
    """K2 launched again on the same inputs: whether dK and dV are the same
    bits, and dQ's largest difference (its f32 sums arrive in
    run-dependent order), absolute and relative to dQ's largest
    magnitude."""
    again = gf._launch_bwd(*args)
    diff = (got[0].float() - again[0].float()).abs().max().item()
    return {"dkv_bit_identical": bool(torch.equal(got[1], again[1])
                                      and torch.equal(got[2], again[2])),
            "dq_rerun_max_abs_diff": diff,
            "dq_rerun_rel_diff": diff / max(
                got[0].float().abs().max().item(), 1e-6)}


def git_flash_bwd_bound(num_img, text_mask, h, dh):
    """(bound_ms, bound_by) of one backward call: attended pairs at
    10*Dh FLOP each (5 products) against q/k/v/O/dO read and dQ/dK/dV
    written once in bf16, LSE in f32 and the int32 text mask."""
    b, l = text_mask.shape
    s = num_img + l
    pairs = attended_pairs(num_img, text_mask, h)
    nbytes = 8 * b * h * s * dh * 2 + b * h * s * 4 + b * l * 4
    return roofline(10 * dh * pairs, nbytes)


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                   "cudnn": torch.backends.cudnn.allow_tf32}})
    return smi


_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def _kernel_name(mangled):
    """``name<template args>`` of a kernel from its mangled name."""
    for m in re.finditer(r"\d+", mangled):
        end = m.end() + int(m.group())
        name = mangled[m.end():end]
        if name.endswith("_kernel") and re.fullmatch(r"[A-Za-z_]\w*", name):
            rest = mangled[end:]
            args = (re.findall(r"L[ib](\d+)E", rest[:rest.find("EEv") + 1])
                    if rest.startswith("I") else [])
            return name + (f"<{','.join(args)}>" if args else "")
    return mangled


def ptxas_summary(log):
    """{kernel<template args>: {registers, spill_stores, spill_loads}}
    from nvcc's -Xptxas -v output for one library."""
    out, fn = {}, None
    for ln in log.splitlines():
        if "Function properties for " in ln:
            fn = _kernel_name(ln.split("Function properties for ")[1].strip())
            out[fn] = {}
        elif fn and _PTXAS_SPILL.search(ln):
            st, ld = _PTXAS_SPILL.search(ln).groups()
            out[fn].update(spill_stores=int(st), spill_loads=int(ld))
        elif fn and _PTXAS_REGS.search(ln):
            out[fn]["registers"] = int(_PTXAS_REGS.search(ln).group(1))
    return out


def phase_build():
    t0 = time.perf_counter()
    seconds = _build.build_all()
    notes = {name: sorted({ln.strip().split(")")[0].split("(")[-1]
                           for ln in log.splitlines() if "(C75" in ln})
             for name, log in _build.build_logs.items()}
    ptxas = {name: ptxas_summary(log)
             for name, log in _build.build_logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_s": seconds, "ptxas": ptxas, "ptxas_notes": notes})
    # K2's program holds its wgmma pipeline only without spills and
    # without a serialized-wgmma or injected-wait note (C7519, an injected
    # warpgroup.arrive, costs nothing)
    k2 = ptxas.get("git_flash_bwd", {})
    check(bool(k2) and all(f.get("spill_stores", 0) == 0
                           for f in k2.values())
          and not set(notes.get("git_flash_bwd", [])) - {"C7519"},
          f"git_flash_bwd spills or serializes its wgmma: {k2}, "
          f"{notes.get('git_flash_bwd')}")
    return ptxas


def _kernel_inputs(b, h, num_img, l, dh, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    s = num_img + l
    q, k, v = (torch.randn((b, h, s, dh), generator=gen, device="cuda"
                           ).to(torch.bfloat16) for _ in range(3))
    # right-padded prompts of random length, as the serving collator
    # makes them (every row keeps at least its [CLS])
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, l + 1, size=b)
    lens[0] = l
    mask = torch.from_numpy(
        (np.arange(l)[None, :] < lens[:, None]).astype(np.int32)).cuda()
    return q, k, v, mask


def phase_kernel(shapes):
    """git_flash_fwd vs its plain version at each (B, H, num_img, L, Dh)."""
    rows = []
    for (b, h, num_img, l, dh) in shapes:
        q, k, v, mask = _kernel_inputs(b, h, num_img, l, dh, seed=num_img)
        out, lse = git_flash_attention(q, k, v, mask, num_img)
        ref_o, ref_lse = git_flash_attention_reference(q, k, v, mask,
                                                       num_img)
        torch.cuda.synchronize()
        err_o = (out.float() - ref_o.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        check(bool(torch.isfinite(out.float()).all()
                   and torch.isfinite(lse).all()),
              "git_flash_fwd gave non-finite values")
        ok_mask = git_mask_ok(num_img, mask)[:, None]
        kernel_ms = cuda_ms(
            lambda: git_flash_attention(q, k, v, mask, num_img), reps=20)
        dev_ms = device_ms(
            lambda: git_flash_attention(q, k, v, mask, num_img), reps=20)
        plain_ms = cuda_ms(
            lambda: git_flash_attention_reference(q, k, v, mask, num_img),
            reps=5)
        library = sdpa_forward(q, k, v, ok_mask, reps=20)
        bound_ms, bound_by, pairs = git_flash_bound(num_img, mask, h, dh)
        row = {"phase": "kernel", "name": "git_flash_fwd",
               "shape": {"B": b, "H": h, "S": num_img + l,
                         "num_img": num_img, "L": l, "Dh": dh},
               "max_abs_err_o": err_o, "max_abs_err_lse": err_lse,
               "tol_o": TOL_O, "tol_lse": TOL_LSE, "kernel_ms": kernel_ms,
               "device_ms": dev_ms, "plain_ms": plain_ms, **library,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "attended_pairs": pairs,
               "tiles": k1_tiles(num_img, num_img + l),
               **rates(4 * dh * pairs, bound_ms, kernel_ms)}
        emit(row)
        check(err_o <= TOL_O and err_lse <= TOL_LSE,
              f"git_flash_fwd disagrees with its plain version: {row}")
        rows.append(row)
    return rows


def _rel_err(got, ref):
    """max |got - ref| and the largest |ref| it is measured against."""
    return ((got.float() - ref.float()).abs().max().item(),
            max(ref.float().abs().max().item(), 1e-6))


def phase_train_kernels(shapes, rate):
    """git_flash_fwd at ``rate`` and git_flash_bwd at 0 and ``rate`` vs
    their plain versions at each (B, H, num_img, L, Dh), with the plain
    dropout hash's time.  Returns one dict of rows per shape."""
    out_rows = []
    for (b, h, num_img, l, dh) in shapes:
        q, k, v, mask = _kernel_inputs(b, h, num_img, l, dh, seed=l)
        gen = torch.Generator(device="cuda").manual_seed(l + 1)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        seed = torch.tensor([-(2 ** 31) + 12345], dtype=torch.int32,
                            device="cuda")
        shape = {"B": b, "H": h, "S": num_img + l, "num_img": num_img,
                 "L": l, "Dh": dh}
        ok_mask = git_mask_ok(num_img, mask)[:, None]
        pairs = attended_pairs(num_img, mask, h)
        rows = {"shape": shape}

        # K1 with K4 inside
        o, lse = git_flash_attention(q, k, v, mask, num_img, rate, seed)
        ref_o, ref_lse = git_flash_attention_reference(q, k, v, mask,
                                                       num_img, rate, seed)
        torch.cuda.synchronize()
        err_o = (o.float() - ref_o.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        del ref_o, ref_lse
        check(bool(torch.isfinite(o.float()).all()),
              "git_flash_fwd with dropout gave non-finite values")
        fwd = {"phase": "kernel", "name": "git_flash_fwd", "rate": rate,
               "shape": shape, "max_abs_err_o": err_o,
               "max_abs_err_lse": err_lse, "tol_o": TOL_O,
               "tol_lse": TOL_LSE,
               "kernel_ms": cuda_ms(lambda: git_flash_attention(
                   q, k, v, mask, num_img, rate, seed), reps=10),
               "kernel_ms_rate0": cuda_ms(lambda: git_flash_attention(
                   q, k, v, mask, num_img), reps=10),
               "device_ms": device_ms(lambda: git_flash_attention(
                   q, k, v, mask, num_img, rate, seed), reps=10),
               "device_ms_rate0": device_ms(lambda: git_flash_attention(
                   q, k, v, mask, num_img), reps=10),
               "plain_ms": cuda_ms(lambda: git_flash_attention_reference(
                   q, k, v, mask, num_img, rate, seed), reps=2, warmup=1),
               **sdpa_forward(q, k, v, ok_mask, reps=10),
               "library": "SDPA, boolean mask, no dropout",
               "attended_pairs": pairs}
        fwd["bound_ms"], fwd["bound_by"], _ = git_flash_bound(num_img, mask,
                                                              h, dh)
        fwd.update(rates(4 * dh * pairs, fwd["bound_ms"], fwd["kernel_ms"]))
        fwd["rate0"] = rates(4 * dh * pairs, fwd["bound_ms"],
                             fwd["kernel_ms_rate0"])
        fwd["tiles"] = k1_tiles(num_img, num_img + l)
        emit(fwd)
        check(err_o <= TOL_O and err_lse <= TOL_LSE,
              f"git_flash_fwd with dropout disagrees with its plain "
              f"version: {fwd}")
        rows["fwd"] = fwd

        # K2, with K4 inside at rate > 0
        for r in (0.0, rate):
            o_r, lse_r = git_flash_attention(q, k, v, mask, num_img, r, seed)
            args = (q, k, v, o_r, lse_r, do, mask, num_img, r, seed)
            got = gf._launch_bwd(*args)
            repeat = k2_repeat(got, args)
            ref = git_flash_backward_reference(*args)
            torch.cuda.synchronize()
            errs = {n: _rel_err(g, rf) for n, g, rf in zip("qkv", got, ref)}
            del got, ref
            bwd = {"phase": "kernel", "name": "git_flash_bwd", "rate": r,
                   "shape": shape,
                   "max_abs_err": {f"d{n}": e for n, (e, _) in errs.items()},
                   "max_abs_ref": {f"d{n}": m for n, (_, m) in errs.items()},
                   "tol_rel": TOL_GRAD_REL,
                   "kernel_ms": cuda_ms(lambda: gf._launch_bwd(*args),
                                        reps=10),
                   "plain_ms": cuda_ms(
                       lambda: git_flash_backward_reference(*args), reps=2,
                       warmup=1),
                   "attended_pairs": pairs}
            # every kernel the launcher runs: the f32 dQ buffer's fill, the
            # backward (D inside), the cast of dQ
            bwd["device_ms"], bwd["device_kernels"] = device_window(
                lambda: gf._launch_bwd(*args), reps=10)
            bwd["bound_ms"], bwd["bound_by"] = git_flash_bwd_bound(
                num_img, mask, h, dh)
            bwd["bound_share_device"] = bwd["bound_ms"] / bwd["device_ms"]
            bwd.update(repeat)
            if r == 0.0:
                # at rate 0: SDPA's dropout draws a mask of its own
                sdpa_yardstick(bwd, q, k, v, do, ok_mask, reps=10)
            else:
                bwd["library_ms"] = None
            emit(bwd)
            check(all(e <= TOL_GRAD_REL * m for e, m in errs.values()),
                  f"git_flash_bwd disagrees with its plain version: {bwd}")
            check(repeat["dkv_bit_identical"],
                  f"K2's dK/dV differ between two launches: {bwd}")
            rows[f"bwd_{r}"] = bwd
        rows["hash_plain_ms"] = cuda_ms(
            lambda: hash_dropout_factor(b, h, num_img + l, seed, rate,
                                        device="cuda"), reps=2, warmup=1)
        rows["pairs"] = pairs
        out_rows.append(rows)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return out_rows


def _flash_inputs(b, h, lq, lk, kind, seed):
    """bf16 q (B, H, Lq, 64), k/v (B, H, Lk, 64), dO, and the bias: None,
    a key-padding row bias (B, 1, 1, Lk) of random valid lengths, or the
    GIT combined mask (B, 1, S, S) over S = Lq = Lk with 13 text tokens
    of random lengths."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn((b, h, lq, 64), generator=gen, device="cuda"
                         ).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((b, h, lk, 64), generator=gen, device="cuda"
                        ).to(torch.bfloat16) for _ in range(2))
    rng = np.random.default_rng(seed)
    bias = None
    if kind == "row":
        lens = rng.integers(lk // 2, lk + 1, size=b)
        keep = (np.arange(lk)[None, :] < lens[:, None]).astype(np.int32)
        bias = padding_bias(torch.from_numpy(keep).cuda())
    elif kind == "git_mask":
        _, _, _, mask = _kernel_inputs(b, 1, lq - 13, 13, 64, seed)
        bias = git_attention_bias(lq - 13, mask)
    return q, k, v, do, bias


def flash_bounds(b, h, lq, lk, dh, bias):
    """(bound_ms, bound_by) of the forward, the dQ launch, the dK/dV launch
    and the whole backward on these inputs: B*H*Lq*Lk pairs at 4, 6, 8 and
    10 times Dh FLOP (2*Dh a product: S+PV; S, dP, dQ; S, dP, dV, dK; the
    five of one fused pass) against each input read and each output
    written once (bf16 tensors, f32 LSE and D, the bias as stored)."""
    pairs = b * h * lq * lk
    xq, xk, row = b * h * lq * dh * 2, b * h * lk * dh * 2, b * h * lq * 4
    nb = 0 if bias is None else bias.numel() * bias.element_size()
    return {"fwd": roofline(4 * dh * pairs, 2 * xq + 2 * xk + row + nb),
            "dq": roofline(6 * dh * pairs, 4 * xq + 2 * xk + 2 * row + nb),
            "dkv": roofline(8 * dh * pairs, 2 * xq + 4 * xk + 2 * row + nb),
            "bwd": roofline(10 * dh * pairs,
                            4 * xq + 4 * xk + row + nb)}


def phase_flash_kernels(cases):
    """K5 (and K6 where asked) vs their plain versions for each case
    name -> (B, H, Lq, Lk, bias kind, with backward), with the kernel,
    plain-version and SDPA times and the bounds.  Returns name -> rows."""
    out = {}
    for name, (b, h, lq, lk, kind, with_bwd) in cases.items():
        q, k, v, do, bias = _flash_inputs(b, h, lq, lk, kind, seed=lq + lk)
        shape = {"B": b, "H": h, "Lq": lq, "Lk": lk, "Dh": 64, "bias": kind}
        bounds = flash_bounds(b, h, lq, lk, 64, bias)
        # SDPA takes an additive mask in the inputs' dtype
        lib_mask = None if bias is None else bias.to(q.dtype)
        o, lse = flash_forward(q, k, v, bias)
        ref_o, ref_lse = flash_attention_reference(q, k, v, bias)
        torch.cuda.synchronize()
        err_o = (o.float() - ref_o.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        del ref_o, ref_lse
        check(bool(torch.isfinite(o.float()).all()
                   and torch.isfinite(lse).all()),
              "flash_fwd gave non-finite values")
        fwd = {"phase": "kernel", "name": "flash_fwd", "case": name,
               "shape": shape, "max_abs_err_o": err_o,
               "max_abs_err_lse": err_lse, "tol_o": TOL_O,
               "tol_lse": TOL_LSE,
               "kernel_ms": cuda_ms(lambda: flash_forward(q, k, v, bias),
                                    reps=20),
               "device_ms": device_ms(lambda: flash_forward(q, k, v, bias),
                                      reps=20),
               "plain_ms": cuda_ms(lambda: flash_attention_reference(
                   q, k, v, bias), reps=3, warmup=1),
               **sdpa_forward(q, k, v, lib_mask, reps=20),
               "library": "SDPA",
               "bound_ms": bounds["fwd"][0], "bound_by": bounds["fwd"][1]}
        fwd.update(rates(4 * 64 * b * h * lq * lk, fwd["bound_ms"],
                         fwd["kernel_ms"]))
        emit(fwd)
        check(err_o <= TOL_O and err_lse <= TOL_LSE,
              f"flash_fwd disagrees with its plain version: {fwd}")
        rows = {"fwd": fwd}
        if with_bwd:
            dq, delta = _launch_dq(q, k, v, o, lse, do, bias)
            dk, dv = _launch_dkv(q, k, v, o, lse, do, bias, delta)
            ref = flash_backward_reference(q, k, v, o, lse, do, bias)
            torch.cuda.synchronize()
            errs = {n: _rel_err(g, r) for n, g, r in
                    zip(("dq", "dk", "dv"), (dq, dk, dv), ref)}
            del dq, dk, dv, ref
            bwd = {"phase": "kernel", "name": "flash_bwd", "case": name,
                   "shape": shape,
                   "max_abs_err": {n: e for n, (e, _) in errs.items()},
                   "max_abs_ref": {n: m for n, (_, m) in errs.items()},
                   "tol_rel": TOL_GRAD_REL,
                   "dq_ms": cuda_ms(lambda: _launch_dq(q, k, v, o, lse, do,
                                                       bias), reps=10),
                   "dkv_ms": cuda_ms(lambda: _launch_dkv(
                       q, k, v, o, lse, do, bias, delta), reps=10),
                   "plain_ms": cuda_ms(lambda: flash_backward_reference(
                       q, k, v, o, lse, do, bias), reps=2, warmup=1),
                   "bound_ms": {part: bounds[part][0]
                                for part in ("dq", "dkv", "bwd")},
                   "bound_by": {part: bounds[part][1]
                                for part in ("dq", "dkv", "bwd")}}
            bwd["kernel_ms"] = bwd["dq_ms"] + bwd["dkv_ms"]
            # device time: the dQ launch (D prologue + dQ program) and the
            # dK/dV launch
            bwd["dq_device_ms"], dq_names = device_window(
                lambda: _launch_dq(q, k, v, o, lse, do, bias), reps=10)
            bwd["dkv_device_ms"], dkv_names = device_window(
                lambda: _launch_dkv(q, k, v, o, lse, do, bias, delta),
                reps=10)
            bwd["device_ms"] = bwd["dq_device_ms"] + bwd["dkv_device_ms"]
            bwd["device_kernels"] = {**dq_names, **dkv_names}
            # SDPA takes an additive mask in the inputs' dtype
            sdpa_yardstick(bwd, q, k, v, do, lib_mask, reps=10)
            emit(bwd)
            check(all(e <= TOL_GRAD_REL * m for e, m in errs.values()),
                  f"flash_bwd disagrees with its plain version: {bwd}")
            rows["bwd"] = bwd
            del delta
        out[name] = rows
        del q, k, v, do, bias, o, lse
        torch.cuda.empty_cache()
    return out


def _git_base(seed, **overrides):
    cfg = dataclasses.replace(_git_config("microsoft/git-base-msrvtt-qa"),
                              **overrides)
    return GITForCausalLM(cfg, dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(seed))


def phase_grad_check(seed):
    """One training forward/backward at GIT-base width through the
    kernels vs the dense-bias route (plain attention, autograd), on the
    same weights, batch and hidden-dropout draws, attention dropout 0."""
    rng = np.random.default_rng(seed)
    b, t, l = GRAD_CHECK_ROWS, TRAIN["frames"], TRAIN["max_seq_len"]
    ids = torch.from_numpy(rng.integers(1000, 2000, (b, l))).long().cuda()
    mask = torch.ones_like(ids)
    mask[1:, 24:] = 0
    labels = torch.where(mask == 1, ids, torch.full_like(ids, -100))
    labels[:, :8] = -100                       # the question prefix
    px = torch.from_numpy(rng.standard_normal(
        (b, t, SLICE["img"], SLICE["img"], 3), dtype=np.float32)).cuda()
    res = {}
    for route in (None, False):
        model = _git_base(seed, attention_dropout=0.0).cuda().train()
        model.flash = route
        _build.reset_launch_counts()
        loss = model(ids, mask, px, labels=labels, deterministic=False,
                     generator=torch.Generator(device="cuda").manual_seed(
                         seed))["loss"]
        loss.backward()
        torch.cuda.synchronize()
        res[route] = dict(
            loss=loss.item(), launches=launches_made(),
            grads={n: p.grad.float() for n, p in model.named_parameters()},
            qkv=[lyr.attention.qkv.weight.grad.abs().sum().item()
                 for lyr in model.layers])
        del model, loss
    kern, dense = res[None], res[False]
    rel = {n: ((g - dense["grads"][n]).norm()
               / dense["grads"][n].norm().clamp(min=1e-20)).item()
           for n, g in kern["grads"].items()}
    worst = max(rel, key=rel.get)
    loss_rel = abs(kern["loss"] - dense["loss"]) / abs(dense["loss"])
    row = {"phase": "grad_check", "rows": b, "seq_len": t * 197 + l,
           "loss_kernel": kern["loss"], "loss_dense": dense["loss"],
           "loss_rel_err": loss_rel, "tol_loss_rel": TOL_LOSS_REL,
           "grad_rel_err_max": rel[worst], "grad_rel_err_worst": worst,
           "grad_rel_err_median": float(np.median(list(rel.values()))),
           "tol_grad_rel": TOL_PARAM_GRAD_REL,
           "launches_kernel_route": kern["launches"],
           "text_qkv_grad_abs_sum": kern["qkv"]}
    emit(row)
    n_layers = len(kern["qkv"])
    check(kern["launches"]["git_flash_fwd"] == n_layers
          and all(kern["launches"][k] == n_layers
                  for k in bwd_kernels()),
          f"kernel route did not launch K1 and the routed backward once a "
          f"layer: {row}")
    check(all(x > 0 for x in kern["qkv"]),
          "a text layer's qkv.weight got no gradient on the kernel route")
    check(loss_rel <= TOL_LOSS_REL and rel[worst] <= TOL_PARAM_GRAD_REL,
          f"kernel route gradients disagree with the dense route: {row}")
    del res
    torch.cuda.empty_cache()


def _train_batch(seed):
    """K stacked GITCollator(add_ans=True) micro-batches of B questions
    with answers over 16 stored frames (uniform, nframe=2: 8 frames)."""
    rng = np.random.default_rng(seed)
    collator = GITCollator(make_test_wordpiece(),
                           max_seq_len=TRAIN["max_seq_len"], nframe=2,
                           samp_policy="uniform", add_ans=True)
    questions = ["what is the man doing", "who is playing with the ball",
                 "what color is the dog", "where is the woman running"]
    answers = ["cooking", "man", "brown", "beach"]
    shape = (SLICE["stored_frames"], SLICE["img"], SLICE["img"], 3)
    micros = []
    for m in range(TRAIN["k_micro"]):
        items = [{"vid": rng.standard_normal(shape, dtype=np.float32),
                  "examples": [{"q_str": questions[i % 4],
                                "str_label": answers[i % 4], "label": None,
                                "question_id": m * 100 + i}],
                  "n_examples": 1} for i in range(TRAIN["batch_size"])]
        micros.append(collator(items, rng=rng))
    return next(stack_microbatches(iter(micros), TRAIN["k_micro"]))


def layer_norm_calls(model, loss_fn, batch):
    """LayerNorm calls of one training forward of micro 0 of a stacked
    ``batch``, counted by a forward pre-hook on every LayerNorm of the
    model (a replayed micro runs no Python, so its launches are held
    against this count)."""
    from sasvqa_torch.models.layers import LayerNorm
    calls = [0]
    hooks = [m.register_forward_pre_hook(
                 lambda *_: calls.__setitem__(0, calls[0] + 1))
             for m in model.modules() if isinstance(m, LayerNorm)]
    micro = {key: None if v is None else v[0] for key, v in batch.items()}
    dev = next(model.parameters()).device
    try:
        with torch.no_grad():
            loss_fn(model, micro, torch.Generator(device=dev), dev)
    finally:
        for h in hooks:
            h.remove()
    return calls[0]


def phase_train(seed):
    """make_scan_train_step at GIT-base width, the flagship shape, both
    dropouts on: warm-up, then timed updates on one repeated batch."""
    t0 = time.perf_counter()
    model = _git_base(seed)
    cfg = model.config
    batch = _train_batch(seed)
    k, b = TRAIN["k_micro"], TRAIN["batch_size"]
    check(batch["visual_inputs"].shape[:3] == (k, b, TRAIN["frames"]),
          f"train batch {batch['visual_inputs'].shape}")
    seq_len = TRAIN["frames"] * cfg.tokens_per_frame + TRAIN["max_seq_len"]
    state = create_train_state(model, TRAIN["optim"], total_steps=100,
                               device="cuda")
    step = make_scan_train_step(k, "git", device="cuda")
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms = [], []

    def update():
        nonlocal state
        state, m = step(state, batch, seed)
        losses.append(m["loss"].item())
        gnorms.append(m["grad_norm"].item())

    for _ in range(TRAIN["warmup_updates"]):
        update()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    train_steps.reset_micro_counts()
    t0 = time.perf_counter()
    for _ in range(TRAIN["timed_updates"]):
        update()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # the timed updates' counts, where each replay adds what its capture
    # recorded, and the card's own records of one more update
    inferred = dict(_build.launch_counts)
    micro_counts = dict(train_steps.micro_counts)
    launches = traced_launches(update)
    micros = k * TRAIN["timed_updates"]
    qkv = [lyr.attention.qkv.weight.grad.abs().sum().item()
           for lyr in model.layers]
    ln_calls = layer_norm_calls(model, train_steps._git_loss, batch)
    row = {"phase": "train", "model": "git-base (seeded random weights)",
           "dtype": "bfloat16 activations, f32 params", "batch_size": b,
           "k_micro": k, "frames": TRAIN["frames"], "seq_len": seq_len,
           "dropout": cfg.dropout, "attention_dropout": cfg.attention_dropout,
           "optim": TRAIN["optim"], "setup_s": setup_s,
           "updates_timed": TRAIN["timed_updates"], "wall_s": wall,
           "ms_per_update": wall / TRAIN["timed_updates"] * 1e3,
           "qa_pairs_per_s": micros * b / wall,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
           "loss": losses, "grad_norm": gnorms,
           "launches_traced_one_update": launches,
           "launches_inferred_timed": inferred, "micros_timed": micro_counts,
           "text_qkv_grad_abs_sum": qkv, "micro_steps": state.step,
           "layer_norm_calls_per_micro": ln_calls}
    emit(row)
    n = cfg.num_layers * k
    check(seq_len == 1608, f"train sequence {seq_len} != 1608")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"loss is not finite and falling: {losses}")
    bwd = bwd_kernels()
    check(launches["git_flash_fwd"] == n
          and all(launches[k] == n for k in bwd)
          and launches[ROWSUM] == n
          and launches["hash_dropout"] == (1 + len(bwd)) * n,
          f"train: the card ran {launches} in one update, expected {n} "
          f"of K1, of {bwd} and of {ROWSUM}")
    check(ln_calls > 0 and all(launches[name] == k * ln_calls
                               for name in LN_KERNELS),
          f"train: the card ran {launches} in one update, expected "
          f"{k} x {ln_calls} LayerNorm forwards and backwards")
    check(micro_counts == {"replayed": micros, "eager": 0}
          and all(inferred[name] == TRAIN["timed_updates"] * launches[name]
                  for name in KERNELS),
          f"train: the timed updates' micros {micro_counts} and inferred "
          f"launches {inferred} are not {TRAIN['timed_updates']} replayed "
          f"updates of the traced {launches}")
    check(all(x > 0 for x in qkv),
          "a text layer's qkv.weight got no gradient")
    del state, model, step
    torch.cuda.empty_cache()
    return row, launches


def _blip_base(seed):
    _, model = build_model(BLIP_CFG, dtype=torch.bfloat16, device="cuda",
                           generator=torch.Generator().manual_seed(seed))
    return model


BLIP_ANSWERS = {f"answer{i}": i for i in range(BLIP_CFG["num_labels"])}


def _blip_items(n, seed, labels=False, first_id=0):
    """n single-question groups over 16 stored 384x384 frames."""
    rng = np.random.default_rng(seed)
    questions = ["what is the man doing", "who is playing with the ball",
                 "what color is the dog", "where is the woman running",
                 "what is in the video"]
    shape = (BLIP["stored_frames"], BLIP["img"], BLIP["img"], 3)
    return [{"vid": rng.standard_normal(shape, dtype=np.float32),
             "examples": [{"q_str": questions[i % len(questions)],
                           "label": (int(rng.integers(0, 1000)) if labels
                                     else None),
                           "str_label": None,
                           "question_id": first_id + i}],
             "n_examples": 1} for i in range(n)]


def _vision_qkv_grads(model):
    return [lyr.self_attn.qkv.weight.grad.abs().sum().item()
            for lyr in model.vis_model.layers]


def phase_blip_serve(n_requests, seed):
    """QAEngine over the BLIP-base classifier, batch 16, 4 frames of
    384x384 a request (64 frames, 12 K5 launches a batch)."""
    t0 = time.perf_counter()
    model = _blip_base(seed)
    build_s = time.perf_counter() - t0
    engine = QAEngine(model, "blip", make_test_wordpiece(),
                      ans2label=BLIP_ANSWERS, nframe=BLIP["nframe"],
                      samp_policy="uniform", batch_size=BLIP["batch_size"],
                      max_txt_len=BLIP["max_txt_len"], device="cuda")
    items = _blip_items(n_requests, seed)
    reqs = [(it["vid"], it["examples"][0]["q_str"]) for it in items]
    n_layers = model.vision_config.num_layers
    try:
        engine.answer(*reqs[0], timeout=600)            # warm-up batch
        torch.cuda.synchronize()
        before = dict(engine.stats)
        results = [None] * n_requests

        def client(idx):
            for i in idx:
                results[i] = engine.submit(*reqs[i])

        n_clients = 4
        threads = [threading.Thread(target=client,
                                    args=(range(c, n_requests, n_clients),))
                   for c in range(n_clients)]
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        answers = [f.result(timeout=600) for f in results]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launches_made()
        batches = engine.stats["batches"] - before["batches"]
    finally:
        engine.close()
    check(len(answers) == n_requests
          and all(a["answer"] in BLIP_ANSWERS
                  and BLIP_ANSWERS[a["answer"]] == a["label"]
                  for a in answers),
          "engine did not answer every request from ans2label")
    check(launches["flash_fwd"] == n_layers * batches
          and launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == 0,
          f"flash_fwd launched {launches['flash_fwd']} times for {batches} "
          f"batches of {n_layers} vision layers: {launches}")

    direct = []
    bs = BLIP["batch_size"]
    with torch.inference_mode():
        for i in range(0, n_requests, bs):
            direct += engine._run_batch([(f, q, None)
                                         for f, q in reqs[i:i + bs]])
    check(direct == answers, "engine answers differ from _run_batch")

    # the eval forward through K5 vs through plain attention
    batch = engine._collator(items[:bs], rng=np.random.default_rng(0))
    ids = torch.from_numpy(batch["text_input_ids"]).long().cuda()
    mask = torch.from_numpy(batch["text_attention_mask"]).cuda()
    px = torch.from_numpy(batch["visual_inputs"]).cuda()
    check(tuple(px.shape) == (bs, BLIP["frames"], BLIP["img"], BLIP["img"],
                              3), f"serving pixels {tuple(px.shape)}")

    def forward(route):
        model.vis_model.flash = route
        with torch.inference_mode():
            return model(ids, mask, px)["logits"]

    logits_k, logits_p = forward(None), forward(False)
    torch.cuda.synchronize()
    err = (logits_k - logits_p).abs().max().item()
    scale = max(1.0, logits_p.abs().max().item())
    check(logits_k.shape == (bs, BLIP_CFG["num_labels"])
          and bool(torch.isfinite(logits_k).all()),
          "BLIP logits are not finite (16, 1000)")
    fwd_ms = cuda_ms(lambda: forward(None), reps=5)
    fwd_plain_ms = cuda_ms(lambda: forward(False), reps=5)
    model.vis_model.flash = None
    with torch.inference_mode():
        flat = px.to(torch.bfloat16).flatten(0, 1)
        vision_ms = cuda_ms(lambda: model.vis_model(flat), reps=5)
    row = {"phase": "blip_serve",
           "model": "blip-base classifier (seeded random weights)",
           "dtype": "bfloat16", "requests": n_requests, "batches": batches,
           "batch_size": bs, "frames_per_request": BLIP["frames"],
           "tokens_per_frame": model.vision_config.tokens_per_frame,
           "launches": launches, "build_model_s": build_s, "wall_s": wall,
           "requests_per_s": n_requests / wall,
           "ms_per_batch": wall / batches * 1e3,
           "forward_ms": fwd_ms, "forward_plain_route_ms": fwd_plain_ms,
           "vision_tower_ms": vision_ms,
           "logits_kernel_vs_plain_max_abs": err,
           "logits_tol": TOL_LOGITS_REL * scale,
           "answers_equal_run_batch": True,
           "sample_answer": answers[0]["answer"]}
    emit(row)
    check(err <= TOL_LOGITS_REL * scale,
          f"BLIP logits: kernel vs plain route {err} > "
          f"{TOL_LOGITS_REL * scale}")
    del model, engine
    torch.cuda.empty_cache()
    return row, launches


def _key_bias(name):
    return name.endswith(("key.bias", "k_proj.bias"))


def _blip_grads(seed, route, dtype, inputs):
    """Loss, launch counts, f32 gradients and the vision layers' qkv
    gradient sums of one training forward/backward of BLIP-base; the
    plain route (``route`` False) runs every LayerNorm on its plain
    formula too, so that it launches no kernel."""
    from sasvqa_torch.models.layers import LayerNorm
    _, model = build_model(BLIP_CFG, dtype=dtype, device="cuda",
                           generator=torch.Generator().manual_seed(seed))
    model.train()
    model.vis_model.flash = route
    _build.reset_launch_counts()
    with (mock.patch.object(LayerNorm, "forward", LayerNorm.plain)
          if route is False else contextlib.nullcontext()):
        loss = model(*inputs, deterministic=False,
                     generator=torch.Generator(device="cuda").manual_seed(
                         seed))["loss"]
        loss.backward()
    torch.cuda.synchronize()
    out = dict(loss=loss.item(), launches=launches_made(),
               grads={n: p.grad.float() for n, p in model.named_parameters()
                      if p.grad is not None},
               qkv=_vision_qkv_grads(model))
    del model, loss
    torch.cuda.empty_cache()
    return out


def phase_blip_grad_check(seed):
    """One training forward/backward of BLIP-base through K5/K6 and the
    LayerNorm kernels (bf16) vs the plain route (vision attention on plain
    autograd, LayerNorm's plain formula, bf16), on the same weights, batch
    and head-dropout draws, with the plain route in f32 as the oracle that
    says how far bf16 resolves each gradient."""
    rng = np.random.default_rng(seed)
    b, l = BLIP_GRAD_CHECK_ROWS, BLIP["max_txt_len"]
    ids = torch.from_numpy(rng.integers(1000, 2000, (b, l))).long().cuda()
    mask = torch.ones_like(ids)
    mask[1:, 12:] = 0
    labels = torch.from_numpy(rng.integers(0, 1000, (b,))).long().cuda()
    px = torch.from_numpy(rng.standard_normal(
        (b, BLIP["frames"], BLIP["img"], BLIP["img"], 3),
        dtype=np.float32)).cuda()
    inputs = (ids, mask, px, labels)
    kern = _blip_grads(seed, None, torch.bfloat16, inputs)
    plain = _blip_grads(seed, False, torch.bfloat16, inputs)
    oracle = _blip_grads(seed, False, torch.float32, inputs)
    check(set(kern["grads"]) == set(plain["grads"]) == set(oracle["grads"]),
          "the routes gave gradients to different parameters")

    def rel(g, ref):
        return ((g - ref).norm() / ref.norm().clamp(min=1e-20)).item()

    # a key projection's bias has a true gradient of 0 (softmax ignores a
    # constant added to every key): every route gives rounding noise
    # there, which has no relative error to hold; it is reported apart
    names = [n for n in kern["grads"] if not _key_bias(n)]
    kp = {n: rel(kern["grads"][n], plain["grads"][n]) for n in names}
    pf = {n: rel(plain["grads"][n], oracle["grads"][n]) for n in names}
    kf = {n: rel(kern["grads"][n], oracle["grads"][n]) for n in names}
    # the two bf16 routes lie up to a few times the tolerance apart on
    # the text stack's gradients even where both are right: bf16 misses
    # f32 there by about the tolerance itself (median 0.035-0.059 across
    # seeds), and by far more where it does not resolve a gradient at all
    # (cancellation in the deep random text stack).  So each gradient is
    # within the tolerance of the plain route, or within the tolerance of
    # f32, or no further from f32 than twice the plain route: a kernel
    # that computes a wrong gradient misses f32 by the gradient's size
    unresolved = [n for n in names if pf[n] > TOL_PARAM_GRAD_REL]
    failed = [n for n in names
              if kp[n] > TOL_PARAM_GRAD_REL
              and kf[n] > max(TOL_PARAM_GRAD_REL, 2 * pf[n])]
    apart = [n for n in names if kp[n] > TOL_PARAM_GRAD_REL]
    resolved = [n for n in names if n not in unresolved]
    worst = max(resolved, key=kp.get)
    vision = [n for n in names if n.startswith("vis_model.")]
    loss_rel = abs(kern["loss"] - plain["loss"]) / abs(plain["loss"])
    row = {"phase": "blip_grad_check", "seed": seed, "rows": b,
           "frames": b * BLIP["frames"],
           "loss_kernel": kern["loss"], "loss_plain": plain["loss"],
           "loss_f32": oracle["loss"],
           "loss_rel_err": loss_rel, "tol_loss_rel": TOL_LOSS_REL,
           "params_compared": len(names),
           "grad_rel_err_max_resolved": kp[worst],
           "grad_rel_err_worst_resolved": worst,
           "grad_rel_err_median": float(np.median(list(kp.values()))),
           "vision_grad_rel_err_max": max(kp[n] for n in vision),
           "vision_grad_rel_err_median": float(np.median(
               [kp[n] for n in vision])),
           # how far each bf16 route is from the f32 oracle
           "median_vs_f32": {
               route: {"all": float(np.median([d[n] for n in names])),
                       "vision": float(np.median([d[n] for n in vision]))}
               for route, d in (("kernel", kf), ("plain", pf))},
           "bf16_unresolved": {n: {"kernel_vs_plain": kp[n],
                                   "plain_vs_f32": pf[n],
                                   "kernel_vs_f32": kf[n]}
                               for n in unresolved},
           "failed": failed,
           # of the gradients the routes give more than the tolerance
           # apart: the largest kernel-vs-f32 over plain-vs-f32 (at most
           # 2 where both miss f32 by more than the tolerance)
           "apart": len(apart),
           "apart_kernel_over_plain_vs_f32_max": max(
               (kf[n] / pf[n] for n in apart if pf[n] > 0), default=0.0),
           "key_bias_grad_abs_max": max(
               kern["grads"][n].abs().max().item()
               for n in kern["grads"] if _key_bias(n)),
           "tol_grad_rel": TOL_PARAM_GRAD_REL,
           "launches_kernel_route": kern["launches"],
           "launches_plain_route": plain["launches"],
           "vision_qkv_grad_abs_sum": kern["qkv"]}
    emit(row)
    n_layers = len(kern["qkv"])
    check(all(kern["launches"][k] == n_layers
              for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
          and kern["launches"]["layer_norm_fwd"]
          == kern["launches"]["layer_norm_bwd"] > 0
          and not any(plain["launches"].values())
          and not any(oracle["launches"].values()),
          f"the kernel route did not launch K5/K6 once a layer and the "
          f"LayerNorm kernels, or a plain route launched a kernel: {row}")
    check(all(x > 0 for x in kern["qkv"]),
          "a vision layer's qkv.weight got no gradient on the kernel route")
    check(loss_rel <= TOL_LOSS_REL and not failed,
          f"BLIP kernel route gradients disagree with the plain route: "
          f"{row}")
    del kern, plain, oracle
    torch.cuda.empty_cache()


def _blip_train_batch(seed):
    """K stacked ClassifierCollator micro-batches of 8 labelled questions,
    4 of 16 stored frames each (uniform)."""
    collator = ClassifierCollator(make_test_wordpiece(),
                                  max_txt_len=BLIP["max_txt_len"],
                                  nframe=BLIP["nframe"],
                                  samp_policy="uniform")
    micros = [collator(_blip_items(BLIP_TRAIN["batch_size"], seed + m,
                                   labels=True, first_id=100 * m))
              for m in range(BLIP_TRAIN["k_micro"])]
    return next(stack_microbatches(iter(micros), BLIP_TRAIN["k_micro"]))


def phase_blip_train(seed):
    """make_scan_train_step(family="classifier") at BLIP-base width: 4
    micros of 8 questions over 4 frames, adam, head dropout 0.1: warm-up,
    then timed updates on one repeated batch."""
    t0 = time.perf_counter()
    model = _blip_base(seed)
    batch = _blip_train_batch(seed)
    k, b = BLIP_TRAIN["k_micro"], BLIP_TRAIN["batch_size"]
    check(batch["visual_inputs"].shape[:3] == (k, b, BLIP["frames"]),
          f"BLIP train batch {batch['visual_inputs'].shape}")
    state = create_train_state(model, BLIP_TRAIN["optim"], total_steps=100,
                               device="cuda")
    step = make_scan_train_step(k, "classifier", device="cuda")
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms, acc = [], [], []

    def update():
        nonlocal state
        state, m = step(state, batch, seed)
        losses.append(m["loss"].item())
        gnorms.append(m["grad_norm"].item())
        acc.append([int(m["acc_correct"]), int(m["acc_total"])])

    for _ in range(BLIP_TRAIN["warmup_updates"]):
        update()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    train_steps.reset_micro_counts()
    t0 = time.perf_counter()
    for _ in range(BLIP_TRAIN["timed_updates"]):
        update()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    inferred = dict(_build.launch_counts)
    micro_counts = dict(train_steps.micro_counts)
    launches = traced_launches(update)
    micros = k * BLIP_TRAIN["timed_updates"]
    qkv = _vision_qkv_grads(model)
    ln_calls = layer_norm_calls(model, train_steps._classifier_loss, batch)
    row = {"phase": "blip_train",
           "model": "blip-base classifier (seeded random weights)",
           "dtype": "bfloat16 activations, f32 params", "batch_size": b,
           "k_micro": k, "frames": BLIP["frames"],
           "frames_per_micro": b * BLIP["frames"],
           "hidden_dropout": model.head.hidden_dropout_prob,
           "optim": BLIP_TRAIN["optim"], "setup_s": setup_s,
           "updates_timed": BLIP_TRAIN["timed_updates"], "wall_s": wall,
           "ms_per_update": wall / BLIP_TRAIN["timed_updates"] * 1e3,
           "qa_pairs_per_s": micros * b / wall,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
           "loss": losses, "grad_norm": gnorms, "acc_correct_total": acc,
           "launches_traced_one_update": launches,
           "launches_inferred_timed": inferred, "micros_timed": micro_counts,
           "vision_qkv_grad_abs_sum": qkv, "micro_steps": state.step,
           "layer_norm_calls_per_micro": ln_calls}
    emit(row)
    n = model.vision_config.num_layers * k
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"BLIP loss is not finite and falling: {losses}")
    check(all(launches[name] == n for name in
              ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", ROWSUM)),
          f"BLIP train: the card ran {launches} in one update, expected "
          f"{n} of K5, of K6's two and of {ROWSUM}")
    check(ln_calls > 0 and all(launches[name] == k * ln_calls
                               for name in LN_KERNELS),
          f"BLIP train: the card ran {launches} in one update, expected "
          f"{k} x {ln_calls} LayerNorm forwards and backwards")
    check(micro_counts == {"replayed": micros, "eager": 0}
          and all(inferred[name] == BLIP_TRAIN["timed_updates"]
                  * launches[name] for name in KERNELS),
          f"BLIP train: the timed updates' micros {micro_counts} and "
          f"inferred launches {inferred} are not "
          f"{BLIP_TRAIN['timed_updates']} replayed updates of the traced "
          f"{launches}")
    check(all(x > 0 for x in qkv),
          "a vision layer's qkv.weight got no gradient")
    del state, model, step
    torch.cuda.empty_cache()
    return row, launches


def _requests(n, seed):
    rng = np.random.default_rng(seed)
    questions = ["what is the man doing", "who is playing with the ball",
                 "what color is the dog", "where is the woman running",
                 "what is in the video"]
    shape = (SLICE["stored_frames"], SLICE["img"], SLICE["img"], 3)
    return [(rng.standard_normal(shape, dtype=np.float32),
             questions[i % len(questions)]) for i in range(n)]


# LayerNorm rows (N, D) an activation at the cells' shapes: BLIP-large's
# vision stream of a micro (32 frames x 577 tokens x 1024) and GIT-base's
# (7,284 x 768); the kernels against the plain formula and the ATen chain
LN_CASES = {"blip_large": (32 * 577, 1024), "git_base": (7284, 768)}
LN_EPS = 1e-6
# inputs cycled so that each launch reads rows the L2 cache (50 MB) no
# longer holds, as a layer's LayerNorm reads rows a GEMM wrote long before
LN_COLD_BYTES = 256 << 20


def layer_norm_bytes(n, d, elem=2):
    """Bytes each pass moves once (HBM bound): forward x in, y out, the
    f32 mean and rstd out, w and b in; backward x, dy in, dx out, the
    statistics and w in, dw and db out."""
    return {"fwd": n * d * 2 * elem + n * 8 + d * 8,
            "bwd": n * d * 3 * elem + n * 8 + d * 12}


def phase_layer_norm(cases):
    """``ops/layer_norm`` at each (N, D) in bf16: the route against
    ``LayerNorm.plain`` (y and dx within 1 bf16 step, dw and db within
    2^-16 of each column's sum of |terms|; near 0, y and dx within 1e-6
    of their largest magnitude), two runs bit-identical, then
    each pass's kernel time (events, and device time of its kernels) on
    cold inputs beside its HBM bound, the plain formula's ATen chain and
    ``F.layer_norm`` (the yardstick, timed only)."""
    from sasvqa_torch.models.layers import LayerNorm
    from sasvqa_torch.ops import layer_norm as ln
    rows = {}
    for name, (n, d) in cases.items():
        gen = torch.Generator(device="cuda").manual_seed(n)
        m = LayerNorm(d, LN_EPS, torch.bfloat16).cuda()
        with torch.no_grad():
            m.weight.copy_(1 + 0.5 * torch.randn(d, device="cuda",
                                                 generator=gen))
            m.bias.copy_(0.5 * torch.randn(d, device="cuda", generator=gen))
        copies = max(1, -(-LN_COLD_BYTES // (n * d * 2)))
        xs = [(0.3 + torch.randn(n, d, device="cuda", generator=gen)
               ).to(torch.bfloat16) for _ in range(copies)]
        dys = [torch.randn(n, d, device="cuda", generator=gen
                           ).to(torch.bfloat16) for _ in range(copies)]

        def grads(route, x, dy):
            x = x.detach().requires_grad_(True)
            m.zero_grad(set_to_none=True)
            y = m(x) if route else m.plain(x)
            y.backward(dy)
            return y.detach(), x.grad, m.weight.grad, m.bias.grad

        before = launches_made()
        got = grads(True, xs[0], dys[0])
        again = grads(True, xs[0], dys[0])
        made = {k: v - before[k] for k, v in launches_made().items() if v
                - before[k]}
        want = grads(False, xs[0], dys[0])
        torch.cuda.synchronize()
        # y and dx within 1 bf16 step, or within 1e-6 of their largest
        # magnitude where a value is so small that the f32 orders' own
        # noise spans more than a step
        off = [((_bf16_ulps(a, b) > 1)
                & ((a.float() - b.float()).abs()
                   > 1e-6 * b.float().abs().max())).sum().item()
               for a, b in zip(got[:2], want[:2])]
        xf = xs[0].float()
        mean = xf.mean(-1, keepdim=True)
        xhat = (xf - mean) * torch.rsqrt(torch.clamp(
            (xf * xf).mean(-1, keepdim=True) - mean * mean, min=0) + LN_EPS)
        dyf = dys[0].float()
        param_err = max((((a - b).abs() / t.abs().sum(0)).max().item()
                         for a, b, t in ((got[2], want[2], dyf * xhat),
                                         (got[3], want[3], dyf))))
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))

        state = {"i": 0}

        def cycled(fn):
            def call():
                i = state["i"] = (state["i"] + 1) % copies
                return fn(i)
            return call

        saved = [ln.forward_kernel(x, m.weight, m.bias, LN_EPS, save=True)
                 for x in xs]
        fwd = cycled(lambda i: ln.forward_kernel(
            xs[i], m.weight, m.bias, LN_EPS, save=True))
        bwd = cycled(lambda i: ln.backward_kernel(
            saved[i][1], m.weight, saved[i][2], saved[i][3], dys[i], True))
        # the yardstick in the input's dtype throughout (bf16 parameters)
        wb, bb = (p.detach().bfloat16().requires_grad_(True)
                  for p in (m.weight, m.bias))
        plain_fwd = cycled(lambda i: m.plain(xs[i]))
        lib_fwd = cycled(lambda i: F.layer_norm(xs[i], (d,), wb, bb,
                                                LN_EPS))
        leaves = [x.detach().requires_grad_(True) for x in xs]
        plain_ys = [m.plain(x) for x in leaves]
        lib_ys = [F.layer_norm(x, (d,), wb, bb, LN_EPS) for x in leaves]
        plain_bwd = cycled(lambda i: torch.autograd.grad(
            plain_ys[i], (leaves[i], m.weight, m.bias), dys[i],
            retain_graph=True))
        lib_bwd = cycled(lambda i: torch.autograd.grad(
            lib_ys[i], (leaves[i], wb, bb), dys[i], retain_graph=True))
        nbytes = layer_norm_bytes(n, d)
        row = {"phase": "layer_norm", "case": name, "shape": [n, d],
               "dtype": "bfloat16", "cold_copies": copies,
               "launches": made, "repeat_bit_identical": repeat,
               "y_elements_off": off[0],
               "dx_elements_off": off[1],
               "param_err_rel_abs_terms": param_err}
        for part, kfn, pfn, lfn, needle in (
                ("fwd", fwd, plain_fwd, lib_fwd, "layer_norm_fwd_kernel"),
                ("bwd", bwd, plain_bwd, lib_bwd, "layer_norm_bwd")):
            bound_ms = nbytes[part] / PEAK_BYTES_PER_S * 1e3
            with torch.no_grad() if part == "fwd" else \
                    contextlib.nullcontext():
                k_ms = cuda_ms(kfn, reps=50)
                _, names = device_window(kfn, 20)
                names = {k: v for k, v in names.items() if needle in k}
                dev = sum(names.values())
                p_ms = cuda_ms(pfn, reps=10)
                l_ms = cuda_ms(lfn, reps=20)
            row[part] = {"kernel_ms": k_ms, "device_ms": dev,
                         "device_kernels": names,
                         "bytes": nbytes[part], "bound_ms": bound_ms,
                         "bound_by": "bytes", "bound_share": bound_ms / k_ms,
                         "bound_share_device": bound_ms / dev,
                         "plain_ms": p_ms, "library_ms": l_ms,
                         "library": "torch.nn.functional.layer_norm"}
        emit(row)
        check(made == {"layer_norm_fwd": 2, "layer_norm_bwd": 2},
              f"layer_norm: the route launched {made}")
        check(repeat and off == [0, 0]
              and param_err <= 2.0 ** -16,
              f"layer_norm disagrees with its plain version: {row}")
        rows[name] = row
        del xs, dys, saved, leaves, plain_ys, lib_ys
        torch.cuda.empty_cache()
    return rows


def _bf16_ulps(a, b):
    """Distance in bf16 steps between two bf16 tensors of any signs."""
    def ordered(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def phase_small_reference():
    """The port on the GPU against the port on the CPU, f32, tiny GIT:
    logits within TOL_F32 and identical greedy tokens."""
    cfg = _git_config("tiny")
    gpu = GITForCausalLM(cfg, generator=torch.Generator().manual_seed(1))
    cpu = GITForCausalLM(cfg, generator=torch.Generator().manual_seed(1))
    gpu = gpu.cuda().eval()
    cpu.eval()
    rng = np.random.default_rng(1)
    ids = rng.integers(5, cfg.vocab_size, size=(4, 8)).astype(np.int32)
    plen = np.array([8, 5, 2, 0], np.int32)
    px = rng.standard_normal((4, 2, 32, 32, 3), dtype=np.float32)
    with torch.inference_mode():
        lg, _ = gpu.prompt_fill(torch.from_numpy(ids).long().cuda(),
                                torch.from_numpy(plen).long().cuda(),
                                torch.from_numpy(px).cuda(), 12)
        lc, _ = cpu.prompt_fill(torch.from_numpy(ids).long(),
                                torch.from_numpy(plen).long(),
                                torch.from_numpy(px), 12)
    err = (lg.cpu() - lc).abs().max().item()
    tg = greedy_generate(gpu, ids, plen, px, max_text_len=12, device="cuda")
    tc = greedy_generate(cpu, ids, plen, px, max_text_len=12, device="cpu")
    same = bool(torch.equal(tg.cpu(), tc))
    # tiny BLIP classifier, two questions a video: logits and loss
    cfg = {"model": {"pretrained_model": "tiny-blip"}, "img_size": 32,
           "num_labels": 7, "classifier": "mlp"}
    outs = []
    for dev in ("cuda", "cpu"):
        _, blip = build_model(cfg, device=dev,
                              generator=torch.Generator().manual_seed(1))
        with torch.inference_mode():
            outs.append(blip(
                torch.from_numpy(ids).long().to(dev),
                (torch.arange(8)[None, :] < torch.from_numpy(plen)[:, None]
                 .clamp(min=1)).to(dev),
                torch.from_numpy(px[:2]).to(dev),
                labels=torch.tensor([0, 3, 6, 1], device=dev)))
    err_blip = max((outs[0][key].cpu() - outs[1][key]).abs().max().item()
                   for key in ("logits", "loss"))
    emit({"phase": "small_reference", "max_abs_err_logits": err,
          "tol": TOL_F32, "greedy_tokens_equal": same,
          "blip_max_abs_err_logits_loss": err_blip})
    check(err <= TOL_F32 and same and err_blip <= TOL_F32,
          "GPU port disagrees with the CPU port")


def phase_slice(n_requests, seed):
    """QAEngine at GIT-base width, 8 frames a request."""
    t0 = time.perf_counter()
    family, model = build_model(
        {"model": {"pretrained_model": "microsoft/git-base-msrvtt-qa"}},
        dtype=torch.bfloat16, device="cuda",
        generator=torch.Generator().manual_seed(seed))
    build_s = time.perf_counter() - t0
    cfg = model.config
    tok = make_test_wordpiece()
    # the uniform policy strides by nframe: nframe=2 over 16 stored
    # frames keeps 8 of them, the 8-frame serving shape
    engine = QAEngine(model, family, tok, nframe=2, samp_policy="uniform",
                      batch_size=SLICE["batch_size"],
                      max_txt_len=SLICE["max_txt_len"],
                      max_text_len=SLICE["max_text_len"], device="cuda")
    try:
        reqs = _requests(n_requests, seed)
        engine.answer(*reqs[0], timeout=600)            # warm-up batch
        torch.cuda.synchronize()
        before = dict(engine.stats)
        results = [None] * n_requests

        def client(idx):
            for i in idx:
                results[i] = engine.submit(*reqs[i])

        n_clients = 4
        threads = [threading.Thread(target=client,
                                    args=(range(c, n_requests, n_clients),))
                   for c in range(n_clients)]
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        answers = [f.result(timeout=600) for f in results]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launches_made()
        batches = engine.stats["batches"] - before["batches"]
    finally:
        engine.close()

    check(len(answers) == n_requests
          and all(isinstance(a["answer"], str) for a in answers),
          "engine did not answer every request")
    check(launches["git_flash_fwd"] == cfg.num_layers * batches,
          f"git_flash_fwd launched {launches['git_flash_fwd']} times for "
          f"{batches} batches of {cfg.num_layers} layers")

    # the same requests straight through _run_batch give the same answers
    direct = []
    with torch.inference_mode():
        for i in range(0, n_requests, SLICE["batch_size"]):
            chunk = [(f, q, None) for f, q in reqs[i:i + SLICE["batch_size"]]]
            direct += engine._run_batch(chunk)
    check(direct == answers, "engine answers differ from _run_batch")

    # prompt_fill through the kernel vs through the dense-bias path
    batch = engine._collator(
        [{"vid": f, "examples": [{"q_str": q, "label": None,
                                  "str_label": None, "question_id": i}],
          "n_examples": 1} for i, (f, q) in enumerate(reqs[:8])],
        rng=np.random.default_rng(0))
    ids = torch.from_numpy(batch["text_input_ids"]).long().cuda()
    plen = torch.from_numpy(batch["prompt_len"]).long().cuda()
    px = torch.from_numpy(batch["visual_inputs"]).cuda()
    check(px.shape[1] * cfg.tokens_per_frame + ids.shape[1] >= 512,
          "serving batch is too short for the git-flash route")

    def fill(route):
        model.flash = route
        with torch.inference_mode():
            return model.prompt_fill(ids, plen, px, SLICE["max_text_len"])

    with torch.inference_mode():
        logits_k, cache = fill(None)
        logits_d, _ = fill(False)
        torch.cuda.synchronize()
        err = (logits_k - logits_d).abs().max().item()
        scale = max(1.0, logits_d.abs().max().item())
        check(logits_k.shape == (8, cfg.vocab_size)
              and bool(torch.isfinite(logits_k).all()),
              "prompt_fill logits are not finite (8, vocab)")
        fill_ms = cuda_ms(lambda: fill(None), reps=5)
        fill_dense_ms = cuda_ms(lambda: fill(False), reps=5)
        model.flash = None
        tok0 = logits_k.argmax(-1)
        step_ms = cuda_ms(lambda: model.decode_step(tok0, cache), reps=10,
                          warmup=1)
        generated = greedy_generate(model, ids, plen, px,
                                    max_text_len=SLICE["max_text_len"],
                                    device="cuda")
    check(generated.shape == (8, SLICE["max_text_len"] - 1)
          and int(generated.min()) >= 0
          and int(generated.max()) < cfg.vocab_size,
          "generated ids out of range")
    row = {"phase": "slice", "model": "git-base (seeded random weights)",
           "dtype": "bfloat16", "requests": n_requests, "batches": batches,
           "frames_per_request": int(px.shape[1]),
           "seq_len": int(px.shape[1] * cfg.tokens_per_frame
                          + ids.shape[1]),
           "launches": launches, "build_model_s": build_s,
           "wall_s": wall, "requests_per_s": n_requests / wall,
           "ms_per_batch": wall / batches * 1e3,
           "prompt_fill_ms": fill_ms, "prompt_fill_dense_ms": fill_dense_ms,
           "decode_step_ms": step_ms,
           "logits_kernel_vs_dense_max_abs": err,
           "logits_tol": TOL_LOGITS_REL * scale,
           "answers_equal_run_batch": True,
           "sample_answer": answers[0]["answer"]}
    emit(row)
    check(err <= TOL_LOGITS_REL * scale,
          f"prompt_fill logits: kernel vs dense {err} > "
          f"{TOL_LOGITS_REL * scale}")
    return row, launches


# ---- slice 4: K3, the ViT-L/14 16-frame GIT and the task loop --------------

# K3 vs K2 over S: (B, H, num_img, L, rows held against the plain version).
# The plain backward materialises several (B, H, S, S) f32 tensors, so the
# longest lengths compare 2 rows of the batch (their hash coordinates are
# the full batch's: b*H + h)
SPLIT_SHAPES = {"ragged_3f": (2, 12, 3 * 197, 13, 2),
                "flagship": (16, 12, 8 * 197, 32, 16),
                "git_base_16f": (8, 12, 16 * 197, 32, 2),
                "vitl16": (8, 12, 16 * 257, 32, 2)}
# the main paths' shapes (GIT-base training, the vitl16 task loop): only
# these take the profiler window of K1
SPLIT_MAIN = ("flagship", "vitl16")
# GIT with ViT-L/14 (git-large presets: 24 x 1024 vision, 6 x 768 text,
# vocab 30522), 16 frames of 224x224, text length 32: S = 16*257 + 32
VITL16_CFG = {"model": {"pretrained_model": "microsoft/git-large-msrvtt-qa",
                        "hidden_dropout_prob": 0.1,
                        "attention_probs_dropout_prob": 0.1},
              "remat": True}
VITL16 = dict(frames=16, img=224, text_len=32, grad_check_rows=2, seed=0)
# the task loop: configs/msvd_qa_base.json (nframe 1 uniform over 16
# stored frames, one question a group) at the vitl16 shape: 32 videos of 2
# questions, train_batch_size 8 and 2 accumulated micros (4 updates in
# one epoch), 16 val and 16 test questions at val_batch_size 8
TASK = dict(videos=32, questions=2, stored_frames=16, img=224, val=16,
            test=16, overrides={
                "model": VITL16_CFG["model"], "remat": True, "nframe": 1,
                "samp_policy": "uniform", "max_seq_len": 32,
                "max_txt_len": 20, "max_n_example_per_group": 1,
                "train_batch_size": 8, "gradient_accumulation_steps": 2,
                "val_batch_size": 8, "num_train_epochs": 1, "num_valid": 2,
                "min_valid_steps": 1, "learning_rate": 2e-4,
                "gen_max_new_tokens": 10, "seed": 0})


def git_flash_bwd_part_bounds(num_img, text_mask, h, dh):
    """(bound_ms, bound_by) of K3's dQ launch (S, dP, dQ: 6*Dh FLOP an
    attended pair) and dK/dV launch (S, dV, dP, dK: 8*Dh), each input read
    and each output written once (bf16 tensors, f32 LSE and D, the int32
    text mask), as flash_bounds counts K6's."""
    b, l = text_mask.shape
    s = num_img + l
    pairs = attended_pairs(num_img, text_mask, h)
    x, row, tm = b * h * s * dh * 2, b * h * s * 4, b * l * 4
    return {"dq": roofline(6 * dh * pairs, 6 * x + 2 * row + tm),
            "dkv": roofline(8 * dh * pairs, 6 * x + 2 * row + tm)}


def phase_split_kernels(rate):
    """K3 (git_flash_bwd_dq + git_flash_bwd_dkv) vs its plain version and
    vs K2, and K1 and K2 vs their own (fused) plain versions, at each
    SPLIT_SHAPES entry and rates 0 and ``rate``, with K3's gradients and K2's dK/dV
    bit-identical across two launches; K3, K2, plain and SDPA times and
    the bounds, and K1's device time at the SPLIT_MAIN shapes.
    Returns the rows and the crossover in S per rate, a measurement
    reported beside the route ``FUSED_BWD``."""
    rows = []
    for name, (b, h, num_img, l, rows_plain) in SPLIT_SHAPES.items():
        q, k, v, mask = _kernel_inputs(b, h, num_img, l, 64, seed=l + b)
        gen = torch.Generator(device="cuda").manual_seed(b)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        seed = torch.tensor([2 ** 31 - 99], dtype=torch.int32, device="cuda")
        shape = {"B": b, "H": h, "S": num_img + l, "num_img": num_img,
                 "L": l, "Dh": 64}
        pairs = attended_pairs(num_img, mask, h)
        bound = git_flash_bwd_bound(num_img, mask, h, 64)
        parts = git_flash_bwd_part_bounds(num_img, mask, h, 64)
        ok_mask = git_mask_ok(num_img, mask)[:, None]
        for r in (0.0, rate):
            o, lse = git_flash_attention(q, k, v, mask, num_img, r, seed)
            args = (q, k, v, o, lse, do, mask, num_img, r, seed)
            dq, delta = gf._launch_bwd_dq(*args)
            dk, dv = gf._launch_bwd_dkv(q, k, v, lse, do, mask, num_img,
                                        delta, r, seed)
            dq_again, _ = gf._launch_bwd_dq(*args)
            dk_again, dv_again = gf._launch_bwd_dkv(
                q, k, v, lse, do, mask, num_img, delta, r, seed)
            fused = gf._launch_bwd(*args)
            k2_rep = k2_repeat(fused, args)
            sub = [x[:rows_plain] for x in (q, k, v, o, lse, do, mask)]
            ref_o, ref_lse = git_flash_attention_reference(
                *sub[:3], sub[6], num_img, r, seed)
            k1_err = ((sub[3].float() - ref_o.float()).abs().max().item(),
                      (sub[4] - ref_lse).abs().max().item())
            del ref_o, ref_lse
            ref = gf.git_flash_backward_split_reference(*sub, num_img, r,
                                                        seed)
            ref_fused = gf.git_flash_backward_reference(*sub, num_img, r,
                                                        seed)
            torch.cuda.synchronize()
            got = (dq, dk, dv)
            vs_plain = {f"d{n}": _rel_err(g[:rows_plain], rf)
                        for n, g, rf in zip("qkv", got, ref)}
            k2_vs_plain = {f"d{n}": _rel_err(g[:rows_plain], rf)
                           for n, g, rf in zip("qkv", fused, ref_fused)}
            vs_k2 = {f"d{n}": _rel_err(g, f)
                     for n, g, f in zip("qkv", got, fused)}
            bit_equal = bool(torch.equal(dq, dq_again))
            dkv_bit_equal = bool(torch.equal(dk, dk_again)
                                 and torch.equal(dv, dv_again))
            del ref, ref_fused, fused, dq_again, dk_again, dv_again, got
            row = {"phase": "split_kernels", "case": name, "rate": r,
                   "shape": shape, "attended_pairs": pairs,
                   "plain_rows": rows_plain,
                   "k1_max_abs_err_o_vs_plain": k1_err[0],
                   "k1_max_abs_err_lse_vs_plain": k1_err[1],
                   "max_abs_err_vs_plain": {n: e for n, (e, _) in
                                            vs_plain.items()},
                   "max_abs_ref_plain": {n: m for n, (_, m) in
                                         vs_plain.items()},
                   "max_abs_err_vs_k2": {n: e for n, (e, _) in
                                         vs_k2.items()},
                   "k2_max_abs_err_vs_plain": {n: e for n, (e, _) in
                                               k2_vs_plain.items()},
                   "k2_max_abs_ref_plain": {n: m for n, (_, m) in
                                            k2_vs_plain.items()},
                   "tol_rel": TOL_GRAD_REL, "dq_bit_identical": bit_equal,
                   "dkv_bit_identical": dkv_bit_equal,
                   "dq_ms": cuda_ms(lambda: gf._launch_bwd_dq(*args),
                                    reps=10),
                   "dkv_ms": cuda_ms(lambda: gf._launch_bwd_dkv(
                       q, k, v, lse, do, mask, num_img, delta, r, seed),
                       reps=10),
                   "k2_ms": cuda_ms(lambda: gf._launch_bwd(*args), reps=10),
                   "plain_ms": cuda_ms(
                       lambda: gf.git_flash_backward_split_reference(
                           *sub, num_img, r, seed), reps=1, warmup=1),
                   "bound_ms": bound[0], "bound_by": bound[1],
                   "bound_ms_14dh": roofline(14 * 64 * pairs, 1)[0],
                   "part_bound_ms": {p: parts[p][0] for p in parts},
                   "part_bound_by": {p: parts[p][1] for p in parts}}
            row["kernel_ms"] = row["dq_ms"] + row["dkv_ms"]
            # device time of every kernel each launcher runs (K3's dQ
            # launch holds the D prologue; K2's the dQ fill and cast)
            row["dq_device_ms"], dq_names = device_window(
                lambda: gf._launch_bwd_dq(*args), reps=5)
            row["dkv_device_ms"], dkv_names = device_window(
                lambda: gf._launch_bwd_dkv(q, k, v, lse, do, mask, num_img,
                                           delta, r, seed), reps=5)
            row["device_ms"] = row["dq_device_ms"] + row["dkv_device_ms"]
            row["device_kernels"] = {**dq_names, **dkv_names}
            row["k2_device_ms"], _ = device_window(
                lambda: gf._launch_bwd(*args), reps=5)
            row["k2_bound_share_device"] = bound[0] / row["k2_device_ms"]
            row["k2"] = k2_rep
            if name in SPLIT_MAIN:
                # K1 at this rate, for the dropout hash's cost (K4)
                row["fwd_device_ms"], _ = device_window(
                    lambda: git_flash_attention(q, k, v, mask, num_img, r,
                                                seed), reps=5)
            row["ms_per_1e9_pairs"] = {
                "k3": row["kernel_ms"] / pairs * 1e9,
                "k2": row["k2_ms"] / pairs * 1e9}
            if r == 0.0:
                sdpa_yardstick(row, q, k, v, do, ok_mask, reps=5)
                row["k2_factor"] = row["k2_device_ms"] / row["library_ms"]
            else:
                row["library_ms"] = None
            emit(row)
            check(k1_err[0] <= TOL_O and k1_err[1] <= TOL_LSE,
                  f"K1 disagrees with its plain version: {row}")
            check(bit_equal and dkv_bit_equal,
                  f"K3's gradients differ between two launches: {row}")
            check(k2_rep["dkv_bit_identical"],
                  f"K2's dK/dV differ between two launches: {row}")
            check(all(e <= TOL_GRAD_REL * m for e, m in k2_vs_plain.values()),
                  f"K2 disagrees with its plain version: {row}")
            check(all(e <= TOL_GRAD_REL * m for e, m in vs_plain.values())
                  and all(e <= TOL_GRAD_REL * vs_plain[n][1]
                          for n, (e, _) in vs_k2.items()),
                  f"K3 disagrees with its plain version or with K2: {row}")
            rows.append(row)
            del o, lse, dq, dk, dv, delta
        del q, k, v, do, mask, ok_mask
        torch.cuda.empty_cache()
    def crossover(key, k2_key):
        """per rate, the shortest measured S from which K3 (``key``) takes
        less time than K2 (``k2_key``) at every longer one"""
        out = {}
        for r in (0.0, rate):
            wins = sorted((row["shape"]["S"], row[key] < row[k2_key])
                          for row in rows if row["rate"] == r)
            out[str(r)] = next((s_len for s_len, _ in wins
                                if all(w for s2, w in wins if s2 >= s_len)),
                               None)
        return out

    # device time decides: the launchers' host time runs ahead of the card
    # on an asynchronous backward.  A measurement, not a gate: the route
    # (FUSED_BWD) holds no length crossover, and "route_agrees" says
    # whether this run's timings still put K2 ahead at every length
    cross = crossover("device_ms", "k2_device_ms")
    emit({"phase": "split_crossover", "measured_min_seq": cross,
          "measured_min_seq_events": crossover("kernel_ms", "k2_ms"),
          "route": "K2" if gf.FUSED_BWD else "K3",
          "route_agrees": all(c is None for c in cross.values())
          if gf.FUSED_BWD else None})
    return rows, cross


def _vitl16_grads(route, remat, inputs, seed):
    """Loss, launch counts and f32 gradients of one training forward/
    backward of GIT with ViT-L/14, backward route ``route``: "k2" or "k3"
    forced, or "routed" (``FUSED_BWD`` as it stands)."""
    cfg = dict(VITL16_CFG, remat=remat)
    _, model = build_model(cfg, dtype=torch.bfloat16, device="cuda",
                           generator=torch.Generator().manual_seed(seed))
    model.train()
    saved = gf.FUSED_BWD
    if route != "routed":
        gf.FUSED_BWD = route == "k2"
    try:
        _build.reset_launch_counts()
        loss = model(*inputs, deterministic=False,
                     generator=torch.Generator(device="cuda").manual_seed(
                         seed))["loss"]
        loss.backward()
        torch.cuda.synchronize()
    finally:
        gf.FUSED_BWD = saved
    out = dict(loss=loss.item(), launches=launches_made(),
               grads={n: p.grad.float() for n, p in model.named_parameters()},
               qkv=[lyr.attention.qkv.weight.grad.abs().sum().item()
                    for lyr in model.layers])
    del model, loss
    torch.cuda.empty_cache()
    return out


def phase_vitl16_grad_check():
    """GIT with ViT-L/14 at full width, 16 frames, S = 4144, remat on,
    dropout 0.1/0.1 with equal draws: the backward through K3 vs through
    K2, and remat on vs off on the routed backward, loss and every
    parameter's gradient."""
    seed = VITL16["seed"]
    rng = np.random.default_rng(seed)
    b, t, l = VITL16["grad_check_rows"], VITL16["frames"], VITL16["text_len"]
    ids = torch.from_numpy(rng.integers(1000, 2000, (b, l))).long().cuda()
    mask = torch.ones_like(ids)
    mask[1:, 21:] = 0
    labels = torch.where(mask == 1, ids, torch.full_like(ids, -100))
    labels[:, :8] = -100
    px = torch.from_numpy(rng.standard_normal(
        (b, t, VITL16["img"], VITL16["img"], 3), dtype=np.float32)).cuda()
    inputs = (ids, mask, px, labels)
    s_len = t * 257 + l
    routed = "k2" if gf.FUSED_BWD else "k3"
    launches = {name: 0 for name in _build.COUNTERS}
    runs = {}
    for key in (("k3", True), ("k2", True), ("routed", False)):
        runs[key] = _vitl16_grads(*key, inputs, seed)
        for name, n in runs[key]["launches"].items():
            launches[name] += n

    def compare(a, ref):
        rel = {n: ((g - ref["grads"][n]).norm()
                   / ref["grads"][n].norm().clamp(min=1e-20)).item()
               for n, g in a["grads"].items()}
        worst = max(rel, key=rel.get)
        return {"loss_rel_err": abs(a["loss"] - ref["loss"])
                / abs(ref["loss"]),
                "grad_rel_err_max": rel[worst], "grad_rel_err_worst": worst,
                "grad_rel_err_median": float(np.median(list(rel.values())))}

    k3, k2 = runs["k3", True], runs["k2", True]
    remat, plain = runs[routed, True], runs["routed", False]
    row = {"phase": "vitl16_grad_check", "rows": b, "frames": t,
           "seq_len": s_len, "remat": True, "routed": routed,
           "dropout": VITL16_CFG["model"]["hidden_dropout_prob"],
           "attention_dropout":
               VITL16_CFG["model"]["attention_probs_dropout_prob"],
           "loss_k3": k3["loss"], "loss_k2": k2["loss"],
           "loss_routed_no_remat": plain["loss"],
           "k3_vs_k2": compare(k3, k2), "remat_vs_no_remat": compare(
               remat, plain),
           "tol_loss_rel": TOL_LOSS_REL, "tol_grad_rel": TOL_PARAM_GRAD_REL,
           "launches_k3_route": k3["launches"],
           "launches_k2_route": k2["launches"],
           "launches_routed_no_remat": plain["launches"],
           "text_qkv_grad_abs_sum_k3": k3["qkv"],
           "text_qkv_grad_abs_sum_k2": k2["qkv"]}
    emit(row)
    n_layers = len(k3["qkv"])
    route_bwd = bwd_kernels()
    check(all(k3["launches"][n] == n_layers for n in
              ("git_flash_fwd", "git_flash_bwd_dq", "git_flash_bwd_dkv"))
          and k3["launches"]["git_flash_bwd"] == 0
          and k2["launches"]["git_flash_bwd"] == n_layers
          and k2["launches"]["git_flash_bwd_dq"] == 0
          and all(plain["launches"][n] == n_layers for n in route_bwd)
          and all(plain["launches"][n] == 0 for n in
                  ("git_flash_bwd", "git_flash_bwd_dq", "git_flash_bwd_dkv")
                  if n not in route_bwd),
          f"the routes did not launch K3 / K2 / {route_bwd} once a layer: "
          f"{row}")
    check(all(x > 0 for x in k3["qkv"] + k2["qkv"]),
          "a text layer's qkv.weight got no gradient through K3 or K2")
    for what in ("k3_vs_k2", "remat_vs_no_remat"):
        check(row[what]["loss_rel_err"] <= TOL_LOSS_REL
              and row[what]["grad_rel_err_max"] <= TOL_PARAM_GRAD_REL,
              f"vitl16 {what} gradients disagree: {row}")
    del runs
    torch.cuda.empty_cache()
    return row, launches


class MemoryFrameStore:
    """Seeded frames held in host memory, with FrameStoreReader's methods
    (the card's installation has no h5py): (N, K, H, W, 3) float32."""

    def __init__(self, frames: np.ndarray):
        self.frames = frames
        n, k, hw, _, c = frames.shape
        self.shape = (n, k, c * hw * hw)

    def read_frames_nhwc(self, row, frame_inds):
        return self.frames[row][np.asarray(frame_inds).reshape(-1)]


TASK_WORDS = ["what", "who", "how", "where", "when"]
TASK_SUBJECTS = ["man", "woman", "dog", "cat"]


def _task_files(root, task=None):
    """msvd_qa-format annotations of ``task``'s videos (default TASK) and
    a vidmapping under ``root``; returns the config's path overrides."""
    task = TASK if task is None else task
    words, subjects = TASK_WORDS, TASK_SUBJECTS
    answers = ["cooking", "running", "ball", "brown", "beach", "man"]
    vids = [f"vid{i:04d}" for i in range(task["videos"])]

    def annos(n_per_video, videos):
        out = []
        for i, vid in enumerate(videos):
            for j in range(n_per_video):
                w = words[(i + j) % len(words)]
                out.append({"question": f"{w} is the "
                                        f"{subjects[(i + j) % 4]} doing",
                            "answer": answers[(3 * i + j) % len(answers)],
                            "video": f"{vid}.avi", "answer_type": w})
        return out

    paths = {}
    for split, rows in (("train", annos(task["questions"], vids)),
                        ("val", annos(1, vids[:task["val"]])),
                        ("test", annos(1, vids[-task["test"]:]))):
        paths[split] = os.path.join(root, f"qa_{split}.json")
        with open(paths[split], "w") as f:
            json.dump(rows, f)
    paths["vidmapping"] = os.path.join(root, "vidmapping.json")
    with open(paths["vidmapping"], "w") as f:
        json.dump({v: i for i, v in enumerate(vids)}, f)
    return {"train_datasets": [{"name": "msvd_qa", "txt": paths["train"],
                                "img": "memory"}],
            "val_datasets": [{"name": "msvd_qa", "txt": paths["val"],
                              "img": "memory"}],
            "inference_txt_db": paths["test"], "inference_img_db": "memory",
            "vid_mapping": paths["vidmapping"]}


def _memory_store(task):
    """``task``'s seeded frames in host memory."""
    rng = np.random.default_rng(0)
    return MemoryFrameStore(rng.standard_normal(
        (task["videos"], task["stored_frames"], task["img"], task["img"], 3),
        dtype=np.float32))


def _timed_start_training(cfg, root, store, wrap_loader=None,
                          profile_call=None):
    """``start_training`` through its normal entry (``cfg`` written to a
    file under ``root`` and parsed by get_video_qa_args), frames from
    ``store``; the step, the prefetcher and validate are wrapped to time
    them (and the weight loader by ``wrap_loader``); nothing else in the
    loop changes.  The step call numbered ``profile_call`` (from 1) runs
    under ``torch.profiler`` (CPU and CUDA), summed by
    :func:`_collectives`.  Returns the result, the timings, the launch
    counts of the run, its train/loss entries, snapshots and peak
    memory."""
    step_s, wait_s, val_s, staged = [], [], [], []
    profiled = []
    real_steps = {name: getattr(train_steps, name) for name in STEP_FACTORIES}
    real_validate = run_video_qa.validate
    real_prefetcher = run_video_qa.DevicePrefetcher
    real_loader = run_video_qa.load_pretrained_params

    def timed(real):
        def factory(*a, **kw):
            step = real(*a, **kw)

            def run(state, batch, seed):
                if len(step_s) + 1 == profile_call:
                    prof = torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA])
                    with prof:
                        out = step(state, batch, seed)
                        torch.cuda.synchronize()
                    profiled.append(_collectives(prof))
                    step_s.append(float("nan"))
                    return out
                t0 = time.perf_counter()
                out = step(state, batch, seed)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                return out
            return run
        return factory

    class TimedPrefetcher(real_prefetcher):
        def _stage(self, batch):
            # the staged pixel leaf: its host dtype and bytes, and a hash
            # of the first micro-batch's bytes (of a stacked batch, the
            # first of its K micros)
            px = batch["visual_inputs"]
            first = px[0] if px.ndim == 6 else px
            staged.append({"dtype": str(px.dtype), "nbytes": px.nbytes,
                           "ndim": px.ndim, "sha1": None if staged else
                           hashlib.sha1(np.ascontiguousarray(first)
                                        .tobytes()).hexdigest()})
            return super()._stage(batch)

        def __next__(self):
            t0 = time.perf_counter()
            try:
                return super().__next__()
            finally:
                wait_s.append(time.perf_counter() - t0)

    def timed_validate(*a, **kw):
        t0 = time.perf_counter()
        out = real_validate(*a, **kw)
        val_s.append(time.perf_counter() - t0)
        return out

    path = os.path.join(root, "cfg.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    args = run_video_qa.get_video_qa_args(["--config", path])
    for name, real in real_steps.items():
        setattr(train_steps, name, timed(real))
    run_video_qa.DevicePrefetcher = TimedPrefetcher
    run_video_qa.validate = timed_validate
    if wrap_loader is not None:
        run_video_qa.load_pretrained_params = wrap_loader(real_loader)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        result = run_video_qa.start_training(args,
                                             open_store=lambda path: store)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launches_made()
    finally:
        for name, real in real_steps.items():
            setattr(train_steps, name, real)
        run_video_qa.DevicePrefetcher = real_prefetcher
        run_video_qa.validate = real_validate
        run_video_qa.load_pretrained_params = real_loader
    out = cfg["output_dir"]
    with open(os.path.join(out, "log", "scalars.jsonl")) as f:
        scalars = [json.loads(line) for line in f]
    restore_files = sorted(os.listdir(os.path.join(out, "restore")),
                           key=lambda n: int(re.findall(r"\d+", n)[0]))
    restored = torch.load(os.path.join(out, "restore", restore_files[-1]),
                          map_location="cpu", weights_only=True,
                          mmap=True) if restore_files else None
    return {"result": result, "launches": launches, "wall_s": wall,
            "step_s": step_s, "wait_s": wait_s, "val_s": val_s,
            "profile": profiled[0] if profiled else None,
            "staged": staged, "pixel_staging": pixel_dtype_for(args),
            "restored": None if restored is None else {
                "optimizer": restored["layout"]["optimizer"],
                "updates": _update_count(restored["opt_state"]),
                "micro_step": restored["step"]},
            "losses": [r["value"] for r in scalars
                       if r["tag"] == "train/loss"],
            "ckpt": sorted(os.listdir(os.path.join(out, "ckpt"))),
            "restore": sorted(os.listdir(os.path.join(out, "restore"))),
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 2 ** 30}


# the loop's train-step factories, each wrapped to time its calls
STEP_FACTORIES = ("make_scan_train_step", "make_git_train_step",
                  "make_classifier_train_step", "make_mc_train_step")


def _update_count(opt_state):
    """Optimizer updates in a restore snapshot's optimizer state (a
    MultiSteps state holds its inner optimizer's)."""
    return int(opt_state["inner"]["count"] if "inner" in opt_state
               else opt_state["count"])


def phase_task_loop():
    """``start_training`` at the vitl16 shape, on the card, through its
    normal entry (a config file parsed by get_video_qa_args), frames from
    an in-memory store: 4 AdamW updates of 2 micros of 8 questions over 16
    frames, one in-loop validation and the final one.  The step, the
    prefetcher and validate are wrapped to time them; nothing else in the
    loop changes."""
    t_setup = time.perf_counter()
    store = _memory_store(TASK)
    with tempfile.TemporaryDirectory() as root:
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "configs", "msvd_qa_base.json")) as f:
            cfg = json.load(f)
        # no weights or tokenizer files are in the repo: seeded random
        # weights and the built-in WordPiece vocab
        cfg["model"].pop("pretrained_weights")
        cfg.pop("tokenizer_dir")
        cfg.update(TASK["overrides"], output_dir=os.path.join(root, "out"),
                   **_task_files(root))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_setup
        run = _timed_start_training(cfg, root, store)
        result, launches, losses = run["result"], run["launches"], \
            run["losses"]
        step_s, wait_s, val_s = run["step_s"], run["wait_s"], run["val_s"]
        wall, ckpts, restore = run["wall_s"], run["ckpt"], run["restore"]
    steady = step_s[1:]
    per_update = TASK["overrides"]["gradient_accumulation_steps"] * \
        TASK["overrides"]["train_batch_size"]
    s_len = TASK["stored_frames"] * 257 + TASK["overrides"]["max_seq_len"]
    row = {"phase": "task_loop",
           "model": "git-large (ViT-L/14) video QA, seeded random weights",
           "config": "configs/msvd_qa_base.json + " + json.dumps(
               {k: v for k, v in TASK["overrides"].items() if k != "model"}),
           "seq_len": s_len, "frames": TASK["stored_frames"],
           "pixel_staging": run["pixel_staging"],
           "backward_route": bwd_kernels(),
           "updates": result["global_step"], "setup_s": setup_s,
           "wall_s": wall, "update_s": step_s,
           "ms_per_update": float(np.mean(steady)) * 1e3,
           "qa_pairs_per_s": per_update / float(np.mean(steady)),
           "prefetch_wait_ms_per_update": float(np.mean(wait_s[1:])) * 1e3,
           "prefetch_wait_first_ms": wait_s[0] * 1e3,
           "validation_s": val_s,
           "max_memory_allocated_gb": run["max_memory_allocated_gb"],
           "losses": losses, "ckpt": ckpts, "restore": restore,
           "val": result["val"], "test": result["test"],
           "launches": launches}
    emit(row)
    check(result["global_step"] == 4 and len(losses) == 4
          and all(np.isfinite(losses)),
          f"task loop: not 4 finite train/loss entries: {losses}")
    check(ckpts == ["model_step_2.pt", "model_step_4.pt"] and restore,
          f"task loop: snapshots {ckpts}, restore {restore}")
    check("overall_acc" in result["val"] and "overall_acc" in result["test"],
          "task loop: a final score dict is missing")
    route = bwd_kernels()
    check(all(launches[n] > 0 for n in
              ("git_flash_fwd", _build.HASH_DROPOUT) + route),
          f"task loop: a kernel of its route was not launched: {launches}")
    torch.cuda.empty_cache()
    return row, launches


# the classifier loop: configs/msvd_qa_base3.json as shipped (CLIP
# ViT-B/16 at 224x224, the mlp head over 1000 labels, train_batch_size 8,
# 4 accumulated micros, adam with multi_step decay, 'single' sampling: the
# middle stored frame of each video), with a seeded full-width checkpoint
# in HF CLIPModel names as its pretrained_weights and a BPE vocabulary of
# its questions as its tokenizer_dir; 96 videos of 2 questions and one
# epoch cut it to 6 updates (5 timed after the first); 32 val and 32 test
# questions
CLIP_TASK = dict(videos=96, questions=2, stored_frames=8, img=224, val=32,
                 test=32, overrides={"num_train_epochs": 1})
# the same loop with BLIP-base at 384x384 (577 tokens a frame: K5 and K6
# in the vision tower), seeded weights, the built-in WordPiece vocab: 6
# updates and the final validation
BLIP_TASK = dict(videos=96, questions=2, stored_frames=4, img=384, val=16,
                 test=16, overrides={"num_train_epochs": 1, "img_size": 384},
                 model="Salesforce/blip-vqa-base")
CLASSIFIER_UPDATES = 6
# GIT-base checkpoints carry temporal embeddings for 6 frames
# (num_image_with_embedding of microsoft/git-base-msrvtt-qa)
GIT_TEMPORAL_FRAMES = 6


def write_clip_bpe_files(root, texts):
    """``vocab.json`` + ``merges.txt`` under ``root`` for
    CLIPBPETokenizer: every lowercase ASCII letter, digit and '?' alone
    and word-final, each word of ``texts`` built left to right by merges
    (every merge's result in the vocabulary), and CLIP's special tokens at
    their ids in the 49408-entry vocabulary."""
    vocab, merges = {}, []
    for c in "abcdefghijklmnopqrstuvwxyz0123456789?":
        vocab.setdefault(c, len(vocab))
        vocab.setdefault(c + "</w>", len(vocab))
    for word in sorted({w for t in texts for w in t.lower().split()}):
        pieces = list(word[:-1]) + [word[-1] + "</w>"]
        cur = pieces[0]
        for nxt in pieces[1:]:
            if f"{cur} {nxt}" not in merges:
                merges.append(f"{cur} {nxt}")
            cur += nxt
            vocab.setdefault(cur, len(vocab))
    vocab["<|startoftext|>"], vocab["<|endoftext|>"] = 49406, 49407
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(root, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    return root


def _clip_raw_checks(model, sd):
    """Leaves checked against the raw HF tensors without the converters:
    the fused QKV (q, k, v stacked on the output axis), the patch
    embedding unfolded in (ph, pw, c) order, the token embedding."""
    p = "vision_model.encoder.layers.0.self_attn"
    qkv = torch.cat([sd[f"{p}.{x}_proj.weight"] for x in "qkv"], dim=0)
    patch = sd["vision_model.embeddings.patch_embedding.weight"]
    vis = model.vis_model
    return {
        "fused_qkv": torch.equal(
            vis.layers_0.self_attn.qkv.weight.detach().cpu(), qkv),
        "patch_unfold": torch.equal(
            vis.patch_embedding.proj.weight.detach().cpu(),
            patch.permute(0, 2, 3, 1).reshape(patch.shape[0], -1)),
        "token_embedding": torch.equal(
            model.txt_model.token_embedding.weight.detach().cpu(),
            sd["text_model.embeddings.token_embedding.weight"])}


def _base3_cfg(root, task):
    """configs/msvd_qa_base3.json with ``task``'s overrides, its
    annotations and an output directory under ``root``."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs", "msvd_qa_base3.json")) as f:
        cfg = json.load(f)
    cfg.update(task["overrides"], output_dir=os.path.join(root, "out"),
               **_task_files(root, task))
    return cfg


def _split_path(cfg, split):
    """The annotation file of a split of a task config."""
    return {"train": cfg["train_datasets"][0]["txt"],
            "val": cfg["val_datasets"][0]["txt"],
            "test": cfg["inference_txt_db"]}[split]


def _classifier_loop_row(name, cfg, run, setup_s, frames):
    """The row of a classifier task-loop phase: ms an update and QA pairs/s
    (the mean of the updates after the first, with their least, median
    and largest), validation passes, peak memory, losses, scores and
    launches."""
    steady = run["step_s"][1:]
    per_update = cfg["train_batch_size"] * \
        cfg["gradient_accumulation_steps"] * cfg["max_n_example_per_group"]
    return {"phase": name, "model": cfg["model"]["pretrained_model"],
            "config": "configs/msvd_qa_base3.json + " + json.dumps(
                {k: v for k, v in cfg.items()
                 if k in ("num_train_epochs", "img_size", "task",
                          "max_txt_len", "save_steps_ratio")}),
            "frames_per_question": frames, "img": cfg["img_size"],
            "pixel_staging": run["pixel_staging"],
            "pixel_bytes_per_update": _pixel_bytes_per_update(cfg, run),
            "questions_per_update": per_update,
            "updates": run["result"]["global_step"], "setup_s": setup_s,
            "wall_s": run["wall_s"], "update_s": run["step_s"],
            "ms_per_update": float(np.mean(steady)) * 1e3,
            "steady_update_ms": {
                "n": len(steady), "min": float(np.min(steady)) * 1e3,
                "median": float(np.median(steady)) * 1e3,
                "max": float(np.max(steady)) * 1e3},
            "qa_pairs_per_s": per_update / float(np.mean(steady)),
            "prefetch_wait_ms_per_update":
                float(np.mean(run["wait_s"][1:])) * 1e3,
            "validation_s": run["val_s"],
            "max_memory_allocated_gb": run["max_memory_allocated_gb"],
            "losses": run["losses"], "ckpt": run["ckpt"],
            "val": run["result"]["val"], "test": run["result"]["test"],
            "launches": run["launches"]}


def _pixel_bytes_per_update(cfg, run):
    """Host pixel bytes copied to the card an update: the first staged
    batch's, times the micros of an update when the batches are not
    stacked (stacked ones carry the K micros)."""
    first = run["staged"][0]
    return first["nbytes"] * (1 if first["ndim"] == 6
                              else cfg["gradient_accumulation_steps"])


def _check_classifier_loop(name, run, updates):
    losses, result = run["losses"], run["result"]
    check(result["global_step"] == updates and len(losses) == updates
          and all(np.isfinite(losses)),
          f"{name}: not {updates} finite train/loss entries: {losses}")
    check(run["ckpt"] == [f"model_step_{updates}.pt"],
          f"{name}: snapshots {run['ckpt']}")
    check("overall_acc" in result["val"] and "overall_acc" in result["test"],
          f"{name}: a final score dict is missing")


def clip_checkpoint(root):
    """A seeded full-width checkpoint of configs/msvd_qa_base3.json's
    CLIP ViT-B/16 in HF CLIPModel names under ``root`` (the clip_task_loop
    and mc_clip_task_loop load it)."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs", "msvd_qa_base3.json")) as f:
        name = json.load(f)["model"]["pretrained_model"]
    tc, vc = _clip_configs(name.lower())
    weights, sd, write_s = write_hf_checkpoint(
        os.path.join(root, "weights"), hf_clip_shapes(tc, vc), seed=0)
    return {"dir": weights, "sd": sd, "write_s": write_s, "tc": tc,
            "vc": vc, "bytes": os.path.getsize(
                os.path.join(weights, "pytorch_model.bin"))}


def _clip_loader_probe(ckpt, loads):
    """A wrapper of the loop's weight loader that times the load and
    checks every converted leaf of ``ckpt`` (and three raw tensors) in the
    loaded model; appends what it saw to ``loads``."""
    def wrap(real):
        def load(family, model, path):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            report = real(family, model, path)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            converted = cv.convert_clip_video_qa(
                ckpt["sd"], ckpt["tc"].num_layers, ckpt["vc"].num_layers)
            loads.append({"loader_s": load_s, "report": report,
                          "check": check_loaded(model, converted),
                          "raw": _clip_raw_checks(model, ckpt["sd"]),
                          "family": family})
            return report
        return load
    return wrap


def _clip_tokenizer(cfg, root, texts_of=lambda r: [r["question"]]):
    """A BPE vocabulary of every text of the config's splits under
    ``root``/tokenizer; ``texts_of`` reads one annotation's texts."""
    texts = []
    for split in ("train", "val", "test"):
        texts += [t for r in _read_annotations(_split_path(cfg, split))
                  for t in texts_of(r)]
    return write_clip_bpe_files(os.path.join(root, "tokenizer"), texts)


def _read_annotations(path):
    """A JSON list or a JSONL file of annotations."""
    with open(path) as f:
        if path.endswith(".jsonl"):
            return [json.loads(line) for line in f if line.strip()]
        return json.load(f)


def _clip_load_row(name, loads):
    """What the loop's one load of the checkpoint did."""
    check(len(loads) == 1 and loads[0]["family"] == "clip",
          f"{name}: the loader ran {len(loads)} times")
    load = loads[0]
    report, (compared, differ) = load["report"], load["check"]
    return {"loader_s": load["loader_s"], "loaded": len(report["loaded"]),
            "missing_in_ckpt": report["missing_in_ckpt"],
            "mismatched": report["mismatched"], "leaves_checked": compared,
            "leaves_differing": differ, "raw_checks": load["raw"]}


def _check_clip_load(name, row, head):
    """Every converted leaf holds the checkpoint's bits and only ``head``
    was kept from init."""
    check(not row["mismatched"] and row["missing_in_ckpt"] == [head]
          and row["leaves_checked"] == row["loaded"] > 0
          and not row["leaves_differing"] and all(row["raw_checks"].values()),
          f"{name}: the loaded weights are not the checkpoint's: "
          f"{row['mismatched']} {row['missing_in_ckpt']} "
          f"{row['leaves_checked']} {row['leaves_differing'][:5]} "
          f"{row['raw_checks']}")


def phase_clip_task_loop(ckpt):
    """``start_training`` on configs/msvd_qa_base3.json at full width
    (CLIP ViT-B/16), its ``model.pretrained_weights`` the seeded
    checkpoint ``ckpt`` in HF CLIPModel names that the loop loads (every
    converted leaf checked against the checkpoint right after the load),
    its ``tokenizer_dir`` a BPE vocabulary of its questions: 6 updates and
    the final validation."""
    t_setup = time.perf_counter()
    store = _memory_store(CLIP_TASK)
    with tempfile.TemporaryDirectory() as root:
        cfg = _base3_cfg(root, CLIP_TASK)
        cfg["model"]["pretrained_weights"] = ckpt["dir"]
        cfg["tokenizer_dir"] = _clip_tokenizer(cfg, root)
        loads = []
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_setup
        run = _timed_start_training(cfg, root, store,
                                    wrap_loader=_clip_loader_probe(ckpt,
                                                                   loads))
    row = _classifier_loop_row("clip_task_loop", cfg, run, setup_s, 1)
    row.update(checkpoint_bytes=ckpt["bytes"],
               checkpoint_write_s=ckpt["write_s"],
               **_clip_load_row("clip task loop", loads))
    emit(row)
    _check_classifier_loop("clip task loop", run, CLASSIFIER_UPDATES)
    _check_clip_load("clip task loop", row, "/answer_head")
    torch.cuda.empty_cache()
    return row, run["launches"]


class FlashShapes:
    """While active, records the (B, H, Lq, Lk, bias kind) of every K5
    (``fwd``) and K6 (``bwd``) call, so that each is held against its
    plain version."""

    def __init__(self):
        self.shapes = {"fwd": set(), "bwd": set()}

    @staticmethod
    def _key(q, k, bias):
        return tuple(q.shape[:3]) + (k.shape[2],
                                     None if bias is None else "bias")

    def __enter__(self):
        real_fwd, real_bwd = fa.flash_forward, fa.flash_backward
        self._real = real_fwd, real_bwd

        def fwd(q, k, v, bias=None):
            self.shapes["fwd"].add(self._key(q, k, bias))
            return real_fwd(q, k, v, bias)

        def bwd(q, k, v, o, lse, do, bias=None):
            self.shapes["bwd"].add(self._key(q, k, bias))
            return real_bwd(q, k, v, o, lse, do, bias)

        fa.flash_forward, fa.flash_backward = fwd, bwd
        return self

    def __exit__(self, *exc):
        fa.flash_forward, fa.flash_backward = self._real


class GitFlashShapes:
    """While active, records the (B, H, num_img, L, Dh) of every K1
    (``fwd``) launch and every git-flash backward (``bwd``: K2, or K3 off
    the fused route) of the autograd path, so that each is held against
    its plain version."""

    def __init__(self):
        self.shapes = {"fwd": set(), "bwd": set()}

    def _add(self, part, q, attention_mask, num_img):
        b, h, _, dh = q.shape
        self.shapes[part].add((b, h, num_img, attention_mask.shape[1], dh))

    def __enter__(self):
        self._real = real_fwd, real_bwd = gf._launch, gf.git_flash_backward

        def fwd(q, k, v, attention_mask, num_img, *rest):
            self._add("fwd", q, attention_mask, num_img)
            return real_fwd(q, k, v, attention_mask, num_img, *rest)

        def bwd(q, k, v, o, lse, do, attention_mask, num_img, *rest):
            self._add("bwd", q, attention_mask, num_img)
            return real_bwd(q, k, v, o, lse, do, attention_mask, num_img,
                            *rest)

        gf._launch, gf.git_flash_backward = fwd, bwd
        return self

    def __exit__(self, *exc):
        gf._launch, gf.git_flash_backward = self._real


def phase_blip_task_loop():
    """The classifier loop of configs/msvd_qa_base3.json with BLIP-base at
    384x384, seeded weights: 6 updates and the final validation, through
    K5 and K6 in the vision tower.  Also returns the (B, H, Lq, Lk, bias
    kind) of every K5 and every K6 call in the run, so that each is held
    against its plain version."""
    t_setup = time.perf_counter()
    store = _memory_store(BLIP_TASK)
    with tempfile.TemporaryDirectory() as root:
        cfg = _base3_cfg(root, BLIP_TASK)
        cfg["model"]["pretrained_model"] = BLIP_TASK["model"]
        # no BLIP checkpoint or vocabulary: seeded weights and the
        # built-in WordPiece vocab
        cfg["model"].pop("pretrained_weights")
        cfg.pop("tokenizer_dir")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_setup
        with FlashShapes() as rec:
            run = _timed_start_training(cfg, root, store)
    row = _classifier_loop_row("blip_task_loop", cfg, run, setup_s, 1)
    row["flash_shapes"] = {part: sorted(v) for part, v in rec.shapes.items()}
    emit(row)
    _check_classifier_loop("blip task loop", run, CLASSIFIER_UPDATES)
    check(all(run["launches"][n] > 0 for n in
              ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
          f"blip task loop: K5 or K6 was not launched: {run['launches']}")
    torch.cuda.empty_cache()
    return row, run["launches"], rec.shapes


# TGIF-QA multiple choice through the same loop: configs/msvd_qa_base3.json
# with task action (BLIP-base at 384x384, seeded weights, the built-in
# WordPiece vocab) or transition (CLIP ViT-B/16 from the clip_task_loop's
# checkpoint, a BPE vocabulary of its questions and options): TGIF-format
# JSONL annotations (gif_name, question, 5 options, the answer's index),
# 96 GIFs of 2 questions, one epoch of 6 updates of 4 micros of 8 questions
# (40 question+option rows a micro), 16 val and 16 test questions, one
# restore snapshot at the end (save_steps_ratio 1; the shipped 0.01 writes
# one after every update at this depth, about 6 s each).  The
# built-in WordPiece vocab splits words into pieces: BLIP's rows take 40
# tokens, which hold question and option (at most 31)
MC_BLIP_TASK = dict(BLIP_TASK, task="action", val=16, test=16,
                    overrides=dict(BLIP_TASK["overrides"], max_txt_len=40,
                                   save_steps_ratio=1.0))
MC_CLIP_TASK = dict(CLIP_TASK, task="transition", val=16, test=16,
                    overrides=dict(CLIP_TASK["overrides"],
                                   save_steps_ratio=1.0))
MC_SUBJECTS = ["man", "woman", "girl", "boy", "dog", "cat"]
MC_VERBS = ["jumps", "waves", "runs", "claps", "spins", "nods", "smiles",
            "turns", "sits", "laughs"]


def _mc_task_files(root, spec):
    """TGIF-format JSONL annotations of ``spec``'s GIFs (5 options a
    question, the answer an option index) and a vidmapping under
    ``root``; returns the config's path overrides."""
    task, n_opt = spec["task"], 5
    vids = [f"gif{i:04d}" for i in range(spec["videos"])]

    def annos(n_per_video, videos):
        rows = []
        for i, vid in enumerate(videos):
            for j in range(n_per_video):
                k = 3 * i + j
                who = MC_SUBJECTS[k % len(MC_SUBJECTS)]
                question = (f"what does the {who} do "
                            + ("after the video starts" if task ==
                               "transition" else "in the video"))
                rows.append({
                    "gif_name": vid, "question": question,
                    "options": [f"{who} {MC_VERBS[(k + o) % len(MC_VERBS)]}"
                                for o in range(n_opt)],
                    "answer": k % n_opt})
        return rows

    paths = {}
    for split, rows in (("train", annos(spec["questions"], vids)),
                        ("val", annos(1, vids[:spec["val"]])),
                        ("test", annos(1, vids[-spec["test"]:]))):
        paths[split] = os.path.join(root, f"{task}_{split}.jsonl")
        with open(paths[split], "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    paths["vidmapping"] = os.path.join(root, "vidmapping.json")
    with open(paths["vidmapping"], "w") as f:
        json.dump({v: i for i, v in enumerate(vids)}, f)
    return {"task": task,
            "train_datasets": [{"name": task, "txt": paths["train"],
                                "img": "memory"}],
            "val_datasets": [{"name": task, "txt": paths["val"],
                              "img": "memory"}],
            "inference_txt_db": paths["test"], "inference_img_db": "memory",
            "vid_mapping": paths["vidmapping"]}


def _mc_cfg(root, spec):
    cfg = _base3_cfg(root, spec)
    cfg.update(_mc_task_files(root, spec))
    return cfg


def _check_mc_loop(name, run, updates):
    _check_classifier_loop(name, run, updates)
    for split in ("val", "test"):
        check(set(run["result"][split]) == {"overall_acc"},
              f"{name}: multiple choice scores {run['result'][split]}")


def _mc_row(name, cfg, run, setup_s):
    row = _classifier_loop_row(name, cfg, run, setup_s, 1)
    row["option_rows_per_update"] = row["questions_per_update"] * 5
    row["option_rows_per_s"] = row["qa_pairs_per_s"] * 5
    return row


def phase_mc_blip_task_loop():
    """TGIF-QA action multiple choice in ``start_training`` with BLIP-base
    at 384x384 (seeded weights): 6 updates of 4 micros of 8 GIFs x 5
    options and the final validation, through K5 and K6 in the vision
    tower; returns the K5/K6 shapes of the run too."""
    t_setup = time.perf_counter()
    store = _memory_store(MC_BLIP_TASK)
    with tempfile.TemporaryDirectory() as root:
        cfg = _mc_cfg(root, MC_BLIP_TASK)
        cfg["model"]["pretrained_model"] = MC_BLIP_TASK["model"]
        cfg["model"].pop("pretrained_weights")
        cfg.pop("tokenizer_dir")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_setup
        with FlashShapes() as rec:
            run = _timed_start_training(cfg, root, store)
    row = _mc_row("mc_blip_task_loop", cfg, run, setup_s)
    row["flash_shapes"] = {part: sorted(v) for part, v in rec.shapes.items()}
    emit(row)
    _check_mc_loop("mc blip task loop", run, CLASSIFIER_UPDATES)
    check(all(run["launches"][n] > 0 for n in
              ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
          f"mc blip task loop: K5 or K6 was not launched: {run['launches']}")
    torch.cuda.empty_cache()
    return row, run["launches"], rec.shapes


def phase_mc_clip_task_loop(ckpt):
    """TGIF-QA transition multiple choice in ``start_training`` with CLIP
    ViT-B/16 loaded from ``ckpt`` (the loader's report: only ``mc_head``
    kept from init) and a BPE vocabulary of its questions and options: 6
    updates and the final validation."""
    t_setup = time.perf_counter()
    store = _memory_store(MC_CLIP_TASK)
    with tempfile.TemporaryDirectory() as root:
        cfg = _mc_cfg(root, MC_CLIP_TASK)
        cfg["model"]["pretrained_weights"] = ckpt["dir"]
        cfg["tokenizer_dir"] = _clip_tokenizer(
            cfg, root, lambda r: [r["question"]] + r["options"])
        loads = []
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_setup
        run = _timed_start_training(cfg, root, store,
                                    wrap_loader=_clip_loader_probe(ckpt,
                                                                   loads))
    row = _mc_row("mc_clip_task_loop", cfg, run, setup_s)
    row.update(**_clip_load_row("mc clip task loop", loads))
    emit(row)
    _check_mc_loop("mc clip task loop", run, CLASSIFIER_UPDATES)
    _check_clip_load("mc clip task loop", row, "/mc_head")
    torch.cuda.empty_cache()
    return row, run["launches"]


# the loop's other single-device options on configs/msvd_qa_base3.json
# (CLIP ViT-B/16, seeded weights, the built-in WordPiece vocab): 32 videos
# of 2 questions, one epoch of 2 updates of 4 micros of 8 questions; one
# restore snapshot a run (save_steps_ratio 1)
OPTIONS_TASK = dict(videos=32, questions=2, stored_frames=4, img=224, val=8,
                    test=8, overrides={"num_train_epochs": 1,
                                       "save_steps_ratio": 1.0})
LOOP_OPTIONS = {
    "multisteps": {"scan_accum": 0},
    "adamw_bf16_moments": {"optim": "adamw", "adamw_moment_dtype": "bf16"},
    "adamax": {"optim": "adamax"},
    "sgd": {"optim": "sgd"},
    "collator_pool": {"n_workers": 2},
    "f32_staging": {"stage_pixels_bf16": 0}}
OPTIONS_UPDATES = 2


def phase_loop_options():
    """``start_training`` under each of LOOP_OPTIONS: finite losses, the
    update count and the optimizer in the restore snapshot, the first
    batch's pixel bytes equal in every run (the pool's too), and the
    pixel bytes an update under bf16 and f32 staging."""
    store = _memory_store(OPTIONS_TASK)
    runs = {}
    for name, over in LOOP_OPTIONS.items():
        with tempfile.TemporaryDirectory() as root:
            cfg = _base3_cfg(root, OPTIONS_TASK)
            cfg["model"].pop("pretrained_weights")
            cfg.pop("tokenizer_dir")
            cfg.update(over)
            run = _timed_start_training(cfg, root, store)
        runs[name] = {
            "options": over, "updates": run["result"]["global_step"],
            "losses": run["losses"], "wall_s": run["wall_s"],
            "step_calls_s": run["step_s"],
            "restore": run["restored"], "pixel_staging": run["pixel_staging"],
            "first_batch_sha1": run["staged"][0]["sha1"],
            "pixel_bytes_per_update": _pixel_bytes_per_update(cfg, run),
            "max_memory_allocated_gb": run["max_memory_allocated_gb"],
            "val": run["result"]["val"]}
        torch.cuda.empty_cache()
    row = {"phase": "loop_options", "model": "openai/clip-vit-base-patch16",
           "config": "configs/msvd_qa_base3.json + " + json.dumps(
               OPTIONS_TASK["overrides"]), "runs": runs,
           "pixel_bytes_per_update": {
               "bf16": runs["adamax"]["pixel_bytes_per_update"],
               "f32": runs["f32_staging"]["pixel_bytes_per_update"]}}
    emit(row)
    kinds = {"multisteps": "multisteps(adam)",
             "adamw_bf16_moments": "adamw/bf16", "adamax": "adamax",
             "sgd": "sgd", "collator_pool": "adam", "f32_staging": "adam"}
    for name, r in runs.items():
        check(r["updates"] == OPTIONS_UPDATES
              and len(r["losses"]) == OPTIONS_UPDATES
              and all(np.isfinite(r["losses"])),
              f"loop options {name}: updates {r['updates']}, losses "
              f"{r['losses']}")
        check(r["restore"] is not None
              and r["restore"]["optimizer"] == kinds[name]
              and r["restore"]["updates"] == OPTIONS_UPDATES,
              f"loop options {name}: restore snapshot {r['restore']}")
        check(r["pixel_staging"] == ("f32" if name == "f32_staging"
                                     else "bf16"),
              f"loop options {name}: staged {r['pixel_staging']}")
    check(len(runs["multisteps"]["step_calls_s"]) == 4 * OPTIONS_UPDATES,
          f"loop options: MultiSteps took "
          f"{len(runs['multisteps']['step_calls_s'])} step calls")
    check(len({r["first_batch_sha1"] for r in runs.values()
               if r["pixel_staging"] == "bf16"}) == 1,
          "loop options: the first batch differs between runs (the pool's "
          "against the thread's)")
    bpu = row["pixel_bytes_per_update"]
    check(bpu["f32"] == 2 * bpu["bf16"],
          f"loop options: pixel bytes an update {bpu}")
    return row


def phase_git_load():
    """A seeded full-width checkpoint in HF GitForCausalLM names (with
    temporal embeddings for 6 frames) loaded onto GIT-base by
    ``load_pretrained_params``: every leaf loaded and equal to the
    checkpoint's, the temporal embeddings dropped; then one batch served
    through ``QAEngine`` from the loaded model."""
    family, model = build_model(
        {"model": {"pretrained_model": "microsoft/git-base-msrvtt-qa"}},
        dtype=torch.bfloat16, device="cuda",
        generator=torch.Generator().manual_seed(2))
    gc = model.config
    with tempfile.TemporaryDirectory() as root:
        path, sd, write_s = write_hf_checkpoint(
            root, hf_git_shapes(gc, GIT_TEMPORAL_FRAMES), seed=1)
        ckpt_bytes = os.path.getsize(os.path.join(path, "pytorch_model.bin"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        report = load_pretrained_params(family, model, path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    compared, differ = check_loaded(
        model, cv.convert_git(sd, gc.num_layers, gc.vision.num_layers))
    n_params = len(list(model.parameters()))
    temporal = [k for k in sd if "temporal" in k]
    engine = QAEngine(model, family, make_test_wordpiece(), nframe=2,
                      samp_policy="uniform", batch_size=SLICE["batch_size"],
                      max_txt_len=SLICE["max_txt_len"],
                      max_text_len=SLICE["max_text_len"], device="cuda")
    try:
        reqs = _requests(SLICE["batch_size"], seed=3)
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        answers = engine._run_batch([(f, q, None) for f, q in reqs])
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t0
        launches = launches_made()
    finally:
        engine.close()
    row = {"phase": "git_load", "model": "microsoft/git-base-msrvtt-qa",
           "checkpoint_bytes": ckpt_bytes, "checkpoint_write_s": write_s,
           "loader_s": load_s, "loaded": len(report["loaded"]),
           "parameters": n_params,
           "missing_in_ckpt": report["missing_in_ckpt"],
           "mismatched": report["mismatched"], "leaves_checked": compared,
           "leaves_differing": differ, "temporal_keys_dropped": temporal,
           "batch_requests": len(reqs), "batch_s": batch_s,
           "answers": [a["answer"] for a in answers], "launches": launches}
    emit(row)
    check(not report["mismatched"] and not report["missing_in_ckpt"]
          and len(report["loaded"]) == compared == n_params and not differ,
          f"git load: {report['mismatched']} {report['missing_in_ckpt']} "
          f"{compared}/{n_params} {differ[:5]}")
    check(len(temporal) == GIT_TEMPORAL_FRAMES
          and not any("temporal" in n for n, _ in model.named_parameters()),
          f"git load: temporal embeddings {temporal}")
    check(len(answers) == len(reqs)
          and all(isinstance(a["answer"], str) for a in answers)
          and launches["git_flash_fwd"] == gc.num_layers,
          f"git load: served {answers}, launches {launches}")
    del model, engine
    torch.cuda.empty_cache()
    return row

# ---- offline stages and the CLIs ------------------------------------------

# stage A: extract's repr defaults (K 16, W 8, 224x224, every frame) over
# four in-memory videos whose lengths fall in the 512, 1024 and 2048
# buckets and past the 2,048-frame clamp; scenes of seeded colours with
# per-frame noise, so neighbouring frames are alike and scenes are not
STAGE_A = dict(lengths=(300, 700, 1500, 2500), K=16, W=8, img=224,
               scenes=8, seed=0)
# device lcl (an f32 cumulative sum over up to 2,048 rows) against the
# oracle's dense f64 sums of the same features: the cumulative sum's
# rounding grows with the row count
TOL_LCL = 1e-4
# stage B: gen_cap over 8 videos of K 32 stored frames in batches of
# batch_rows 4 (128 rows, GIT-base, 30 tokens); gen_inds on 8 questions a
# video (64 questions x 32 captions, BERT-base-cased dims, 64 tokens)
STAGE_B = dict(videos=8, frames=32, questions=8, img=224, seed=7)
GIT_VOCAB, BERT_CASED_VOCAB = 30522, 28996
# the scorer on the card against the same weights on the CPU, f32 with
# TF32 off through 12 layers: 2^-12 of the logit scale
TOL_F32_DEEP = 2.0 ** -12
# predict and the serve CLI: git-base-msrvtt-qa dims, the CLIs' defaults
# (nframe 6, 224x224, batch 8, 16 stored frames, u8 pixels), raw AVIs of
# 240x320 (so frames go through the PIL resize and crop) when PIL is
# installed
CLI = dict(model="microsoft/git-base-msrvtt-qa", nframe=6, img=224,
           height=240, width=320, predict_frames=30, serve_frames=20,
           requests=8, batch_size=8, max_txt_len=20,
           question="what is the man doing in the kitchen", seed=11)


def _scene_video(n, spec, seed):
    """(n, S, S, 3) uint8: ``spec['scenes']`` scenes of a seeded colour
    field, each frame with one of 97 noise fields and one of 13
    brightness steps (no two frames of a scene alike; sums stay below
    256)."""
    rng = np.random.default_rng(seed)
    s = spec["img"]
    base = rng.integers(0, 160, (spec["scenes"], s, s, 3), dtype=np.uint8)
    bank = rng.integers(0, 64, (97, s, s, 3), dtype=np.uint8)
    t = np.arange(n)
    frames = base[t * spec["scenes"] // n]
    frames += bank[t % 97]
    frames += (2 * (t % 13)).astype(np.uint8)[:, None, None, None]
    return frames


def phase_stage_a():
    """``extract`` with repr on the card (the decode and writer seams hold
    the videos and the store in host memory), then the same tower's
    features read back: the device lcl within TOL_LCL of the oracle's
    dense lcl, the picks equal to the oracle's heap search over the
    device lcl, the store rows the picked frames."""
    from sasvqa_torch.models.git import GIT_BASE
    from sasvqa_torch.sampling import mdf
    from sasvqa_torch.tools import extract_frames as ef
    from sasvqa_torch.tools.hf_checkpoint import hf_clip_vision_shapes
    spec = STAGE_A
    videos = {f"vid{i}": _scene_video(n, spec, spec["seed"] + i)
              for i, n in enumerate(spec["lengths"])}
    writers = []

    def open_writer(*a):
        writers.append(MemoryFrameStores().writer(*a))
        return writers[-1]

    with tempfile.TemporaryDirectory() as root:
        ckpt, _, write_s = write_hf_checkpoint(
            os.path.join(root, "vision"),
            hf_clip_vision_shapes(GIT_BASE.vision), seed=5)
        args = ef.build_argparser().parse_args(
            ["--sampling_strategy", "repr", "--K", str(spec["K"]), "--W",
             str(spec["W"]), "--img_size", str(spec["img"]),
             "--vision_weights", ckpt])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        counter = ef.extract(
            list(videos), os.path.join(root, "out"), args,
            open_writer=open_writer,
            decode=lambda path, s, intv: videos[path][::intv],
            device="cuda")
        torch.cuda.synchronize()
        extract_s = time.perf_counter() - t0
        launches = launches_made()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        with open(os.path.join(root, "out", "vidmapping.json")) as f:
            vidmap = json.load(f)
        enc = ef.MDFEncoder(spec["K"], spec["W"], weights_path=ckpt,
                            img_size=spec["img"], device="cuda")
    per_video, encoded, encode_s = [], 0, 0.0
    for name, raw in videos.items():
        frames = ef.normalize_frames(raw)
        padded, n, w = enc.pad(frames)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = enc.encode(padded)
        torch.cuda.synchronize()
        encode_s += time.perf_counter() - t0
        encoded += len(padded)
        with torch.inference_mode():
            sel_ms = cuda_ms(lambda: mdf.mdf_select_padded(
                feats, n, spec["K"], w), reps=5)
            picks, exhausted = mdf.mdf_select_padded(feats, n, spec["K"], w)
            lcl = mdf.padded_lcl(feats, n, w)[:n].double().cpu().numpy()
        picks = picks.cpu().numpy()
        oracle_lcl = mdf.lcl_reference_numpy(feats[:n].cpu().numpy(), w)
        oracle = mdf.heap_select_numpy(oracle_lcl, spec["K"], w)
        # where the picks part from the oracle's: both picks' oracle lcl
        # (a near-tie within the cumulative sum's rounding, or not)
        part = next((i for i in range(spec["K"]) if picks[i] != oracle[i]),
                    None)
        stored = writers[0].rows[vidmap[name]]
        per_video.append({
            "video": name, "frames": len(raw), "encoded": n,
            "bucket": len(padded), "W": w, "selection_ms": sel_ms,
            "exhausted": bool(exhausted),
            "lcl_max_abs_err": float(np.abs(lcl - oracle_lcl).max()),
            "picks": picks.tolist(),
            "picks_equal_heap_on_device_lcl": picks.tolist()
            == mdf.heap_select_numpy(lcl, spec["K"], w).tolist(),
            "picks_equal_oracle": part is None,
            "oracle_parts_at": None if part is None else {
                "pick": part, "oracle_lcl_of_ours": oracle_lcl[picks[part]],
                "oracle_lcl_of_oracles": oracle_lcl[oracle[part]]},
            "store_rows_are_the_picks": bool(np.array_equal(
                stored, frames[picks].transpose(0, 3, 1, 2).reshape(
                    spec["K"], -1)))})
    row = {"phase": "stage_a", "videos": len(videos),
           "frames_decoded": sum(len(v) for v in videos.values()),
           "frames_selected_from": sum(v["encoded"] for v in per_video),
           "extract_s": extract_s,
           "frames_per_s": sum(v["encoded"] for v in per_video) / extract_s,
           "encode_s": encode_s, "encode_frames_per_s": encoded / encode_s,
           "checkpoint_write_s": write_s, "peak_gb": peak_gb,
           "counters": counter, "tol_lcl": TOL_LCL, "per_video": per_video,
           "launches": launches}
    emit(row)
    clamped = [v for v in per_video if v["frames"] > v["encoded"]]
    check(counter["Zeros"] == 0
          and {v["bucket"] for v in per_video} == set(ef.BUCKETS[-3:])
          and [v["encoded"] for v in clamped] == [ef.BUCKETS[-1]],
          f"stage_a: buckets or clamp not covered: {row}")
    check(all(v["lcl_max_abs_err"] <= TOL_LCL
              and v["picks_equal_heap_on_device_lcl"]
              and v["store_rows_are_the_picks"] for v in per_video),
          f"stage_a: selection disagrees with the oracle: {per_video}")
    del enc
    torch.cuda.empty_cache()
    return row, launches


def _wordpiece_dir(path, size, words):
    """A vocab.txt of ``size`` entries: the special tokens, ``words``,
    then fillers."""
    head = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + list(words)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.txt"), "w") as f:
        f.write("\n".join(head + [f"w{i}" for i in range(size - len(head))])
                + "\n")
    return path


def phase_stage_b():
    """``gen_sample --task gen_cap`` then ``--task gen_inds`` through
    ``main`` on the card (the store in host memory, seeded weights; the
    scorer from a seeded HF-named checkpoint); the scorer's logits on the
    first questions held against the same weights on the CPU."""
    import copy

    from sasvqa_torch.models.bert import BERTConfig
    from sasvqa_torch.sampling.mif import score_question_captions
    from sasvqa_torch.tools import gen_sample as gs
    from sasvqa_torch.tools.hf_checkpoint import hf_bert_classifier_shapes
    spec = STAGE_B
    rng = np.random.default_rng(spec["seed"])
    store = MemoryFrameStore(rng.standard_normal(
        (spec["videos"], spec["frames"], spec["img"], spec["img"], 3),
        dtype=np.float32))
    words = TASK_WORDS + TASK_SUBJECTS + ["the", "is", "doing", "in",
                                          "video"]
    vidmap = {f"vid{v:04d}": v for v in range(spec["videos"])}
    with tempfile.TemporaryDirectory() as root:
        adir = os.path.join(root, "msvd_qa", "annotations")
        hdir = os.path.join(root, "msvd_qa", "processed")
        os.makedirs(adir)
        os.makedirs(hdir)
        with open(os.path.join(adir, "qa_train.json"), "w") as f:
            json.dump([{"question": f"{TASK_WORDS[q % 5]} is the "
                                    f"{TASK_SUBJECTS[q % 4]} doing in "
                                    f"video {v}",
                        "answer": "running", "video": f"{vid}.avi",
                        "answer_type": TASK_WORDS[q % 5]}
                       for vid, v in vidmap.items()
                       for q in range(spec["questions"])], f)
        with open(os.path.join(hdir, "vidmapping.json"), "w") as f:
            json.dump(vidmap, f)
        git_vocab = _wordpiece_dir(os.path.join(root, "git_vocab"),
                                   GIT_VOCAB, words)
        bert_vocab = _wordpiece_dir(os.path.join(root, "bert_vocab"),
                                    BERT_CASED_VOCAB, words)
        bert_ckpt, _, _ = write_hf_checkpoint(
            os.path.join(root, "bert"),
            hf_bert_classifier_shapes(BERTConfig()), seed=6)
        base = ["--dataset_root", root]
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        gs.main(base + ["--task", "gen_cap", "--tokenizer_dir", git_vocab],
                open_store=lambda path: store)
        torch.cuda.synchronize()
        cap_s = time.perf_counter() - t0
        inds = base + ["--task", "gen_inds", "--tokenizer_dir", bert_vocab,
                       "--weights", bert_ckpt]
        t0 = time.perf_counter()
        gs.main(inds)
        torch.cuda.synchronize()
        inds_s = time.perf_counter() - t0
        launches = launches_made()
        with open(os.path.join(adir, "frame_captions.json")) as f:
            caps = json.load(f)
        with open(os.path.join(adir, "qa_winds_train.json")) as f:
            winds = json.load(f)
        args = gs.build_argparser().parse_args(inds)
        args.device = torch.device("cpu")
        tok = gs._tokenizer(args)
        cpu_scorer = gs.build_scorer(args, max(tok.vocab.values()) + 1)
    card_scorer = copy.deepcopy(cpu_scorer).cuda()

    def scorer(model):
        dev = next(model.parameters()).device

        @torch.inference_mode()
        def score(ids, mask, types):
            return model(ids.to(dev), mask.to(dev), types.to(dev))
        return score

    errs = []
    for sample in winds[:2]:
        row_caps = caps[str(vidmap[sample["video"].split(".")[0]])]
        got, want = (score_question_captions(scorer(m), tok,
                                             sample["question"], row_caps)
                     for m in (card_scorer, cpu_scorer))
        errs.append(float(np.abs(got - want).max()
                          / max(np.abs(want).max(), 1e-6)))
    n_pairs = len(winds) * spec["frames"]
    n_caps = sum(len(c) for c in caps.values())
    row = {"phase": "stage_b", "captions": n_caps, "gen_cap_s": cap_s,
           "captions_per_s": n_caps / cap_s, "qa_pairs": n_pairs,
           "gen_inds_s": inds_s, "qa_pairs_per_s": n_pairs / inds_s,
           "caption_example": caps["0"][0],
           "distinct_captions": len({c for v in caps.values() for c in v}),
           "scorer_rel_err_vs_cpu": errs, "tol": TOL_F32_DEEP,
           "launches": launches}
    emit(row)
    check(sorted(caps, key=int) == [str(v) for v in range(spec["videos"])]
          and all(len(c) == spec["frames"] and all(isinstance(x, str)
                                                   for x in c)
                  for c in caps.values())
          and len(winds) == spec["videos"] * spec["questions"]
          and all(sorted(s["sampled_inds"]) == list(range(spec["frames"]))
                  for s in winds),
          f"stage_b: malformed outputs: {row}")
    check(max(errs) <= TOL_F32_DEEP,
          f"stage_b: the scorer on the card disagrees with the CPU: {errs}")
    del card_scorer, cpu_scorer
    torch.cuda.empty_cache()
    return row, launches


def _cli_inputs():
    """(decode route or None, frame (H, W)) on this machine, each printed
    on its own line when the full form cannot run."""
    import importlib.util

    from sasvqa_torch.data import video_decode as vd
    if vd.native_available():
        route = "native shim"
    elif importlib.util.find_spec("cv2") is not None:
        route = ("cv2 fallback (the native shim did not load: "
                 f"{vd._load_lib()[1]})")
    else:
        route = None
        print("predict, serve_cli: neither the native shim nor cv2 loads: "
              "the CLIs' main() cannot decode a video, so both phases "
              "answer from frames in memory instead", flush=True)
    hw = (CLI["height"], CLI["width"])
    if importlib.util.find_spec("PIL") is None:
        hw = (CLI["img"], CLI["img"])
        print("predict, serve_cli: PIL is not installed: the videos are "
              f"{hw[0]}x{hw[1]}, which needs no resize", flush=True)
    return route, hw


def _cli_video(path, n, hw, seed):
    """A raw AVI of ``n`` seeded frames (tests/_torch_video.py's writer);
    returns (path, the frames)."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    from _torch_video import write_raw_avi
    frames = np.random.default_rng(seed).integers(
        0, 256, (n,) + hw + (3,), dtype=np.uint8)
    return write_raw_avi(path, frames), frames


def _cli_frames(frames_u8, k):
    """What the CLIs' decode makes of written frames: the resize and
    crop, ``k`` frames at uniform centres, normalised."""
    from sasvqa_torch.tools import extract_frames as ef
    sel = ef.geometry_frames(frames_u8, CLI["img"])
    return ef.normalize_frames(sel[ef._uniform_centers(len(sel), k)])


def phase_predict(root, route, hw):
    """``tasks/predict.main`` on one video (GIT-base, seeded weights,
    nframe 6): K1 in its prompt fill; then the same model's answer from
    the frames decoded again, its prompt-fill logits on the K1 route
    against the plain route's."""
    from sasvqa_torch.tasks import predict as pr
    path, raw = _cli_video(os.path.join(root, "predict.avi"),
                           CLI["predict_frames"], hw, CLI["seed"])
    argv = ["--video", path, "--question", CLI["question"], "--model",
            CLI["model"]]
    args = pr.build_argparser().parse_args(argv)
    frames = _cli_frames(raw, CLI["nframe"])[None]
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    if route is not None:
        answer = pr.main(argv)
    else:
        family, model, tok = pr.load_model(args, None, "cuda")
        answer = pr.answer_from_frames(model, family, tok, frames,
                                       CLI["question"], device="cuda")[
            "answer"]
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = launches_made()
    t0 = time.perf_counter()
    family, model, tok = pr.load_model(args, None, "cuda")
    build_s = time.perf_counter() - t0
    if route is not None:
        t0 = time.perf_counter()
        decoded = pr.load_frames(path, CLI["nframe"], CLI["img"])
        decode_s = time.perf_counter() - t0
        check(np.array_equal(decoded, frames),
              "predict: decoded frames differ from the written ones")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pr.answer_from_frames(model, family, tok, frames, CLI["question"],
                                device="cuda")
    torch.cuda.synchronize()
    answer_s = time.perf_counter() - t0
    ids = ([tok.cls_token_id]
           + tok.encode(CLI["question"], add_special_tokens=False))
    px = torch.from_numpy(frames).cuda()
    logits = {}
    with torch.inference_mode():
        for flash in (None, False):
            model.flash = flash
            logits[flash], _ = model.prompt_fill(
                torch.tensor([ids], device="cuda"),
                torch.tensor([len(ids)], device="cuda"), px,
                args.max_length)
    model.flash = None
    rel = ((logits[None] - logits[False]).abs().max()
           / logits[False].abs().max()).item()
    row = {"phase": "predict", "decode": route or "frames in memory",
           "video": list(hw), "wall_s": wall_s, "model_build_s": build_s,
           "decode_s": decode_s if route is not None else None,
           "answer_s": answer_s, "answer": answer,
           "generated_tokens": int((out["ids"] != 0).sum()),
           "prompt_len": len(ids), "logits_rel_err_vs_plain": rel,
           "tol": TOL_LOGITS_REL, "launches": launches}
    emit(row)
    check(isinstance(answer, str) and out["answer"] == answer
          and rel <= TOL_LOGITS_REL
          and launches["git_flash_fwd"] == model.config.num_layers,
          f"predict: {row}")
    del model
    torch.cuda.empty_cache()
    return row, launches


def phase_serve_cli(root, route, hw):
    """``tasks/serve.main`` over a JSONL file of 8 requests (GIT-base,
    seeded weights, the CLI's defaults): one answer line a request, in
    order, K1 in every batch's prompt fill."""
    from sasvqa_torch.tasks import serve as sv
    reqs = []
    for i in range(CLI["requests"]):
        path, raw = _cli_video(os.path.join(root, f"serve{i}.avi"),
                               CLI["serve_frames"], hw, CLI["seed"] + 1 + i)
        reqs.append({"video": path, "question":
                     f"{TASK_WORDS[i % 5]} is the {TASK_SUBJECTS[i % 4]} "
                     f"doing", "frames": raw})
    req_path = os.path.join(root, "requests.jsonl")
    out_path = os.path.join(root, "answers.jsonl")
    with open(req_path, "w") as f:
        for r in reqs:
            f.write(json.dumps({"video": r["video"],
                                "question": r["question"]}) + "\n")
    argv = ["--requests", req_path, "--out", out_path, "--model",
            CLI["model"]]
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    if route is not None:
        rc = sv.main(argv)
    else:
        from sasvqa_torch.tasks.predict import load_model
        args = sv.build_argparser().parse_args(argv)
        family, model, tok = load_model(args, None, "cuda")
        with sv.QAEngine(model, family, tok, nframe=CLI["nframe"],
                         batch_size=CLI["batch_size"], pixel_dtype="u8",
                         device="cuda") as engine, \
                open(out_path, "w") as out:
            sv.serve_requests(
                engine, reqs, lambda r: _cli_frames(r["frames"], 16), out,
                batch_size=CLI["batch_size"])
        rc = 0
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = launches_made()
    with open(out_path) as f:
        lines = [json.loads(line) for line in f]
    row = {"phase": "serve_cli", "decode": route or "frames in memory",
           "video": list(hw), "requests": len(reqs), "wall_s": wall_s,
           "engine_batches": launches["git_flash_fwd"] // 6,
           "answers": [x["answer"] for x in lines], "launches": launches}
    emit(row)
    check(rc == 0 and [x["question"] for x in lines]
          == [r["question"] for r in reqs]
          and all(isinstance(x["answer"], str) for x in lines)
          and launches["git_flash_fwd"] > 0
          and launches["git_flash_fwd"] % 6 == 0,
          f"serve_cli: {row}")
    torch.cuda.empty_cache()
    return row, launches


# ---- retrieval, the remat-policy sweep, profile_step, quickstart ----------

# the retrieval task on configs/msvd_qa_base3.json's CLIP ViT-B/16 (its
# nframe 4 and score_agg_func lse), the projected towers loaded from the
# seeded HF CLIPModel checkpoint: 256 videos of 4 stored frames of
# 224x224 (0.62 GB of f32 frames, every stored frame encoded), one
# caption a video, chunks of val_batch_size 64
RETRIEVAL = dict(videos=256, questions=1, stored_frames=4, img=224, val=256,
                 test=16, overrides={"val_batch_size": 64,
                                     "max_txt_len": 20})
# the sweep at profile_config's vitl16 shape (GIT with ViT-L/14, B=8, 16
# frames, S = 4144, both dropouts 0.1: K1, K2 and K4): one warm-up update,
# whose loss and gradients are held against full recompute's, then this
# many timed updates
SWEEP_UPDATES = 2
# no remat does not fit at B 8 on the card's 80 GB (77.6 GB allocated when
# a 0.5 GB attention buffer failed, chip_smoke's first run of the sweep):
# it runs at B 4, held against full recompute at B 4
NO_REMAT_BATCH = 4
# two f32 cosine scores of 512-term dot products (unit vectors) differ
# from their f64 values by at most 512 * 2^-24 = 2^-15 each: ranks from
# the device's f32 scores and from f64 may part only where the true video
# and a competitor lie that close
TOL_RANK_TIE = 2.0 ** -15
PROFILE_STEP_ITERS = 3


def phase_retrieval(ckpt):
    """``run_retrieval.main(argv, open_store=...)`` at full width: the
    towers built by the task, every converted leaf of the checkpoint
    checked in them after the load, the encode and the scoring timed
    (wrapped, nothing else changed), and the returned metrics held equal
    to ranks recomputed in f64 numpy from the returned embeddings."""
    from sasvqa_torch.tasks import run_retrieval as rr
    from sasvqa_torch.train.retrieval import retrieval_metrics
    t_setup = time.perf_counter()
    store = _memory_store(RETRIEVAL)
    towers, reports, embeds, encode_s, score_s, sims = [], [], [], [], [], []
    real = {name: getattr(rr, name) for name in
            ("build_towers", "merge_pretrained", "encode_corpus",
             "clip_score_matrix")}

    def build_towers(*a, **kw):
        towers.extend(real["build_towers"](*a, **kw))
        return tuple(towers)

    def merge(*a, **kw):
        reports.append(real["merge_pretrained"](*a, **kw))
        return reports[-1]

    def timed(name, out, keep=None):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = real[name](*a, **kw)
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
            if keep is not None:
                keep.append(res)
            return res
        return run

    with tempfile.TemporaryDirectory() as root:
        cfg = _base3_cfg(root, RETRIEVAL)
        cfg["model"]["pretrained_weights"] = ckpt["dir"]
        cfg["tokenizer_dir"] = _clip_tokenizer(cfg, root)
        path = os.path.join(root, "cfg.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        setup_s = time.perf_counter() - t_setup
        for name, fn in (("build_towers", build_towers),
                         ("merge_pretrained", merge),
                         ("encode_corpus", timed("encode_corpus", encode_s,
                                                 embeds)),
                         ("clip_score_matrix", timed("clip_score_matrix",
                                                     score_s, sims))):
            setattr(rr, name, fn)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            metrics = rr.main(["--config", path],
                              open_store=lambda p: store)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = launches_made()
        finally:
            for name, fn in real.items():
                setattr(rr, name, fn)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    emb = embeds[0]
    # the scoring again on the same embeddings: its time past first use
    again = [cuda_ms(lambda: rr.clip_score_matrix(
        emb["text"], emb["video"], "lse", "cuda"), reps=5)]
    txt_tower, vis_tower = towers
    checks = [check_loaded(txt_tower, cv.convert_clip_text(
                  ckpt["sd"], ckpt["tc"].num_layers)),
              check_loaded(vis_tower, cv.convert_clip_vision(
                  ckpt["sd"], ckpt["vc"].num_layers))]
    n_params = [len(list(t.parameters())) for t in towers]
    txt = emb["text"].astype(np.float64)
    vid = emb["video"].astype(np.float64)
    txt /= np.linalg.norm(txt, axis=-1, keepdims=True)
    vid /= np.linalg.norm(vid, axis=-1, keepdims=True)
    sim = np.einsum("td,vfd->tvf", txt, vid)
    top = sim.max(axis=-1, keepdims=True)
    lse = (top + np.log(np.exp(sim - top).sum(axis=-1, keepdims=True)))[..., 0]
    f64_metrics = retrieval_metrics(lse)
    n = RETRIEVAL["videos"]
    # per query: its rank under the device's f32 scores and under f64;
    # where they part, the nearest competitor of the true video in f64
    rank32, rank64 = (np.argsort(np.argsort(-x, axis=1), axis=1)[
        np.arange(n), np.arange(n)] for x in (sims[0], lse))
    parted = np.nonzero(rank32 != rank64)[0]
    competitor = np.abs(lse - lse[np.arange(n), np.arange(n)][:, None])
    competitor[np.arange(n), np.arange(n)] = np.inf
    gaps = competitor[parted].min(axis=1) if len(parted) else np.zeros(0)
    row = {"phase": "retrieval", "model": cfg["model"]["pretrained_model"],
           "videos": n, "frames": RETRIEVAL["stored_frames"],
           "img": RETRIEVAL["img"],
           "val_batch_size": cfg["val_batch_size"],
           "score_agg_func": cfg["score_agg_func"], "setup_s": setup_s,
           "wall_s": wall_s, "encode_s": encode_s[0],
           "encode_videos_per_s": n / encode_s[0],
           "similarity_ms": score_s[0] * 1e3,
           "similarity_ms_again": again[0],
           "max_memory_allocated_gb": peak_gb,
           "frames_gb": store.frames.nbytes / 1e9,
           "loaded": [len(r["loaded"]) for r in reports],
           "missing_in_ckpt": [r["missing_in_ckpt"] for r in reports],
           "mismatched": [r["mismatched"] for r in reports],
           "leaves_checked": [c[0] for c in checks],
           "leaves_differing": [c[1] for c in checks],
           "parameters": n_params, "embed_shapes": {
               k: list(v.shape) for k, v in emb.items()},
           "metrics": metrics, "metrics_f64": f64_metrics,
           "queries_ranked_apart_f32_f64": len(parted),
           "nearest_competitor_gap_of_those": gaps.tolist(),
           "tol_rank_tie": TOL_RANK_TIE, "launches": launches}
    emit(row)
    check(len(reports) == 2 and not any(row["mismatched"])
          and not any(row["missing_in_ckpt"])
          and row["loaded"] == row["leaves_checked"] == n_params
          and not any(row["leaves_differing"]),
          f"retrieval: the loaded towers are not the checkpoint's: {row}")
    check(emb["text"].shape == (n, ckpt["vc"].projection_dim)
          and emb["video"].shape == (n, RETRIEVAL["stored_frames"],
                                     ckpt["vc"].projection_dim)
          and np.isfinite(emb["text"]).all()
          and np.isfinite(emb["video"]).all(),
          f"retrieval: embeddings {row['embed_shapes']}")
    check(metrics == retrieval_metrics(sims[0])
          and (metrics == f64_metrics) == (len(parted) == 0)
          and all(g <= TOL_RANK_TIE for g in gaps),
          f"retrieval: metrics {metrics} vs f64 ranks {f64_metrics}, "
          f"queries ranked apart {parted.tolist()} at gaps {gaps.tolist()}")
    del towers, store
    torch.cuda.empty_cache()
    return row, launches


def _sweep_policy(label, shape, ref):
    """One policy of the sweep through ``profile_config.remat_row``: its
    row (ms an update after the warm-up one, peak GB, launches), with the
    warm-up update's loss and gradients held against ``ref``, full
    recompute's, when given."""
    grads = {}

    def keep(model):
        grads.update((n, p.grad.float().cpu())
                     for n, p in model.named_parameters())

    row = pc.remat_row(label, shape, SWEEP_UPDATES, torch.device("cuda"),
                       warmed=keep)
    check("error" not in row, f"remat sweep {label}: {row}")
    loss = row["first_loss"]
    if ref is not None:
        rel = {n: ((g - ref["grads"][n]).norm()
                   / ref["grads"][n].norm().clamp(min=1e-20)).item()
               for n, g in grads.items()}
        worst = max(rel, key=rel.get)
        row.update(loss_rel_err=abs(loss - ref["loss"]) / abs(ref["loss"]),
                   grad_rel_err_max=rel[worst], grad_rel_err_worst=worst)
    return row, {"loss": loss, "grads": grads}


def phase_remat_sweep():
    """The vision tower's remat policies at vitl16 through the training
    update (``make_git_train_step``, dropout on): full recompute, the two
    dot-saving named policies, and no remat (at B 4, with full recompute
    at B 4 as its reference), each from the same seeded weights, batch
    and dropout draws.  Each row: ms an update (2 timed updates after the
    warm-up one), peak GB, K1/K2/K4 launches, and the warm-up update's
    loss and gradients against full recompute's at its batch (the gate
    of the vitl16 remat check).  Also returns the (B, H, num_img, L, Dh)
    of every K1 and K2 call, so that each is held against its plain
    version."""
    shape = pc.VITL16
    _build.reset_launch_counts()
    rows, refs = [], {}
    runs = [(label, remat, policy, shape.batch)
            for label, remat, policy in pc.REMAT_SWEEP if remat]
    runs += [("full_recompute", True, None, NO_REMAT_BATCH),
             ("no_remat", False, None, NO_REMAT_BATCH)]
    with GitFlashShapes() as rec:
        for label, remat, policy, batch in runs:
            s = dataclasses.replace(shape, remat=remat, remat_policy=policy,
                                    batch=batch)
            row, out = _sweep_policy(label, s, refs.get(batch))
            if label == "full_recompute":
                refs[batch] = out
                row["reference_of"] = ("the named policies" if batch ==
                                       shape.batch else "no remat")
            if label == "no_remat":
                row["why_this_batch"] = (
                    f"does not fit at B {shape.batch} on 80 GB; held "
                    f"against full recompute at B {batch}")
            rows.append(row)
            del out
    launches = launches_made()
    result = {"phase": "remat_sweep", "model": shape.model,
              "frames": shape.frames, "seq_len": shape.seq,
              "text_len": shape.text_len, "policies": rows,
              "tol_loss_rel": TOL_LOSS_REL,
              "tol_grad_rel": TOL_PARAM_GRAD_REL, "launches": launches,
              "git_flash_shapes": {p: sorted(v)
                                   for p, v in rec.shapes.items()}}
    emit(result)
    n_layers = shape.git.num_layers
    updates = 1 + SWEEP_UPDATES
    for r in rows:
        check(np.isfinite(r["first_loss"]) and np.isfinite(r["ms"]),
              f"remat sweep {r['policy']}: {r}")
        check(all(r["launches"].get(k, 0) == n_layers * updates
                  for k in ("git_flash_fwd",) + bwd_kernels())
              and r["launches"].get(_build.HASH_DROPOUT, 0) > 0,
              f"remat sweep {r['policy']}: K1/K2/K4 launches {r['launches']}")
        if "loss_rel_err" in r:
            check(r["loss_rel_err"] <= TOL_LOSS_REL
                  and r["grad_rel_err_max"] <= TOL_PARAM_GRAD_REL,
                  f"remat sweep {r['policy']}: against full recompute {r}")
    del refs
    torch.cuda.empty_cache()
    return result, launches, rec.shapes


def phase_profile_step():
    """``profile_step``'s flagship probes (GIT-base, B=16, 8 frames,
    S = 1608) through ``profile_step.run``, a few iterations each.  Also
    returns the (B, H, num_img, L, Dh) of every K1 and K2 call, so that
    each is held against its plain version."""
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with GitFlashShapes() as rec:
        rows = ps.run(ps.FLAGSHIP, tuple(ps.PROBES), PROFILE_STEP_ITERS,
                      "cuda")
    wall_s = time.perf_counter() - t0
    launches = launches_made()
    row = {"phase": "profile_step", "shape": dataclasses.asdict(ps.FLAGSHIP),
           "seq_len": ps.FLAGSHIP.seq, "iters": PROFILE_STEP_ITERS,
           "wall_s": wall_s, "probes": rows, "launches": launches,
           "git_flash_shapes": {p: sorted(v) for p, v in rec.shapes.items()}}
    emit(row)
    check([r["probe"] for r in rows] == list(ps.PROBES)
          and all(np.isfinite(r["ms"]) and r["ms"] > 0 for r in rows),
          f"profile_step: {rows}")
    torch.cuda.empty_cache()
    return row, launches, rec.shapes


def phase_quickstart():
    """``quickstart --family git`` on the card, its synthetic store built
    and read through the writer and store seams (no h5py there)."""
    from sasvqa_torch.tools import quickstart as qs
    stores = MemoryFrameStores()
    with tempfile.TemporaryDirectory() as root:
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        result = qs.main(["--family", "git", "--root", root],
                         writer=stores.writer, open_store=stores.open_store)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = launches_made()
        with open(os.path.join(root, "out", "log", "scalars.jsonl")) as f:
            tags = sorted({json.loads(line)["tag"] for line in f})
        with open(os.path.join(root, "cfg.json")) as f:
            platform = json.load(f)["platform"]
    row = {"phase": "quickstart", "family": "git", "wall_s": wall_s,
           "platform_in_config": platform,
           "train_loss": result["train_loss"],
           "global_step": result["global_step"], "val": result["val"],
           "stores": sorted(os.path.basename(p) for p in stores.rows),
           "scalar_tags": tags, "launches": launches}
    emit(row)
    check(np.isfinite(result["train_loss"]) and result["global_step"] > 0
          and "train/loss" in tags and "overall_acc" in result["val"]
          and platform is None,
          f"quickstart: {row}")
    return row, launches


def predict_prompt_len():
    """The prompt length predict gives CLI['question'] ([CLS] and its
    tokens, within the default budget of 50 - 8)."""
    tok = make_test_wordpiece()
    n = 1 + len(tok.encode(CLI["question"], add_special_tokens=False))
    return min(n, 42)


# multi-process training on one card: GIT-base on configs/msvd_qa_base.json
# at nframe 8 over 64 stored frames ('uniform' takes every 8th: 8 frames,
# S = 8 * 197 + 32 = 1608, so the loop takes K1, K2 and K4), 24 videos of
# 2 questions, train_batch_size 8 and 2 accumulated micros (3 updates in
# one epoch), then one validation of 8 val and 8 test questions at
# val_batch_size 8; run without a process group, then in a 1-rank NCCL
# group on each mesh below; the last update of each run is profiled
DIST_TASK = dict(videos=24, questions=2, stored_frames=64, img=224, val=8,
                 test=8, overrides={
                     "nframe": 8, "samp_policy": "uniform",
                     "max_seq_len": 32, "max_txt_len": 20,
                     "max_n_example_per_group": 1, "train_batch_size": 8,
                     "gradient_accumulation_steps": 2, "val_batch_size": 8,
                     "num_train_epochs": 1, "num_valid": 1,
                     "min_valid_steps": 100, "learning_rate": 2e-4,
                     "gen_max_new_tokens": 10, "seed": 0})
DIST_MESHES = {"no_group": {}, "data": {"mesh_axes": ["data"]},
               "fsdp": {"mesh_shape": [1, 1],
                        "mesh_axes": ["data", "fsdp"]}}
DIST_UPDATES = 3


def _collectives(prof):
    """A profiled update's device ms: all of it (the device's records),
    the device work under the process group's ops (``nccl:*`` ranges:
    kernels and copies) and the NCCL kernels themselves, with the
    collectives by name."""
    rows = prof.key_averages()
    device = [e for e in rows
              if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = {e.key: {"calls": e.count, "device_ms": e.device_time_total / 1e3}
           for e in rows if e.key.startswith("nccl:")}
    kernels = [e for e in device if e.key.startswith("nccl")]
    return {"device_ms": sum(e.self_device_time_total for e in device) / 1e3,
            "collective_device_ms": sum(o["device_ms"]
                                        for o in ops.values()),
            "nccl_kernel_ms": sum(e.self_device_time_total
                                  for e in kernels) / 1e3,
            "nccl_kernels": sum(e.count for e in kernels),
            "collectives": ops}


def phase_dist_task_loop():
    """``start_training`` on configs/msvd_qa_base.json (GIT-base at full
    width, seeded weights, dropout on) without a process group, then in a
    real 1-rank NCCL group on the data route and on the FSDP2 route: each
    update's loss within TOL_LOSS_REL of the run without a group, the
    same global step, finite scores, the FSDP run's snapshot the same
    keys and shapes as the first run's and loaded into a fresh model.
    The counts of K1/K2/K4 are summed over the three runs.  Also returns
    the (B, H, num_img, L, Dh) of every K1 and K2 call."""
    import socket
    import torch.distributed as dist

    from sasvqa_torch.parallel import mesh as pmesh
    t_setup = time.perf_counter()
    store = _memory_store(DIST_TASK)
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs", "msvd_qa_base.json")) as f:
        base = json.load(f)
    base["model"].pop("pretrained_weights")
    base.pop("tokenizer_dir")
    setup_s = time.perf_counter() - t_setup
    runs, launches = {}, {k: 0 for k in KERNELS}
    env = {}
    with tempfile.TemporaryDirectory() as root, GitFlashShapes() as rec, \
            contextlib.ExitStack() as group:
        for name, mesh in DIST_MESHES.items():
            if name != "no_group" and not pmesh.is_distributed():
                with socket.socket() as s:
                    s.bind(("localhost", 0))
                    port = s.getsockname()[1]
                env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                       "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
                os.environ.update(env)
                group.callback(lambda: [os.environ.pop(k, None)
                                        for k in env])
                check(pmesh.init_distributed(None)
                      and dist.get_backend() == "nccl",
                      "dist task loop: no NCCL process group")
                group.callback(dist.destroy_process_group)
            run_root = os.path.join(root, name)
            os.makedirs(run_root)
            cfg = dict(base, **DIST_TASK["overrides"], **mesh,
                       output_dir=os.path.join(run_root, "out"),
                       **_task_files(run_root, DIST_TASK))
            cfg["model"] = dict(base["model"])
            run = _timed_start_training(cfg, run_root, store,
                                        profile_call=DIST_UPDATES)
            snap = torch.load(os.path.join(
                cfg["output_dir"], "ckpt", f"model_step_{DIST_UPDATES}.pt"),
                map_location="cpu", weights_only=True)
            runs[name] = {
                "mesh": mesh, "route": {"no_group": None, "data": "data",
                                        "fsdp": "fsdp"}[name],
                "backend": dist.get_backend() if pmesh.is_distributed()
                else None,
                "updates": run["result"]["global_step"],
                "losses": run["losses"], "wall_s": run["wall_s"],
                "update_s": run["step_s"],
                # the first update warms up, the last is profiled
                "ms_per_update": run["step_s"][1] * 1e3,
                "validation_s": run["val_s"],
                "max_memory_allocated_gb": run["max_memory_allocated_gb"],
                "profiled_update": run["profile"],
                "val": run["result"]["val"], "test": run["result"]["test"],
                "launches": run["launches"],
                "snapshot": {k: list(v.shape) for k, v in snap.items()}}
            for k in KERNELS:
                launches[k] += run["launches"].get(k, 0)
            if name == "fsdp":
                fsdp_snap = snap
            del snap
            torch.cuda.empty_cache()
    anchor = runs["no_group"]
    fresh = _git_base(0)
    fresh.load_state_dict(fsdp_snap, strict=True)
    del fresh, fsdp_snap
    want = anchor["snapshot"]
    for r in runs.values():    # keys and shapes: compared, not printed
        got = r.pop("snapshot")
        r["snapshot_leaves"] = len(got)
        r["snapshot_same_as_no_group"] = got == want
    s_len = DIST_TASK["overrides"]["nframe"] * 197 + \
        DIST_TASK["overrides"]["max_seq_len"]
    row = {"phase": "dist_task_loop",
           "model": "git-base video QA, seeded random weights, dropout on",
           "config": "configs/msvd_qa_base.json + " + json.dumps(
               DIST_TASK["overrides"]),
           "seq_len": s_len, "setup_s": setup_s,
           "tol_loss_rel": TOL_LOSS_REL, "runs": runs,
           "loss_rel_err": {
               name: max(abs(a - b) / abs(b) for a, b in
                         zip(r["losses"], anchor["losses"]))
               for name, r in runs.items() if name != "no_group"},
           "launches": launches,
           "git_flash_shapes": {p: sorted(v) for p, v in rec.shapes.items()}}
    emit(row)
    for name, r in runs.items():
        check(r["updates"] == DIST_UPDATES
              and len(r["losses"]) == DIST_UPDATES
              and all(np.isfinite(r["losses"])),
              f"dist task loop {name}: not {DIST_UPDATES} finite losses: "
              f"{r['losses']}")
        check(all(np.isfinite(r[s]["overall_acc"]) for s in ("val", "test")),
              f"dist task loop {name}: scores {r['val']} {r['test']}")
        check(r["snapshot_same_as_no_group"],
              f"dist task loop {name}: snapshot keys or shapes differ")
        if name != "no_group":
            check(r["backend"] == "nccl"
                  and row["loss_rel_err"][name] <= TOL_LOSS_REL,
                  f"dist task loop {name}: losses {r['losses']} against "
                  f"{anchor['losses']}")
    check(all(launches[k] > 0 for k in
              ("git_flash_fwd", _build.HASH_DROPOUT) + bwd_kernels()),
          f"dist task loop: a kernel of its route was not launched: "
          f"{launches}")
    return row, launches, rec.shapes


# the production-shape integrated run (tools/integrated_run.py) at full
# width: configs/msvd_qa_base.json as shipped (GIT-base, dropout 0.1, the
# uniform policy at stride 1 over a K = 6 store of 224x224 frames: 6
# frames a question, S = 6 * 197 + 32 = 1214, so K1, K2 and K4; 6
# questions a micro, validation batches of 16, prompts padded to 20, bf16
# staging) cut in depth only: 64 videos, 4 micros an update instead of 72
# (a global batch of 24), 720 train questions (one epoch of 30 updates:
# step marks at 10, 20, 30, the in-loop validation at 20), 32 val and 32
# test questions; save_steps_ratio keeps the full run's cadence of a
# restore checkpoint every 17 updates (0.01 x 72 updates x 72 micros = 51
# micros; an update's micro count 72 n is a multiple of 51 at every 17th
# update; here 0.57 x 30 x 4 = 68 micros, every 17th update of 4)
INTEGRATED = dict(num_videos=64, train_q=720, val_q=64, val_limit=32,
                  steps=30, accum=4, save_steps_ratio=0.57)
INTEGRATED_TRAIN_SHAPE = (6, 12, 6 * 197, 32, 64)
INTEGRATED_EVAL_SHAPE = (16, 12, 6 * 197, 20, 64)


def phase_integrated_run():
    """``tools/integrated_run.main`` on the card, its store built and read
    in host memory (``MemoryFrameStores``: no h5py there), over the
    shipped config with INTEGRATED's cuts: every report key, finite
    losses, the global step its epoch gives, val/test counts of
    ``--val_limit``, snapshots and restore files written, a positive
    steady window.  Also returns the (B, H, num_img, L, Dh) of every K1
    and K2 call."""
    import math

    from sasvqa_torch.tools import integrated_run as ir
    spec = INTEGRATED
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           ir.CONFIG)) as f:
        cfg = json.load(f)
    cuts = {"gradient_accumulation_steps": [
        cfg["gradient_accumulation_steps"], spec["accum"]],
        "save_steps_ratio": [cfg.get("save_steps_ratio", 0.01),
                             spec["save_steps_ratio"]]}
    cfg["gradient_accumulation_steps"] = spec["accum"]
    cfg["save_steps_ratio"] = spec["save_steps_ratio"]
    global_batch = cfg["train_batch_size"] * spec["accum"]
    epochs = max(1, math.ceil(spec["steps"] * global_batch
                              / spec["train_q"]))
    updates = math.ceil(epochs * spec["train_q"] / global_batch)
    stores = MemoryFrameStores()
    real_config = ir.CONFIG
    with tempfile.TemporaryDirectory() as root, GitFlashShapes() as rec:
        ir.CONFIG = os.path.join(root, "msvd_qa_base.json")
        with open(ir.CONFIG, "w") as f:
            json.dump(cfg, f)
        argv = ["--steps", str(spec["steps"]), "--root",
                os.path.join(root, "store"), "--out",
                os.path.join(root, "out"), "--num_videos",
                str(spec["num_videos"]), "--train_q", str(spec["train_q"]),
                "--val_q", str(spec["val_q"]), "--val_limit",
                str(spec["val_limit"])]
        _build.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            report = ir.main(argv, writer=stores.writer,
                             open_store=stores.open_store)
        finally:
            ir.CONFIG = real_config
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = launches_made()
        run = os.path.join(root, "out", "run")
        with open(os.path.join(run, "log", "log.txt")) as f:
            _, evals = ir.read_log(f)
        with open(os.path.join(run, "log", "scalars.jsonl")) as f:
            losses = [r["value"] for r in map(json.loads, f)
                      if r["tag"] == "train/loss"]
        ckpt = sorted(os.listdir(os.path.join(run, "ckpt")))
        restore = sorted(os.listdir(os.path.join(run, "restore")))
    keys = {"config", "global_steps", "global_batch_qa", "wall_s",
            "train_loss", "steady_steps_per_s", "steady_qa_pairs_per_s",
            "steady_ms_per_micro", "first_window_s"}
    tags = ("valid", "test", "final_valid", "final_test")
    keys |= {f"eval_{t}_{k}" for t in tags for k in ("s", "qa_per_s")}
    row = {"phase": "integrated_run",
           "model": "git-base video QA, seeded random weights, dropout on",
           "config": "configs/msvd_qa_base.json", "argv": argv,
           "cuts": dict(cuts, num_videos=[1970, spec["num_videos"]],
                        train_q=[30933, spec["train_q"]],
                        val_q=[6415, spec["val_q"]],
                        val_limit=[0, spec["val_limit"]]),
           "seq_len": 6 * 197 + 32,
           "report": report, "phase_wall_s": wall_s, "losses": losses,
           "evals": evals, "ckpt": ckpt, "restore": restore,
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": launches,
           "git_flash_shapes": {p: sorted(v) for p, v in rec.shapes.items()}}
    emit(row)
    check(set(report) == keys, f"integrated run: report keys "
          f"{sorted(report)}, want {sorted(keys)}")
    check(report["global_steps"] == updates == len(losses)
          and report["global_batch_qa"] == global_batch
          and all(np.isfinite(losses + [report["train_loss"]])),
          f"integrated run: not {updates} finite losses: {row}")
    check([(t, n) for t, n, _ in evals]
          == [(t, spec["val_limit"]) for t in tags],
          f"integrated run: eval counts {evals}")
    check(bool(ckpt) and bool(restore) and report["steady_steps_per_s"] > 0,
          f"integrated run: snapshots {ckpt}, restore {restore}, report "
          f"{report}")
    check(all(launches[k] > 0 for k in
              ("git_flash_fwd", _build.HASH_DROPOUT) + bwd_kernels()),
          f"integrated run: a kernel of its route was not launched: "
          f"{launches}")
    return row, launches, rec.shapes


PATHS = ("git_serve", "git_train", "blip_serve", "blip_train",
         "vitl16_grad_check", "task_loop", "clip_task_loop",
         "blip_task_loop", "mc_blip_task_loop", "mc_clip_task_loop",
         "stage_a", "stage_b", "predict", "serve_cli", "retrieval",
         "remat_sweep", "profile_step", "quickstart", "integrated_run",
         "dist_task_loop")
LN_KERNELS = ("layer_norm_fwd", "layer_norm_bwd")
KERNELS = ("git_flash_fwd", "git_flash_bwd", "git_flash_bwd_dq",
           "git_flash_bwd_dkv", _build.HASH_DROPOUT, "flash_fwd",
           "flash_bwd_dq", "flash_bwd_dkv") + LN_KERNELS


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2

    smi = phase_device()
    ptxas = phase_build()
    b, fr, tpf = SLICE["batch_size"], SLICE["frames"], 197
    # GIT serving, a ragged 3-frame shape, predict's one video of 6 frames
    # with its prompt, the serve CLI's batch of 8 x 6 frames
    cli_img = CLI["nframe"] * tpf
    kernel_shapes = [(b, 12, fr * tpf, SLICE["max_txt_len"], 64),
                     (2, 12, 3 * tpf, 13, 64),
                     (1, 12, cli_img, predict_prompt_len(), 64),
                     (CLI["batch_size"], 12, cli_img, CLI["max_txt_len"], 64),
                     INTEGRATED_EVAL_SHAPE]
    kernel_rows = phase_kernel(kernel_shapes)
    rate = _git_config("git-base").attention_dropout
    # the training shape, a ragged 3-frame one, and the remat sweep's
    # vitl16 at B 4 (no remat and its full-recompute reference)
    dist = DIST_TASK["overrides"]
    train_shapes = [(TRAIN["batch_size"], 12, TRAIN["frames"] * tpf,
                     TRAIN["max_seq_len"], 64), (2, 12, 3 * tpf, 13, 64),
                    (NO_REMAT_BATCH, 12, pc.VITL16.num_img,
                     pc.VITL16.text_len, 64),
                    (dist["train_batch_size"], 12, dist["nframe"] * tpf,
                     dist["max_seq_len"], 64), INTEGRATED_TRAIN_SHAPE]
    train_rows = phase_train_kernels(train_shapes, rate)
    btok = 577
    flash_cases = {
        # BLIP-base vision self-attention: serving (64 frames) and
        # training (32 frames a micro)
        "blip_serve": (BLIP["batch_size"] * BLIP["frames"], 12, btok, btok,
                       None, False),
        "blip_train": (BLIP_TRAIN["batch_size"] * BLIP["frames"], 12, btok,
                       btok, None, True),
        # the classifier task loop on msvd_qa_base3.json: one frame a
        # question ('single' sampling), micros of 8 in training, batches
        # of 16 in validation
        "blip_task_loop_train": (8, 12, btok, btok, None, True),
        "blip_task_loop_val": (16, 12, btok, btok, None, False),
        # rectangular: text-length queries over 4 frames' tokens with key
        # padding, and the GIT combined mask as a 2-D bias (3 frames)
        "rect_row_bias": (8, 12, 520, 4 * btok, "row", True),
        "git_mask_2d_bias": (2, 12, 3 * tpf + 13, 3 * tpf + 13, "git_mask",
                             True)}
    flash_rows = phase_flash_kernels(flash_cases)
    ln_rows = phase_layer_norm(LN_CASES)
    phase_small_reference()
    slice_row, git_serve = phase_slice(SLICE["requests"], SLICE["seed"])
    phase_grad_check(SLICE["seed"])
    train_row, git_train = phase_train(TRAIN["seed"])
    blip_serve_row, blip_serve = phase_blip_serve(BLIP["requests"],
                                                  BLIP["seed"])
    for seed in (BLIP["seed"],) + BLIP_GRAD_EXTRA_SEEDS:
        phase_blip_grad_check(seed)
    blip_train_row, blip_train = phase_blip_train(BLIP_TRAIN["seed"])
    split_rows, crossover = phase_split_kernels(rate)
    vitl16_row, vitl16 = phase_vitl16_grad_check()
    task_row, task = phase_task_loop()
    with tempfile.TemporaryDirectory() as ckpt_root:
        ckpt = clip_checkpoint(ckpt_root)
        clip_row, clip_task = phase_clip_task_loop(ckpt)
        blip_task_row, blip_task, blip_task_shapes = phase_blip_task_loop()
        mc_blip_row, mc_blip, mc_blip_shapes = phase_mc_blip_task_loop()
        mc_clip_row, mc_clip = phase_mc_clip_task_loop(ckpt)
        _, retrieval = phase_retrieval(ckpt)
        del ckpt
    phase_loop_options()
    phase_git_load()
    _, stage_a = phase_stage_a()
    _, stage_b = phase_stage_b()
    route, hw = _cli_inputs()
    with tempfile.TemporaryDirectory() as cli_root:
        _, predict = phase_predict(cli_root, route, hw)
        _, serve_cli = phase_serve_cli(cli_root, route, hw)
    _, remat_sweep, sweep_shapes = phase_remat_sweep()
    _, profile_step, profile_shapes = phase_profile_step()
    _, quickstart = phase_quickstart()
    _, integrated, integrated_shapes = phase_integrated_run()
    # last: the only phase under a process group
    _, dist_task, dist_shapes = phase_dist_task_loop()
    # device-time windows taken, profiler steps taken again, lead records lost
    emit({"phase": "profiler", **PROFILER_STATS})

    by_path = {name: dict(zip(PATHS, (counts.get(name, 0) for counts in
                                      (git_serve, git_train, blip_serve,
                                       blip_train, vitl16, task, clip_task,
                                       blip_task, mc_blip, mc_clip, stage_a,
                                       stage_b, predict, serve_cli,
                                       retrieval, remat_sweep, profile_step,
                                       quickstart, integrated, dist_task))))
               for name in KERNELS}
    needed = {"git_serve": ("git_flash_fwd",),
              "git_train": ("git_flash_fwd", _build.HASH_DROPOUT)
              + bwd_kernels(),
              "blip_serve": ("flash_fwd",),
              "blip_train": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
              "vitl16_grad_check": ("git_flash_fwd", "git_flash_bwd_dq",
                                    "git_flash_bwd_dkv",
                                    _build.HASH_DROPOUT),
              "task_loop": ("git_flash_fwd", _build.HASH_DROPOUT)
              + bwd_kernels(),
              # CLIP ViT-B/16 at 224x224 has 197 tokens a frame, below the
              # flash route's 512: its path runs no kernel
              "clip_task_loop": (),
              "blip_task_loop": ("flash_fwd", "flash_bwd_dq",
                                 "flash_bwd_dkv"),
              "mc_blip_task_loop": ("flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv"),
              "mc_clip_task_loop": (),
              # the MDF tower and the captioner see 197 tokens a frame,
              # the scorer 64: below both flash routes
              "stage_a": (), "stage_b": (),
              "predict": ("git_flash_fwd",),
              "serve_cli": ("git_flash_fwd",),
              # CLIP ViT-B/16 towers: 197 tokens a frame, 20 a caption
              "retrieval": (),
              "remat_sweep": ("git_flash_fwd", _build.HASH_DROPOUT)
              + bwd_kernels(),
              "profile_step": ("git_flash_fwd", _build.HASH_DROPOUT)
              + bwd_kernels(),
              # tiny-git at 2 frames of 32x32: S far below 512
              "quickstart": (),
              "integrated_run": ("git_flash_fwd", _build.HASH_DROPOUT)
              + bwd_kernels(),
              "dist_task_loop": ("git_flash_fwd", _build.HASH_DROPOUT)
              + bwd_kernels()}
    # every model's LayerNorms take the kernels on the card (widths 512,
    # 768 and 1024)
    for path in ("git_serve", "blip_serve"):
        needed[path] += ("layer_norm_fwd",)
    for path in ("git_train", "blip_train", "task_loop", "clip_task_loop",
                 "blip_task_loop", "integrated_run"):
        needed[path] += LN_KERNELS
    check(all(by_path[k][path] > 0 for path, ks in needed.items()
              for k in ks),
          f"a kernel of a path was not launched: {by_path}")
    # every K5 and K6 shape of the BLIP task loops was held against its
    # plain version in the flash kernel phase
    held = {"fwd": {c[:5] for c in flash_cases.values()},
            "bwd": {c[:5] for c in flash_cases.values() if c[5]}}
    for name, shapes in (("blip task loop", blip_task_shapes),
                         ("mc blip task loop", mc_blip_shapes)):
        check(all(shapes[p] <= held[p] for p in held),
              f"{name}: a K5/K6 shape was not held against its plain "
              f"version: {shapes}, held {held}")
    # every K1 and K2 shape of the remat sweep and profile_step was held
    # against its plain version in the kernel phases (K1 alone at the
    # serving shapes; K1 and K2 at the training shapes and, on their
    # first rows, at SPLIT_SHAPES)
    split_held = {(b, h, n, l, 64)
                  for b, h, n, l, _ in SPLIT_SHAPES.values()}
    held = {"fwd": set(kernel_shapes) | set(train_shapes) | split_held,
            "bwd": set(train_shapes) | split_held}
    for name, shapes in (("remat sweep", sweep_shapes),
                         ("profile_step", profile_shapes),
                         ("dist task loop", dist_shapes),
                         ("integrated run", integrated_shapes)):
        check(all(shapes[p] and shapes[p] <= held[p] for p in held),
              f"{name}: a K1/K2 shape was not held against its plain "
              f"version: {shapes}, held {held}")

    serve, main_t = kernel_rows[0], train_rows[0]
    fwd, bwd0, bwd = main_t["fwd"], main_t["bwd_0.0"], main_t[f"bwd_{rate}"]
    ragged = train_rows[1]
    # K4: K1 plus the routed backward at the rate minus at rate 0, at the
    # training shape and at vitl16; the hash runs once a pair in K1 and K2,
    # twice in K3
    def split_row(case, r):
        return next(x for x in split_rows
                    if x["case"] == case and x["rate"] == r)

    fused = gf.FUSED_BWD

    def routed_bwd(case, r, key):
        k2_key = {"kernel_ms": "k2_ms", "device_ms": "k2_device_ms"}[key]
        return split_row(case, r)[k2_key if fused else key]

    hash_ms = ((fwd["kernel_ms"] - fwd["kernel_ms_rate0"])
               + (bwd["kernel_ms"] - bwd0["kernel_ms"] if fused else
                  routed_bwd("flagship", rate, "kernel_ms")
                  - routed_bwd("flagship", 0.0, "kernel_ms")))
    hash_device_ms = ((fwd["device_ms"] - fwd["device_ms_rate0"])
                      + (bwd["device_ms"] - bwd0["device_ms"]
                         if fused else
                         routed_bwd("flagship", rate, "device_ms")
                         - routed_bwd("flagship", 0.0, "device_ms")))
    hash_bound = roofline((2 if fused else 3) * HASH_OPS_PER_PAIR
                          * main_t["pairs"], 4, PEAK_SCALAR_OPS)
    hash_vitl16 = {
        "device_ms": (split_row("vitl16", rate)["fwd_device_ms"]
                      - split_row("vitl16", 0.0)["fwd_device_ms"]
                      + routed_bwd("vitl16", rate, "device_ms")
                      - routed_bwd("vitl16", 0.0, "device_ms")),
        "bound_ms": roofline((2 if fused else 3) * HASH_OPS_PER_PAIR
                             * split_row("vitl16", rate)["attended_pairs"],
                             4, PEAK_SCALAR_OPS)[0],
        "backward": "K2" if fused else "K3"}
    k2_v16, k2_v16_0 = split_row("vitl16", rate), split_row("vitl16", 0.0)
    grad_err = max(max(r["max_abs_err"].values())
                   for t in train_rows for r in (t["bwd_0.0"],
                                                 t[f"bwd_{rate}"]))
    k5_serve = flash_rows["blip_serve"]["fwd"]
    k5_train = flash_rows["blip_train"]["fwd"]
    k6 = flash_rows["blip_train"]["bwd"]
    k6_rows = [r["bwd"] for r in flash_rows.values() if "bwd" in r]

    def launches(name):
        return {"launches": sum(by_path[name].values()),
                "launches_by_path": by_path[name]}

    def timing(ms, device, bound_ms):
        """events and device ms with the bound's share of each"""
        return {"ms": ms, "device_ms": device, "bound_share": bound_ms / ms,
                "bound_share_device": bound_ms / device}

    def library(row):
        return {"library_ms": row["library_ms"],
                "library_events_ms": row["library_events_ms"],
                "library": row["library"],
                "library_kernels": row["library_kernels"],
                "factor_device": row["factor"]}

    k3 = next(r for r in split_rows
              if r["case"] == "vitl16" and r["rate"] == rate)
    k3_rate0 = next(r for r in split_rows
                    if r["case"] == "vitl16" and r["rate"] == 0.0)

    def k3_entry(part, name, what):
        return {"name": name, "route": "cuda",
                "source": "sasvqa_torch/ops/csrc/git_flash_bwd_split.cu",
                "replaces": what, **launches(name),
                "max_abs_err": max(r["max_abs_err_vs_plain"][p]
                                   for r in split_rows
                                   for p in (("dq",) if part == "dq"
                                             else ("dk", "dv"))),
                **timing(k3[f"{part}_ms"], k3[f"{part}_device_ms"],
                         k3["part_bound_ms"][part]),
                "plain_ms": k3["plain_ms"],
                "bound_ms": k3["part_bound_ms"][part],
                "bound_by": k3["part_bound_by"][part],
                **library(k3_rate0),
                "at": f"vitl16 shape (8, 12, 4144, 64), rate {rate}; plain "
                      f"time of the whole backward at 2 rows, library (SDPA) "
                      f"and factor of the whole backward at rate 0",
                "whole_backward": {
                    **timing(k3["kernel_ms"], k3["device_ms"],
                             k3["bound_ms"]),
                    "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
                    "k2_ms": k3["k2_ms"], "k2_device_ms": k3["k2_device_ms"],
                    "rate0": timing(k3_rate0["kernel_ms"],
                                    k3_rate0["device_ms"],
                                    k3_rate0["bound_ms"]),
                    "k2_device_ms_rate0": k3_rate0["k2_device_ms"]},
                "crossover_min_seq": crossover,
                "ptxas": ptxas.get("git_flash_bwd_split", {}), "card": smi}

    def k6_entry(part, name, what):
        return {"name": name, "route": "cuda",
                "source": "sasvqa_torch/ops/csrc/flash_bwd.cu",
                "replaces": what, **launches(name),
                "max_abs_err": max(r["max_abs_err"][p] for r in k6_rows
                                   for p in (("dq",) if part == "dq"
                                             else ("dk", "dv"))),
                **timing(k6[f"{part}_ms"], k6[f"{part}_device_ms"],
                         k6["bound_ms"][part]),
                "plain_ms": k6["plain_ms"],
                "bound_ms": k6["bound_ms"][part],
                "bound_by": k6["bound_by"][part],
                **library(k6),
                "at": "BLIP-base training shape (32, 12, 577, 64); plain and "
                      "library times and the factor are of the whole "
                      "backward",
                "whole_backward": {
                    **timing(k6["kernel_ms"], k6["device_ms"],
                             k6["bound_ms"]["bwd"]),
                    "bound_ms": k6["bound_ms"]["bwd"],
                    "bound_by": k6["bound_by"]["bwd"]},
                "ptxas": ptxas.get("flash_bwd", {}), "card": smi}

    def ln_entry(part):
        blip, git = ln_rows["blip_large"], ln_rows["git_base"]
        timed = ("kernel_ms", "device_ms", "bytes", "bound_ms",
                 "bound_share", "bound_share_device", "plain_ms",
                 "library_ms")
        return {"name": f"layer_norm_{part}", "route": "cuda",
                "source": "sasvqa_torch/ops/csrc/layer_norm.cu",
                "replaces": "none: flax.linen.LayerNorm in plain jnp "
                            "(sasvqa_tpu/models/layers.py), which XLA "
                            "fuses",
                **launches(f"layer_norm_{part}"),
                "elements_off": sum(r["y_elements_off"] + r["dx_elements_off"]
                                    for r in ln_rows.values()),
                "param_err_rel_abs_terms": max(
                    r["param_err_rel_abs_terms"] for r in ln_rows.values()),
                **{k: blip[part][k] for k in timed},
                "bound_by": "bytes",
                "library": "torch.nn.functional.layer_norm (bf16 "
                           "parameters)",
                "at": f"BLIP-large vision stream {blip['shape']} bf16, cold "
                      f"inputs; git_base at {git['shape']}",
                "git_base": {k: git[part][k] for k in timed},
                "ptxas": ptxas.get("layer_norm", {}), "card": smi}

    emit({"kernels": [{
        "name": "git_flash_fwd", "route": "cuda",
        "source": "sasvqa_torch/ops/csrc/git_flash_fwd.cu",
        "replaces": "sasvqa_tpu/ops/git_flash.py:237 (_fwd_kernel)",
        **launches("git_flash_fwd"),
        "max_abs_err": max([r["max_abs_err_o"] for r in kernel_rows]
                           + [t["fwd"]["max_abs_err_o"] for t in train_rows]
                           + [r["k1_max_abs_err_o_vs_plain"]
                              for r in split_rows]),
        **timing(fwd["kernel_ms"], fwd["device_ms"], fwd["bound_ms"]),
        "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
        "library_ms": fwd["library_ms"],
        "library_events_ms": fwd["library_events_ms"],
        "library_kernels": fwd["library_kernels"],
        "at": f"training shape, rate {rate}; library (SDPA forward, device "
              f"time) at rate 0",
        "tflops": fwd["tflops"],
        "ms_rate0": fwd["kernel_ms_rate0"], "rate0": fwd["rate0"],
        "device_ms_rate0": fwd["device_ms_rate0"],
        "serving": {"ms": serve["kernel_ms"], "device_ms": serve["device_ms"],
                    "plain_ms": serve["plain_ms"],
                    "bound_ms": serve["bound_ms"],
                    "library_ms": serve["library_ms"],
                    "tflops": serve["tflops"],
                    "bound_share": serve["bound_share"]},
        "ragged_ms": ragged["fwd"]["kernel_ms"],
        **{name: {key: r[key] for key in
                  ("shape", "kernel_ms", "device_ms", "plain_ms",
                   "bound_ms", "bound_by", "library_ms", "max_abs_err_o",
                   "bound_share")}
           for name, r in (("predict", kernel_rows[2]),
                           ("serve_cli", kernel_rows[3]))},
        "kernel_share_of_prompt_fill": (
            slice_row["launches"]["git_flash_fwd"] / slice_row["batches"]
            * serve["kernel_ms"] / slice_row["prompt_fill_ms"]),
        "ptxas": ptxas.get("git_flash_fwd", {}), "card": smi}, {
        "name": "git_flash_bwd", "route": "cuda",
        "source": "sasvqa_torch/ops/csrc/git_flash_bwd.cu",
        "replaces": "sasvqa_tpu/ops/git_flash.py:421 (_fused_bwd_kernel)",
        **launches("git_flash_bwd"),
        "max_abs_err": grad_err,
        **timing(bwd["kernel_ms"], bwd["device_ms"], bwd["bound_ms"]),
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"], "bound_by": bwd["bound_by"],
        **library(bwd0),
        "at": f"training shape, rate {rate}; library (SDPA) and factor at "
              f"rate 0",
        "ms_rate0": bwd0["kernel_ms"], "device_ms_rate0": bwd0["device_ms"],
        "bound_share_device_rate0": bwd0["bound_share_device"],
        "plain_ms_rate0": bwd0["plain_ms"],
        "dkv_bit_identical": all(r["dkv_bit_identical"] for r in
                                 [t[f"bwd_{x}"] for t in train_rows
                                  for x in (0.0, rate)]
                                 + [x["k2"] for x in split_rows]),
        "dq_rerun_rel_diff_max": max(
            [t[f"bwd_{x}"]["dq_rerun_rel_diff"] for t in train_rows
             for x in (0.0, rate)]
            + [x["k2"]["dq_rerun_rel_diff"] for x in split_rows]),
        "vitl16": {"max_abs_err_vs_plain": k2_v16["k2_max_abs_err_vs_plain"],
                   "max_abs_err_vs_plain_rate0":
                       k2_v16_0["k2_max_abs_err_vs_plain"],
                   "device_ms": k2_v16["k2_device_ms"],
                   "device_ms_rate0": k2_v16_0["k2_device_ms"],
                   "bound_ms": k2_v16["bound_ms"],
                   "bound_share_device": k2_v16["k2_bound_share_device"],
                   "bound_share_device_rate0":
                       k2_v16_0["k2_bound_share_device"],
                   "library_ms": k2_v16_0["library_ms"],
                   "factor_device": k2_v16_0["k2_factor"],
                   "k3_device_ms": k2_v16["device_ms"],
                   "k3_device_ms_rate0": k2_v16_0["device_ms"]},
        "crossover_min_seq": crossover,
        "ragged_ms": ragged[f"bwd_{rate}"]["kernel_ms"],
        "ptxas": ptxas.get("git_flash_bwd", {}), "card": smi},
        k3_entry("dq", "git_flash_bwd_dq",
                 "sasvqa_tpu/ops/git_flash.py:296 (_dq_kernel)"),
        k3_entry("dkv", "git_flash_bwd_dkv",
                 "sasvqa_tpu/ops/git_flash.py:346 (_dkv_kernel)"), {
        "name": "hash_dropout", "route": "cuda",
        "source": "sasvqa_torch/ops/csrc/git_flash_common.cuh",
        "replaces": "sasvqa_tpu/ops/git_flash.py:136 (_hash_keep, "
                    "_dropout_block), inside K1, K2 and K3",
        **launches(_build.HASH_DROPOUT),
        "max_abs_err": fwd["max_abs_err_o"],
        **timing(hash_ms, hash_device_ms, hash_bound[0]),
        "plain_ms": main_t["hash_plain_ms"],
        "bound_ms": hash_bound[0], "bound_by": hash_bound[1],
        "library_ms": None,
        "at": f"training shape: K1 + the routed backward "
              f"({'K2' if fused else 'K3'}) at the rate minus at "
              f"rate 0",
        "vitl16": hash_vitl16,
        "card": smi}, {
        "name": "flash_fwd", "route": "cuda",
        "source": "sasvqa_torch/ops/csrc/flash_fwd.cu",
        "replaces": "sasvqa_tpu/ops/flash_attention.py:64 (_flash_core)",
        **launches("flash_fwd"),
        "max_abs_err": max(r["fwd"]["max_abs_err_o"]
                           for r in flash_rows.values()),
        **timing(k5_serve["kernel_ms"], k5_serve["device_ms"],
                 k5_serve["bound_ms"]),
        "plain_ms": k5_serve["plain_ms"],
        "bound_ms": k5_serve["bound_ms"], "bound_by": k5_serve["bound_by"],
        "library_ms": k5_serve["library_ms"],
        "library_events_ms": k5_serve["library_events_ms"],
        "library_kernels": k5_serve["library_kernels"],
        "at": "BLIP-base serving shape (64, 12, 577, 64), no bias; library "
              "(SDPA forward) by device time",
        "tflops": k5_serve["tflops"],
        "training": {key: k5_train[key] for key in
                     ("kernel_ms", "device_ms", "plain_ms", "bound_ms",
                      "library_ms", "tflops", "bound_share")},
        "kernel_share_of_serving_forward": (
            blip_serve_row["launches"]["flash_fwd"]
            / blip_serve_row["batches"] * k5_serve["kernel_ms"]
            / blip_serve_row["forward_ms"]),
        "ptxas": ptxas.get("flash_fwd", {}), "card": smi},
        k6_entry("dq", "flash_bwd_dq",
                 "sasvqa_tpu/ops/flash_attention.py:246 (_dq_core)"),
        k6_entry("dkv", "flash_bwd_dkv",
                 "sasvqa_tpu/ops/flash_attention.py:284 (_dkv_core)"),
        ln_entry("fwd"), ln_entry("bwd")]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
