#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sasvqa_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the serving and training paths from the
sources in the checkout and holds each kernel against its plain PyTorch
version at the shapes the paths give it.  Then it drives four main paths
at full width (seeded random weights), checking that each went through
its kernels:

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
  snapshots, frames from an in-memory store).

Every kernel row carries the kernel's device time from ``torch.profiler``
beside CUDA events round its Python call (the backward rows: every
kernel the launcher runs), and SDPA's time on the same inputs by device
time (the backwards: fwd+bwd window minus fwd window) with the kernels
it ran.

Each phase prints one JSON line; the line before the last lists the
kernels, the last is ``{"ok": true, "device": {...}}``.  Exits non-zero,
with no result, when there is no GPU or any check fails.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from sasvqa_torch.data.dataset import ClassifierCollator, GITCollator
from sasvqa_torch.data.pipeline import stack_microbatches
from sasvqa_torch.data.tokenization import make_test_wordpiece
from sasvqa_torch.models.git import (GITForCausalLM, git_attention_bias,
                                     greedy_generate)
from sasvqa_torch.models.presets import _git_config, build_model
from sasvqa_torch.ops import _build
from sasvqa_torch.ops.attention import padding_bias
from sasvqa_torch.ops.flash_attention import (_launch_dkv, _launch_dq,
                                              flash_attention_reference,
                                              flash_backward_reference,
                                              flash_forward)
from sasvqa_torch.ops import git_flash as gf
from sasvqa_torch.ops.git_flash import (git_flash_attention,
                                        git_flash_attention_reference,
                                        git_flash_backward_reference,
                                        git_mask_ok, hash_dropout_factor)
from sasvqa_torch.tasks import run_video_qa
from sasvqa_torch.tasks.serve import QAEngine
from sasvqa_torch.tools.bwd_yardstick import device_window, sdpa_backward
from sasvqa_torch.train import steps as train_steps
from sasvqa_torch.train.steps import create_train_state, make_scan_train_step

# H100 SXM dense peaks (NVIDIA data sheet) for the roofline bound; the
# dropout hash is scalar integer work, bounded here by the 67 TFLOP/s
# non-tensor f32 rate (the card's integer rate is not higher)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
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
# rate that moves random weights within a few updates
TRAIN = dict(batch_size=16, frames=8, max_seq_len=32, k_micro=2,
             warmup_updates=1, timed_updates=3, seed=0,
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
# the BLIP gradient gate sits at bf16's noise floor (PERF.md): a change of
# where P or dS round draws a new sample of it, so the check runs at these
# seeds too (weights, batch and dropout draws), each under the same gate
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


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, kernel: str = "flash_fwd_sm90") -> float:
    """Mean device time per call of ``fn`` of the CUDA kernels whose name
    holds ``kernel``, from ``torch.profiler`` (``device_window``): the
    kernel's own time, which ``cuda_ms`` exceeds when the launcher's host
    time does."""
    _, names = device_window(fn, reps)
    return sum(ms for name, ms in names.items() if kernel in name)


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
            bwd["reduce_only_device_ms"] = device_window(
                lambda: gf._launch_bwd_reduce_only(*args), reps=10)[0]
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
            loss=loss.item(), launches=dict(_build.launch_counts),
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
    for _ in range(TRAIN["warmup_updates"]):
        state, m = step(state, batch, seed)
        losses.append(m["loss"].item())
        gnorms.append(m["grad_norm"].item())
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(TRAIN["timed_updates"]):
        state, m = step(state, batch, seed)
        losses.append(m["loss"].item())
        gnorms.append(m["grad_norm"].item())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    micros = k * TRAIN["timed_updates"]
    qkv = [lyr.attention.qkv.weight.grad.abs().sum().item()
           for lyr in model.layers]
    row = {"phase": "train", "model": "git-base (seeded random weights)",
           "dtype": "bfloat16 activations, f32 params", "batch_size": b,
           "k_micro": k, "frames": TRAIN["frames"], "seq_len": seq_len,
           "dropout": cfg.dropout, "attention_dropout": cfg.attention_dropout,
           "optim": TRAIN["optim"], "setup_s": setup_s,
           "updates_timed": TRAIN["timed_updates"], "wall_s": wall,
           "ms_per_update": wall / TRAIN["timed_updates"] * 1e3,
           "qa_pairs_per_s": micros * b / wall,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
           "loss": losses, "grad_norm": gnorms, "launches": launches,
           "text_qkv_grad_abs_sum": qkv, "micro_steps": state.step}
    emit(row)
    n = cfg.num_layers * micros
    check(seq_len == 1608, f"train sequence {seq_len} != 1608")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"loss is not finite and falling: {losses}")
    bwd = bwd_kernels()
    check(launches["git_flash_fwd"] == n
          and all(launches[k] == n for k in bwd)
          and launches["hash_dropout"] == (1 + len(bwd)) * n,
          f"train launches {launches}, expected {n} of K1 and of {bwd}")
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
        launches = dict(_build.launch_counts)
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
    gradient sums of one training forward/backward of BLIP-base."""
    _, model = build_model(BLIP_CFG, dtype=dtype, device="cuda",
                           generator=torch.Generator().manual_seed(seed))
    model.train()
    model.vis_model.flash = route
    _build.reset_launch_counts()
    loss = model(*inputs, deterministic=False,
                 generator=torch.Generator(device="cuda").manual_seed(
                     seed))["loss"]
    loss.backward()
    torch.cuda.synchronize()
    out = dict(loss=loss.item(), launches=dict(_build.launch_counts),
               grads={n: p.grad.float() for n, p in model.named_parameters()
                      if p.grad is not None},
               qkv=_vision_qkv_grads(model))
    del model, loss
    torch.cuda.empty_cache()
    return out


def phase_blip_grad_check(seed):
    """One training forward/backward of BLIP-base through K5/K6 (bf16)
    vs the plain route (vision attention on plain autograd, bf16), on the
    same weights, batch and head-dropout draws, with the plain route in
    f32 as the oracle that says which gradients bf16 resolves at all."""
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
    # a gradient the plain bf16 route itself misses by more than the
    # tolerance against f32 is not resolved in bf16 (cancellation in the
    # deep random text stack): there the kernel route must be no further
    # from f32 than twice the plain route; everywhere else within the
    # tolerance of the plain route
    unresolved = [n for n in names if pf[n] > TOL_PARAM_GRAD_REL]
    failed = [n for n in names
              if kp[n] > TOL_PARAM_GRAD_REL
              and not (n in unresolved and kf[n] <= 2 * pf[n])]
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
          and not any(plain["launches"].values()),
          f"the kernel route did not launch K5/K6 once a layer: {row}")
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
    t0 = time.perf_counter()
    for _ in range(BLIP_TRAIN["timed_updates"]):
        update()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    micros = k * BLIP_TRAIN["timed_updates"]
    qkv = _vision_qkv_grads(model)
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
           "launches": launches, "vision_qkv_grad_abs_sum": qkv,
           "micro_steps": state.step}
    emit(row)
    n = model.vision_config.num_layers * micros
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"BLIP loss is not finite and falling: {losses}")
    check(all(launches[name] == n for name in
              ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
          f"BLIP train launches {launches}, expected {n} of K5 and K6")
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
        launches = dict(_build.launch_counts)
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
# these take the profiler windows of K2's reduction alone and of K1
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
    vs K2, and K2 vs its own (fused) plain version, at each SPLIT_SHAPES
    entry and rates 0 and ``rate``, with K3's gradients and K2's dK/dV
    bit-identical across two launches; K3, K2, plain and SDPA times and
    the bounds, and at the SPLIT_MAIN shapes K2's reduction alone and K1.
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
                row["k2_reduce_only_device_ms"] = device_window(
                    lambda: gf._launch_bwd_reduce_only(*args), reps=5)[0]
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
    out = dict(loss=loss.item(), launches=dict(_build.launch_counts),
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


def _task_files(root):
    """msvd_qa-format annotations of TASK's videos and a vidmapping under
    ``root``; returns the config's path overrides."""
    words = ["what", "who", "how", "where", "when"]
    subjects = ["man", "woman", "dog", "cat"]
    answers = ["cooking", "running", "ball", "brown", "beach", "man"]
    vids = [f"vid{i:04d}" for i in range(TASK["videos"])]

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
    for split, rows in (("train", annos(TASK["questions"], vids)),
                        ("val", annos(1, vids[:TASK["val"]])),
                        ("test", annos(1, vids[-TASK["test"]:]))):
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


def phase_task_loop():
    """``start_training`` at the vitl16 shape, on the card, through its
    normal entry (a config file parsed by get_video_qa_args), frames from
    an in-memory store: 4 AdamW updates of 2 micros of 8 questions over 16
    frames, one in-loop validation and the final one.  The step, the
    prefetcher and validate are wrapped to time them; nothing else in the
    loop changes."""
    t_setup = time.perf_counter()
    rng = np.random.default_rng(0)
    frames = rng.standard_normal(
        (TASK["videos"], TASK["stored_frames"], TASK["img"], TASK["img"], 3),
        dtype=np.float32)
    store = MemoryFrameStore(frames)
    step_s, wait_s, val_s = [], [], []
    real_step = train_steps.make_scan_train_step
    real_validate = run_video_qa.validate
    real_prefetcher = run_video_qa.DevicePrefetcher

    def timed_step(*a, **kw):
        step = real_step(*a, **kw)

        def run(state, batch, seed):
            t0 = time.perf_counter()
            out = step(state, batch, seed)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            return out
        return run

    class TimedPrefetcher(real_prefetcher):
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
        path = os.path.join(root, "cfg.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        args = run_video_qa.get_video_qa_args(["--config", path])
        train_steps.make_scan_train_step = timed_step
        run_video_qa.DevicePrefetcher = TimedPrefetcher
        run_video_qa.validate = timed_validate
        try:
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t_setup
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            result = run_video_qa.start_training(
                args, open_store=lambda path: store)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(_build.launch_counts)
        finally:
            train_steps.make_scan_train_step = real_step
            run_video_qa.DevicePrefetcher = real_prefetcher
            run_video_qa.validate = real_validate
        out = cfg["output_dir"]
        with open(os.path.join(out, "log", "scalars.jsonl")) as f:
            scalars = [json.loads(line) for line in f]
        losses = [r["value"] for r in scalars if r["tag"] == "train/loss"]
        ckpts = sorted(os.listdir(os.path.join(out, "ckpt")))
        restore = sorted(os.listdir(os.path.join(out, "restore")))
    steady = step_s[1:]
    per_update = TASK["overrides"]["gradient_accumulation_steps"] * \
        TASK["overrides"]["train_batch_size"]
    s_len = TASK["stored_frames"] * 257 + TASK["overrides"]["max_seq_len"]
    row = {"phase": "task_loop",
           "model": "git-large (ViT-L/14) video QA, seeded random weights",
           "config": "configs/msvd_qa_base.json + " + json.dumps(
               {k: v for k, v in TASK["overrides"].items() if k != "model"}),
           "seq_len": s_len, "frames": TASK["stored_frames"],
           "backward_route": bwd_kernels(),
           "updates": result["global_step"], "setup_s": setup_s,
           "wall_s": wall, "update_s": step_s,
           "ms_per_update": float(np.mean(steady)) * 1e3,
           "qa_pairs_per_s": per_update / float(np.mean(steady)),
           "prefetch_wait_ms_per_update": float(np.mean(wait_s[1:])) * 1e3,
           "prefetch_wait_first_ms": wait_s[0] * 1e3,
           "validation_s": val_s,
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 2 ** 30,
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


PATHS = ("git_serve", "git_train", "blip_serve", "blip_train",
         "vitl16_grad_check", "task_loop")
KERNELS = ("git_flash_fwd", "git_flash_bwd", "git_flash_bwd_dq",
           "git_flash_bwd_dkv", _build.HASH_DROPOUT, "flash_fwd",
           "flash_bwd_dq", "flash_bwd_dkv")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2

    smi = phase_device()
    ptxas = phase_build()
    b, fr, tpf = SLICE["batch_size"], SLICE["frames"], 197
    kernel_rows = phase_kernel([(b, 12, fr * tpf, SLICE["max_txt_len"], 64),
                                (2, 12, 3 * tpf, 13, 64)])
    rate = _git_config("git-base").attention_dropout
    train_rows = phase_train_kernels(
        [(TRAIN["batch_size"], 12, TRAIN["frames"] * tpf,
          TRAIN["max_seq_len"], 64), (2, 12, 3 * tpf, 13, 64)], rate)
    btok = 577
    flash_rows = phase_flash_kernels({
        # BLIP-base vision self-attention: serving (64 frames) and
        # training (32 frames a micro)
        "blip_serve": (BLIP["batch_size"] * BLIP["frames"], 12, btok, btok,
                       None, False),
        "blip_train": (BLIP_TRAIN["batch_size"] * BLIP["frames"], 12, btok,
                       btok, None, True),
        # rectangular: text-length queries over 4 frames' tokens with key
        # padding, and the GIT combined mask as a 2-D bias (3 frames)
        "rect_row_bias": (8, 12, 520, 4 * btok, "row", True),
        "git_mask_2d_bias": (2, 12, 3 * tpf + 13, 3 * tpf + 13, "git_mask",
                             True)})
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

    by_path = {name: dict(zip(PATHS, (counts.get(name, 0) for counts in
                                      (git_serve, git_train, blip_serve,
                                       blip_train, vitl16, task))))
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
              + bwd_kernels()}
    check(all(by_path[k][path] > 0 for path, ks in needed.items()
              for k in ks),
          f"a kernel of a path was not launched: {by_path}")

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

    emit({"kernels": [{
        "name": "git_flash_fwd", "route": "cuda",
        "source": "sasvqa_torch/ops/csrc/git_flash_fwd.cu",
        "replaces": "sasvqa_tpu/ops/git_flash.py:237 (_fwd_kernel)",
        **launches("git_flash_fwd"),
        "max_abs_err": max([r["max_abs_err_o"] for r in kernel_rows]
                           + [t["fwd"]["max_abs_err_o"] for t in train_rows]),
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
        "reduce_only_device_ms": bwd["reduce_only_device_ms"],
        "reduce_only_device_ms_rate0": bwd0["reduce_only_device_ms"],
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
                   "reduce_only_device_ms": k2_v16["k2_reduce_only_device_ms"],
                   "reduce_only_device_ms_rate0":
                       k2_v16_0["k2_reduce_only_device_ms"],
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
                 "sasvqa_tpu/ops/flash_attention.py:284 (_dkv_core)")]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
