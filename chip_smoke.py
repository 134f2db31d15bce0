#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sasvqa_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the serving and training paths from the
sources in the checkout and holds each kernel against its plain PyTorch
version at the shapes the paths give it.  Then it serves video-QA
requests through ``QAEngine`` at the full width of GIT-base (seeded
random weights, 8 frames of 224x224 per request), checks the training
route's gradients against the dense route's, and trains GIT-base with
``make_scan_train_step`` at the bench's flagship shape (B=16, 8 frames,
S=1608, dropout on), checking that each path went through the kernels.
Each phase prints one JSON line; the line before the last lists the
kernels, the last is ``{"ok": true, "device": {...}}``.  Exits non-zero,
with no result, when there is no GPU or any check fails.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from sasvqa_torch.data.dataset import GITCollator
from sasvqa_torch.data.pipeline import stack_microbatches
from sasvqa_torch.data.tokenization import make_test_wordpiece
from sasvqa_torch.models.git import GITForCausalLM, greedy_generate
from sasvqa_torch.models.presets import _git_config, build_model
from sasvqa_torch.ops import _build
from sasvqa_torch.ops.git_flash import (git_flash_attention,
                                        git_flash_attention_reference,
                                        git_flash_backward,
                                        git_flash_backward_reference,
                                        git_mask_ok, hash_dropout_factor)
from sasvqa_torch.tasks.serve import QAEngine
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
# key tiles by atomics in run-dependent order; allowed error 2^-6 of each
# gradient's largest magnitude
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


def roofline(ops, nbytes, peak=PEAK_BF16_FLOPS):
    """(bound_ms, bound_by): the larger of ops at ``peak`` and bytes at
    the memory rate."""
    t_ops = ops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


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


def phase_build():
    t0 = time.perf_counter()
    seconds = _build.build_all()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in _build.build_logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_s": seconds, "ptxas": ptxas})


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
        plain_ms = cuda_ms(
            lambda: git_flash_attention_reference(q, k, v, mask, num_img),
            reps=5)
        library_ms = cuda_ms(
            lambda: F.scaled_dot_product_attention(q, k, v,
                                                   attn_mask=ok_mask),
            reps=20)
        bound_ms, bound_by, pairs = git_flash_bound(num_img, mask, h, dh)
        row = {"phase": "kernel", "name": "git_flash_fwd",
               "shape": {"B": b, "H": h, "S": num_img + l,
                         "num_img": num_img, "L": l, "Dh": dh},
               "max_abs_err_o": err_o, "max_abs_err_lse": err_lse,
               "tol_o": TOL_O, "tol_lse": TOL_LSE, "kernel_ms": kernel_ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "attended_pairs": pairs,
               "tflops": 4 * dh * pairs / kernel_ms / 1e9}
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
               "plain_ms": cuda_ms(lambda: git_flash_attention_reference(
                   q, k, v, mask, num_img, rate, seed), reps=2, warmup=1),
               "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                   q, k, v, attn_mask=ok_mask), reps=10),
               "library": "SDPA, boolean mask, no dropout",
               "attended_pairs": pairs}
        fwd["bound_ms"], fwd["bound_by"], _ = git_flash_bound(num_img, mask,
                                                              h, dh)
        emit(fwd)
        check(err_o <= TOL_O and err_lse <= TOL_LSE,
              f"git_flash_fwd with dropout disagrees with its plain "
              f"version: {fwd}")
        rows["fwd"] = fwd

        # K2, with K4 inside at rate > 0
        for r in (0.0, rate):
            o_r, lse_r = git_flash_attention(q, k, v, mask, num_img, r, seed)
            args = (q, k, v, o_r, lse_r, do, mask, num_img, r, seed)
            got = git_flash_backward(*args)
            ref = git_flash_backward_reference(*args)
            torch.cuda.synchronize()
            errs = {n: _rel_err(g, rf) for n, g, rf in zip("qkv", got, ref)}
            del got, ref
            bwd = {"phase": "kernel", "name": "git_flash_bwd", "rate": r,
                   "shape": shape,
                   "max_abs_err": {f"d{n}": e for n, (e, _) in errs.items()},
                   "max_abs_ref": {f"d{n}": m for n, (_, m) in errs.items()},
                   "tol_rel": TOL_GRAD_REL,
                   "kernel_ms": cuda_ms(lambda: git_flash_backward(*args),
                                        reps=10),
                   "plain_ms": cuda_ms(
                       lambda: git_flash_backward_reference(*args), reps=2,
                       warmup=1),
                   "attended_pairs": pairs}
            bwd["bound_ms"], bwd["bound_by"] = git_flash_bwd_bound(
                num_img, mask, h, dh)
            if r == 0.0:
                # SDPA forward + backward minus forward, at rate 0: SDPA's
                # dropout draws a mask of its own
                ql, kl, vl = (x.detach().clone().requires_grad_(True)
                              for x in (q, k, v))

                def sdpa():
                    return F.scaled_dot_product_attention(
                        ql, kl, vl, attn_mask=ok_mask)

                both = cuda_ms(lambda: sdpa().backward(do), reps=10)
                bwd["library_ms"] = both - cuda_ms(sdpa, reps=10)
                bwd["library"] = "SDPA, boolean mask: fwd+bwd minus fwd"
                del ql, kl, vl
            else:
                bwd["library_ms"] = None
            emit(bwd)
            check(all(e <= TOL_GRAD_REL * m for e, m in errs.values()),
                  f"git_flash_bwd disagrees with its plain version: {bwd}")
            rows[f"bwd_{r}"] = bwd
        rows["hash_plain_ms"] = cuda_ms(
            lambda: hash_dropout_factor(b, h, num_img + l, seed, rate,
                                        device="cuda"), reps=2, warmup=1)
        rows["pairs"] = pairs
        out_rows.append(rows)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return out_rows


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
          and kern["launches"]["git_flash_bwd"] == n_layers,
          f"kernel route did not launch K1/K2 once a layer: {row}")
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
    check(launches["git_flash_fwd"] == n and launches["git_flash_bwd"] == n
          and launches["hash_dropout"] == 2 * n,
          f"train launches {launches}, expected {n} of K1 and K2")
    check(all(x > 0 for x in qkv),
          "a text layer's qkv.weight got no gradient")
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
    emit({"phase": "small_reference", "max_abs_err_logits": err,
          "tol": TOL_F32, "greedy_tokens_equal": same})
    check(err <= TOL_F32 and same, "GPU port disagrees with the CPU port")


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2

    smi = phase_device()
    phase_build()
    b, fr, tpf = SLICE["batch_size"], SLICE["frames"], 197
    kernel_rows = phase_kernel([(b, 12, fr * tpf, SLICE["max_txt_len"], 64),
                                (2, 12, 3 * tpf, 13, 64)])
    rate = _git_config("git-base").attention_dropout
    train_rows = phase_train_kernels(
        [(TRAIN["batch_size"], 12, TRAIN["frames"] * tpf,
          TRAIN["max_seq_len"], 64), (2, 12, 3 * tpf, 13, 64)], rate)
    phase_small_reference()
    slice_row, serve_launches = phase_slice(SLICE["requests"],
                                            SLICE["seed"])
    phase_grad_check(SLICE["seed"])
    train_row, train_launches = phase_train(TRAIN["seed"])

    serve, main_t = kernel_rows[0], train_rows[0]
    fwd, bwd0, bwd = main_t["fwd"], main_t["bwd_0.0"], main_t[f"bwd_{rate}"]
    ragged = train_rows[1]
    hash_ms = ((fwd["kernel_ms"] - fwd["kernel_ms_rate0"])
               + (bwd["kernel_ms"] - bwd0["kernel_ms"]))
    hash_bound = roofline(2 * HASH_OPS_PER_PAIR * main_t["pairs"], 4,
                          PEAK_SCALAR_OPS)
    by_path = {name: {"serve": serve_launches.get(name, 0),
                      "train": train_launches[name]}
               for name in ("git_flash_fwd", "git_flash_bwd",
                            _build.HASH_DROPOUT)}
    check(by_path["git_flash_fwd"]["serve"] > 0
          and all(v["train"] > 0 for v in by_path.values()),
          f"a kernel of a path was not launched: {by_path}")
    grad_err = max(max(r["max_abs_err"].values())
                   for t in train_rows for r in (t["bwd_0.0"],
                                                 t[f"bwd_{rate}"]))
    emit({"kernels": [{
        "name": "git_flash_fwd", "route": "cuda",
        "source": "sasvqa_torch/ops/csrc/git_flash_fwd.cu",
        "replaces": "sasvqa_tpu/ops/git_flash.py:237 (_fwd_kernel)",
        "launches": sum(by_path["git_flash_fwd"].values()),
        "launches_by_path": by_path["git_flash_fwd"],
        "max_abs_err": max([r["max_abs_err_o"] for r in kernel_rows]
                           + [t["fwd"]["max_abs_err_o"] for t in train_rows]),
        "ms": fwd["kernel_ms"], "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
        "library_ms": fwd["library_ms"],
        "at": f"training shape, rate {rate}",
        "ms_rate0": fwd["kernel_ms_rate0"],
        "serving": {"ms": serve["kernel_ms"], "plain_ms": serve["plain_ms"],
                    "bound_ms": serve["bound_ms"],
                    "library_ms": serve["library_ms"]},
        "ragged_ms": ragged["fwd"]["kernel_ms"],
        "kernel_share_of_prompt_fill": (
            slice_row["launches"]["git_flash_fwd"] / slice_row["batches"]
            * serve["kernel_ms"] / slice_row["prompt_fill_ms"]),
        "card": smi}, {
        "name": "git_flash_bwd", "route": "cuda",
        "source": "sasvqa_torch/ops/csrc/git_flash_bwd.cu",
        "replaces": "sasvqa_tpu/ops/git_flash.py:421 (_fused_bwd_kernel)",
        "launches": sum(by_path["git_flash_bwd"].values()),
        "launches_by_path": by_path["git_flash_bwd"],
        "max_abs_err": grad_err,
        "ms": bwd["kernel_ms"], "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"], "bound_by": bwd["bound_by"],
        "library_ms": bwd0["library_ms"],
        "at": f"training shape, rate {rate}; library at rate 0",
        "ms_rate0": bwd0["kernel_ms"], "plain_ms_rate0": bwd0["plain_ms"],
        "ragged_ms": ragged[f"bwd_{rate}"]["kernel_ms"],
        "card": smi}, {
        "name": "hash_dropout", "route": "cuda",
        "source": "sasvqa_torch/ops/csrc/git_flash_common.cuh",
        "replaces": "sasvqa_tpu/ops/git_flash.py:136 (_hash_keep, "
                    "_dropout_block), inside K1 and K2",
        "launches": sum(by_path[_build.HASH_DROPOUT].values()),
        "launches_by_path": by_path[_build.HASH_DROPOUT],
        "max_abs_err": fwd["max_abs_err_o"],
        "ms": hash_ms, "plain_ms": main_t["hash_plain_ms"],
        "bound_ms": hash_bound[0], "bound_by": hash_bound[1],
        "library_ms": None,
        "at": "training shape: K1 + K2 time at the rate minus at rate 0",
        "card": smi}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
