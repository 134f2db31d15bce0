#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sasvqa_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the serving path from the sources in the
checkout, holds each kernel against its plain PyTorch version at the
shapes the path gives it, then serves video-QA requests through
``QAEngine`` at the full width of GIT-base (seeded random weights, 8
frames of 224x224 per request) and checks that the path went through the
kernels.  Each phase prints one JSON line; the line before the last lists
the kernels, the last is ``{"ok": true, "device": {...}}``.  Exits
non-zero, with no result, when there is no GPU or any check fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from sasvqa_torch.data.tokenization import make_test_wordpiece
from sasvqa_torch.models.git import GITForCausalLM, greedy_generate
from sasvqa_torch.models.presets import _git_config, build_model
from sasvqa_torch.ops import _build
from sasvqa_torch.ops.git_flash import (git_flash_attention,
                                        git_flash_attention_reference,
                                        git_mask_ok)
from sasvqa_torch.tasks.serve import QAEngine

# H100 SXM dense peaks (NVIDIA data sheet) for the roofline bound
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

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

SLICE = dict(batch_size=8, frames=8, stored_frames=16, img=224,
             max_txt_len=20, max_text_len=50, requests=16, seed=0)


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


def git_flash_bound(num_img, text_mask, h, dh):
    """(bound_ms, bound_by, attended pairs) for one call on these
    inputs: attended (row, col) pairs at 4*Dh FLOP each against q/k/v/O
    in bf16 + LSE in f32 + the int32 text mask, each moved once."""
    b, l = text_mask.shape
    s = num_img + l
    pairs = int(git_mask_ok(num_img, text_mask).sum().item()) * h
    flops = 4 * dh * pairs
    nbytes = 4 * b * h * s * dh * 2 + b * h * s * 4 + b * l * 4
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", pairs)


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
    phase_small_reference()
    slice_row, launches = phase_slice(SLICE["requests"], SLICE["seed"])

    main_shape = kernel_rows[0]
    emit({"kernels": [{
        "name": "git_flash_fwd", "route": "cuda",
        "source": "sasvqa_torch/ops/csrc/git_flash_fwd.cu",
        "replaces": "sasvqa_tpu/ops/git_flash.py:237 (_fwd_kernel)",
        "launches": launches["git_flash_fwd"],
        "max_abs_err": max(r["max_abs_err_o"] for r in kernel_rows),
        "ms": main_shape["kernel_ms"], "kernel_ms": main_shape["kernel_ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "kernel_share_of_prompt_fill": (
            slice_row["launches"]["git_flash_fwd"] / slice_row["batches"]
            * main_shape["kernel_ms"] / slice_row["prompt_fill_ms"]),
        "card": smi}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
