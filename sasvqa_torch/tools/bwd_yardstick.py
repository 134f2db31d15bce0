"""The attention backward kernels (K2, K3, K6) against PyTorch's own
backward, by device time.

    python3 -m sasvqa_torch.tools.bwd_yardstick [--reps N]

At the main paths' shapes (bf16, Dh = 64, seeded random inputs):

- K2, the fused GIT-mask backward, and K3, the split one, at the GIT-base
  training shape (B=16, H=12, S=1608, num_img=1576) and the ViT-L/14
  16-frame shape (B=8, H=12, S=4144, num_img=4112), rates 0 and 0.1,
  with K2's launch with its products compiled out (the D prologue, the
  ring and the dQ reductions alone: ``reduce_only_device_ms``);
- K6, the generic backward, at the BLIP-base training shape
  (B*T=32, H=12, Lq=Lk=577), no bias.

Each kernel's time is the device time (``torch.profiler``) of every CUDA
kernel its launcher runs, the D prologue included, and, beside it, CUDA
events round the Python call.  The yardstick is
``scaled_dot_product_attention`` with the GIT mask as a boolean mask (no
dropout) or no mask: the device time of every kernel of a forward +
backward window (``torch.autograd.grad``, so no gradient accumulates)
minus that of a forward window, with the names of the kernels each window
ran, which say which SDPA backend took the call.  Prints one JSON line a
case and a last line with the device-time factors (kernel / SDPA
backward) at rate 0.  Runs on whichever ``sasvqa_torch`` is on the path,
so two trees compare in one process each.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sasvqa_torch.ops import flash_attention as fa
from sasvqa_torch.ops import git_flash as gf

GIT_TRAIN = (16, 12, 8 * 197, 32)     # (B, H, num_img, L)
VITL16 = (8, 12, 16 * 257, 32)
BLIP_TRAIN = (32, 12, 577)            # (B*T, H, L)
# the card idles this long at both edges of a profiled step
EDGE_S = 0.05


def cuda_ms(fn: Callable, reps: int, warmup: int = 2) -> float:
    """Mean time of ``fn`` by CUDA events round ``reps`` calls."""
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


def device_window(fn: Callable, reps: int,
                  tries: int = 5) -> Tuple[float, Dict[str, float]]:
    """Device time per call of every CUDA kernel, copy and fill that
    ``fn`` runs, from ``torch.profiler`` (no selection by name), and the
    same by kernel name.

    The profiler's warm-up step (its schedule) runs ``fn`` once with
    device tracing already on and discards it, and the card idles for
    ``EDGE_S`` on both sides of both edges of the recorded step, which
    holds ``reps`` calls.  Even so the profiler now and then fails to
    deliver some of a step's kernel records (late in a long process on an
    H100).  A step is complete when each kernel's count is a multiple of
    ``reps``; an incomplete one is taken again, up to ``tries`` steps.  If
    none is complete, each kernel's launches a call come from its largest
    count, which must lack at most one call's records, and its time a
    call is its mean time a launch over all steps times those launches
    (the calls are identical); failing that, it raises.
    """
    seen: Dict[str, list] = {}   # kernel -> [total us, launches, max count]
    for _ in range(tries):
        sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA],
                schedule=sched) as prof:
            fn()
            torch.cuda.synchronize()
            time.sleep(EDGE_S)
            prof.step()
            time.sleep(EDGE_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(EDGE_S)
            prof.step()
        events = [e for e in prof.key_averages()
                  if e.self_device_time_total > 0]
        if events and all(e.count % reps == 0 for e in events):
            names = {e.key: e.self_device_time_total / reps / 1e3
                     for e in events}
            return sum(names.values()), names
        for e in events:
            tot = seen.setdefault(e.key, [0.0, 0, 0])
            tot[0] += e.self_device_time_total
            tot[1] += e.count
            tot[2] = max(tot[2], e.count)
    per_call = {k: -(-most // reps) for k, (_, _, most) in seen.items()}
    if not seen or any(most < per_call[k] * (reps - 1)
                       for k, (_, _, most) in seen.items()):
        raise RuntimeError(f"torch.profiler delivered an incomplete device "
                           f"trace in {tries} steps of {reps} calls: "
                           f"{ {k[:60]: v[2] for k, v in seen.items()} }")
    names = {k: us / n * per_call[k] / 1e3 for k, (us, n, _) in seen.items()}
    return sum(names.values()), names


def sdpa_backward(q, k, v, do, mask, reps: int) -> dict:
    """SDPA's backward on these inputs: device time of forward + backward
    minus forward, the events-timed difference, and each window's
    kernels."""
    ql, kl, vl = (x.detach().clone().requires_grad_(True) for x in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)

    def both():
        return torch.autograd.grad(fwd(), (ql, kl, vl), do)

    both_ms, both_names = device_window(both, reps)
    fwd_ms, fwd_names = device_window(fwd, reps)
    return {"device_ms": both_ms - fwd_ms,
            "events_ms": cuda_ms(both, reps) - cuda_ms(fwd, reps),
            "fwd_bwd_kernels": both_names, "fwd_kernels": fwd_names}


def _git_inputs(b, h, num_img, l, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    s = num_img + l
    q, k, v, do = (torch.randn((b, h, s, 64), generator=gen, device="cuda"
                               ).to(torch.bfloat16) for _ in range(4))
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, l + 1, size=b)
    lens[0] = l
    mask = torch.from_numpy(
        (np.arange(l)[None, :] < lens[:, None]).astype(np.int32)).cuda()
    return q, k, v, do, mask


def git_case(name, shape, reps):
    """K2 and K3 at ``shape`` at rates 0 and 0.1, with K2's reduction-only
    launch and SDPA's backward at rate 0."""
    b, h, num_img, l = shape
    q, k, v, do, mask = _git_inputs(b, h, num_img, l, seed=l + b)
    seed = torch.tensor([12345], dtype=torch.int32, device="cuda")
    rows = []
    for rate in (0.0, 0.1):
        o, lse = gf.git_flash_attention(q, k, v, mask, num_img, rate, seed)
        args = (q, k, v, o, lse, do, mask, num_img, rate, seed)
        sdpa = None
        if rate == 0.0:
            ok = gf.git_mask_ok(num_img, mask)[:, None]
            sdpa = sdpa_backward(q, k, v, do, ok, reps)
        for kernel, launch in (("K2", gf._launch_bwd),
                               ("K3", gf._launch_bwd_split)):
            dev, names = device_window(lambda: launch(*args), reps)
            row = {"case": name, "kernel": kernel, "rate": rate,
                   "shape": {"B": b, "H": h, "S": num_img + l,
                             "num_img": num_img},
                   "device_ms": dev, "kernels": names,
                   "kernel_ms": cuda_ms(lambda: launch(*args), reps)}
            if kernel == "K2":
                row["reduce_only_device_ms"] = device_window(
                    lambda: gf._launch_bwd_reduce_only(*args), reps)[0]
            if sdpa is not None:
                row["sdpa"] = sdpa
                row["factor"] = dev / sdpa["device_ms"]
            rows.append(row)
        del o, lse
    return rows


def blip_case(reps):
    bt, h, n = BLIP_TRAIN
    gen = torch.Generator(device="cuda").manual_seed(n)
    q, k, v, do = (torch.randn((bt, h, n, 64), generator=gen, device="cuda"
                               ).to(torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_forward(q, k, v)

    def k6():
        dq, delta = fa._launch_dq(q, k, v, o, lse, do, None)
        return dq, fa._launch_dkv(q, k, v, o, lse, do, None, delta)

    dev, names = device_window(k6, reps)
    row = {"case": "blip_train", "kernel": "K6", "rate": 0.0,
           "shape": {"B": bt, "H": h, "Lq": n, "Lk": n}, "device_ms": dev,
           "kernels": names, "kernel_ms": cuda_ms(k6, reps),
           "sdpa": sdpa_backward(q, k, v, do, None, reps)}
    row["factor"] = dev / row["sdpa"]["device_ms"]
    return [row]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bwd_yardstick needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    rows = (git_case("git_train", GIT_TRAIN, args.reps)
            + git_case("vitl16", VITL16, args.reps) + blip_case(args.reps))
    for row in rows:
        print(json.dumps(dict(row, card=card)), flush=True)
    print(json.dumps({"factors": {f"{r['kernel']} {r['case']}": r["factor"]
                                  for r in rows if "factor" in r},
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
