"""Device timers for the attention kernels on the card, and PyTorch's own
attention backward as their yardstick.

- :func:`cuda_ms`: mean time of a call by CUDA events;
- :func:`device_window`: device time per call of every CUDA kernel, copy
  and fill a call runs, from ``torch.profiler``, total and by name;
- :func:`sdpa_backward`: ``scaled_dot_product_attention``'s backward on
  given inputs, as forward + backward minus forward, with the names of
  the kernels each window ran (they say which SDPA backend took it).

``chip_smoke.py`` times K2, K3 and K6 and SDPA with these.  Needs a GPU.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

# the card idles this long at both edges of a profiled step
EDGE_S = 0.05
# a profiled step's records before its counted calls: small fills, then a
# marker kernel (torch.cuda._sleep's spin_kernel) of about a microsecond
LEAD_FILLS = 32
MARK, MARK_CYCLES = "spin_kernel", 2000
PROFILER_STATS = {"windows": 0, "incomplete_steps": 0,
                  "lead_records_lost_max": 0}


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
    ``EDGE_S`` on both sides of both edges of the recorded step.  Even so
    the profiler now and then fails to deliver a step's first kernel
    records (late in a long process on an H100: three of ten, in every
    step of one window).  So the recorded step runs ``LEAD_FILLS`` small
    fills and ``reps`` lead calls, then a marker kernel
    (``torch.cuda._sleep``), then the ``reps`` counted calls, and only
    the records that start after the marker ends count.  A step is
    complete when the marker arrived and each kernel's count after it is
    a multiple of ``reps``; an incomplete one is taken again, up to
    ``tries`` steps, and then it raises.  ``PROFILER_STATS`` keeps the
    windows, the incomplete steps and the most lead records lost in one
    step, for the run's report.
    """
    pad = torch.zeros(1, device="cuda")
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
            for _ in range(LEAD_FILLS):
                pad.zero_()
            for _ in range(reps):
                fn()
            torch.cuda._sleep(MARK_CYCLES)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(EDGE_S)
            prof.step()
        events = [e for e in prof.events() if e.self_device_time_total > 0]
        marks = [e for e in events if MARK in e.name]
        counted: Dict[str, list] = {}   # kernel -> [total us, records]
        if marks:
            t0 = max(m.time_range.end for m in marks)
            for e in events:
                if e.time_range.start >= t0:
                    tot = counted.setdefault(e.key, [0.0, 0])
                    tot[0] += e.self_device_time_total
                    tot[1] += 1
            lead = sum(1 for e in events if e.time_range.end <= t0) - 1
            PROFILER_STATS["lead_records_lost_max"] = max(
                PROFILER_STATS["lead_records_lost_max"],
                LEAD_FILLS + sum(n for _, n in counted.values()) - lead)
        if counted and all(n % reps == 0 for _, n in counted.values()):
            PROFILER_STATS["windows"] += 1
            names = {k: us / reps / 1e3 for k, (us, _) in counted.items()}
            return sum(names.values()), names
        PROFILER_STATS["incomplete_steps"] += 1
    raise RuntimeError(f"torch.profiler delivered an incomplete device "
                       f"trace in {tries} steps of {reps} calls: marker "
                       f"{'seen' if marks else 'lost'}, "
                       f"{ {k[:60]: v[1] for k, v in counted.items()} }")


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

