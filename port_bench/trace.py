"""Device activity of a window, read from ``torch.profiler`` with CUDA
activity only (no host events: their post-processing takes minutes at
hundreds of thousands of launches), and the arithmetic over it."""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

Interval = Tuple[int, int]          # (start ns, end ns)


def union_ns(intervals: Sequence[Interval]) -> int:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps_ns(records: Sequence[Tuple[str, int, int]]
            ) -> List[Tuple[str, int]]:
    """Idle stretches between device activity, each named after the
    operation that ran last before it; longest first."""
    out, last_end, last_name = [], None, None
    for name, s, e in sorted(records, key=lambda r: r[1]):
        if last_end is not None and s > last_end:
            out.append((f"after {last_name}", s - last_end))
        if last_end is None or e >= last_end:
            last_end, last_name = e, name
    return sorted(out, key=lambda g: -g[1])


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def _events(prof) -> List[Tuple[str, int, int]]:
    """(name, start ns, end ns) of every device record."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if "CUDA" not in str(e.device_type()):
            continue
        if hasattr(e, "start_ns"):
            s, d = int(e.start_ns()), int(e.duration_ns())
        else:
            s, d = int(e.start_us() * 1000), int(e.duration_us() * 1000)
        out.append((e.name(), s, s + d))
    return out


def profile(fn: Callable[[], object]) -> Dict[str, object]:
    """Run ``fn`` under the profiler, ending in a synchronize: its host
    wall and the device records (none without a GPU: the CPU tests run
    this path with host activity, which no reader counts)."""
    import torch
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CUDA if cuda
            else torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {"wall_s": wall, "records": _events(prof)}


def summary(prof: Dict[str, object], top: int = 10) -> Dict[str, object]:
    """busy seconds, wall, kernel count and the breakdown lists."""
    recs = prof["records"]
    busy = union_ns([(s, e) for _, s, e in recs]) / 1e9
    by_name: Dict[str, float] = {}
    for name, s, e in recs:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = [(n, g / 1e9) for n, g in gaps_ns(recs)[:top]]
    return {"busy_s": busy, "window_s": float(prof["wall_s"]),
            "kernels": sum(1 for n, _, _ in recs if is_kernel(n)),
            "breakdown": {"device_ops": [[n[:160], v] for n, v in ops],
                          "idle_gaps": [[n[:160], v] for n, v in gaps]}}


def device_seconds(prof: Dict[str, object], needle: str,
                   ) -> Optional[Tuple[int, float]]:
    """(count, summed seconds) of the records whose name holds
    ``needle``; None when there are none."""
    hits = [(e - s) for n, s, e in prof["records"] if needle in n]
    if not hits:
        return None
    return len(hits), sum(hits) / 1e9
