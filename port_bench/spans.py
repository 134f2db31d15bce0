"""The program's spans (``sasvqa_torch.core.profiling``) read for the
per-layer metrics: host milliseconds by phase, and the device's idle time
inside a window that falls in a set of host spans.

The program records spans only while a ``torch.profiler`` session is
active, so in a ``--trace 1`` run they are those of the profiled update
(a train cell) or of the profiled stretch of traffic (an answer cell),
read in the run's process after it.  Span and device times share the
profiler's clock (epoch ns).  A program without spans gives none here,
and every number is then None.
"""

from __future__ import annotations

import statistics
from typing import Any, Iterable, List, Optional, Sequence, Tuple

from port_bench.trace import union_ns

LOOP_LEAVES = ("train.forward", "train.backward", "train.accumulate",
               "train.optimizer")
# the dispatcher's phases while the device has no batch of its queued
SERIAL_HOST = ("engine.drain", "engine.collate", "engine.respond")


def program_spans() -> List[Any]:
    """The newest profiler session's finished spans of the program
    loaded in this process."""
    try:
        from sasvqa_torch.core import profiling
    except ImportError:
        return []
    read = getattr(profiling, "spans", None)
    return [] if read is None else list(read())


def named(spans: Iterable[Any], *names: str) -> List[Any]:
    return [s for s in spans if s.name in names]


def total_ms(spans: Iterable[Any]) -> float:
    return sum(s.end - s.start for s in spans) / 1e6


def mean_ms(spans: Sequence[Any]) -> Optional[float]:
    return total_ms(spans) / len(spans) if spans else None


def _clip(intervals: Iterable[Tuple[int, int]], lo: int, hi: int
          ) -> List[Tuple[int, int]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def idle_ns(window: Tuple[int, int], device: Sequence[Tuple[int, int]],
            host: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    """(the device's idle ns inside ``window``, the part of it that falls
    inside the union of the ``host`` intervals): |H u B| - |B| within the
    window, B the device's busy intervals."""
    lo, hi = window
    busy = _clip(device, lo, hi)
    b = union_ns(busy)
    return hi - lo - b, union_ns(busy + _clip(host, lo, hi)) - b


def in_updates(spans: Sequence[Any]) -> Tuple[List[Any], List[Any]]:
    """(the ``train.update`` spans, the spans under them)."""
    ups = named(spans, "train.update")
    keys = {u.key for u in ups}
    return ups, [s for s in spans if s.key in keys
                 and s.name != "train.update"]


def per_micro_ms(spans: Sequence[Any], *names: str) -> Optional[float]:
    """Host ms of the ``names`` spans of the updates over their micros
    (the count of ``train.forward`` spans)."""
    _, under = in_updates(spans)
    micros = len(named(under, "train.forward"))
    hits = named(under, *names)
    if not micros or not hits:
        return None
    return total_ms(hits) / micros


def optimizer_ms(spans: Sequence[Any]) -> Optional[float]:
    _, under = in_updates(spans)
    return mean_ms(named(under, "train.optimizer"))


def collate_ms(spans: Sequence[Any]) -> Optional[float]:
    """Mean host ms of the ``input.collate`` spans that end inside an
    update."""
    ups = named(spans, "train.update")
    return mean_ms([s for s in named(spans, "input.collate")
                    if any(u.start <= s.end <= u.end for u in ups)])


def idle_attributed_share(spans: Sequence[Any],
                          records: Sequence[Tuple[str, int, int]]
                          ) -> Optional[float]:
    """Percent of the device's idle ns inside the updates that falls in
    a leaf span of the loop's thread (``LOOP_LEAVES``)."""
    ups, under = in_updates(spans)
    device = [(s, e) for _, s, e in records]
    idle = inside = 0
    for u in ups:
        leaves = [(s.start, s.end) for s in named(under, *LOOP_LEAVES)
                  if s.key == u.key and s.thread == u.thread]
        i, h = idle_ns((u.start, u.end), device, leaves)
        idle, inside = idle + i, inside + h
    return 100.0 * inside / idle if idle > 0 else None


def queue_ms(spans: Sequence[Any]) -> Optional[float]:
    waits = [(s.end - s.start) / 1e6 for s in named(spans, "engine.queue")]
    return statistics.median(waits) if waits else None


def serial_host_share(spans: Sequence[Any]) -> Optional[float]:
    """Percent of the dispatcher's wall from its first ``engine.batch``
    span's start to its last one's end spent in ``SERIAL_HOST`` spans of
    those batches."""
    batches = named(spans, "engine.batch")
    if not batches:
        return None
    keys = {b.key for b in batches}
    wall = max(b.end for b in batches) - min(b.start for b in batches)
    serial = [s for s in named(spans, *SERIAL_HOST) if s.key in keys]
    return 100.0 * total_ms(serial) * 1e6 / wall if wall > 0 else None
