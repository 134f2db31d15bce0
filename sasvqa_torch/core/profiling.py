"""Spans: named host intervals of the program, on the profiler's clock.

The program marks its phases with :func:`span` (a context manager for a
span that begins and ends on one thread) and :func:`begin` /
:func:`end` (a span that crosses threads, such as a request's wait in a
queue).  A span is recorded only while a ``torch.profiler`` session is
active, so that it always shares a window with a device trace; with no
profiler running a site costs its call and one read of a global, and
makes no record and reads no clock.

Each record (:class:`Span`) holds its name, its start and end in ns on
the profiler's clock (``time.perf_counter_ns`` plus an offset to the
epoch time the profiler's events carry, taken when the session's first
span is recorded), its own id, the id of its parent (the span open on
the same thread for :func:`span`; the ``parent=`` handle given to
:func:`begin`), the thread's id, its ``key`` (a root span's own id,
else its parent's: the id of the request or batch that the root span
is, shared by the spans under it) and its other attributes.

The first span recorded after a profiler starts begins a new session
and drops the spans of the one before; :func:`spans` returns the newest
session's finished spans.  A :func:`span` also opens a
``torch.profiler.record_function`` range of its name, so that a
profiler's trace (``--profile_steps``'s Chrome trace among them) shows
the program's phases beside its kernels; the profiler records such a
range only on the thread that started it.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Any, Dict, List, Optional

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _prof


class Span:
    """One span; ``end`` is None until it ends."""

    __slots__ = ("name", "start", "end", "id", "parent", "thread", "key",
                 "attrs", "_session")

    def __init__(self, name: str, start: int, span_id: int,
                 parent: Optional["Span"], attrs: Dict[str, Any],
                 session: "_Session"):
        self.name = name
        self.start = start
        self.end: Optional[int] = None
        self.id = span_id
        self.parent = None if parent is None else parent.id
        self.thread = threading.get_ident()
        self.key = span_id if parent is None else parent.key
        self.attrs = attrs
        self._session = session


class _Session:
    __slots__ = ("starts", "offset", "spans")

    def __init__(self, starts: int):
        self.starts = starts
        a = time.perf_counter_ns()
        epoch = time.time_ns()
        b = time.perf_counter_ns()
        self.offset = epoch - (a + b) // 2
        self.spans: List[Span] = []


# profiler starts seen; a span compares it with its session's
_starts = 0
_session = _Session(-1)
_lock = threading.Lock()
_ids = itertools.count(1)
_tls = threading.local()


def _count_start(start):
    def run_on_profiler_start():
        global _starts
        _starts += 1
        start()
    run_on_profiler_start.counts_starts = True
    return run_on_profiler_start


# torch's profilers call this module-level hook (by its global name) as
# they start; wrapped once, it counts the sessions
if not getattr(_prof._run_on_profiler_start, "counts_starts", False):
    _prof._run_on_profiler_start = _count_start(_prof._run_on_profiler_start)


def _current() -> _Session:
    global _session
    if _session.starts != _starts:
        with _lock:
            if _session.starts != _starts:
                _session = _Session(_starts)
    return _session


def _stack() -> List[Span]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _open(name: str, parent: Optional[Span], attrs: Dict[str, Any]
          ) -> Span:
    s = _current()
    return Span(name, time.perf_counter_ns() + s.offset, next(_ids), parent,
                attrs, s)


def _close(sp: Span) -> None:
    s = sp._session
    sp.end = time.perf_counter_ns() + s.offset
    if _prof._is_profiler_enabled and s is _session:
        s.spans.append(sp)


# what span() returns with no profiler running
_NULL = contextlib.nullcontext()


class _Scoped:
    __slots__ = ("name", "attrs", "sp", "rf")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> Span:
        stack = _stack()
        self.sp = sp = _open(self.name, stack[-1] if stack else None,
                             self.attrs)
        stack.append(sp)
        self.rf = _RecordFunctionFast(self.name)
        self.rf.__enter__()
        return sp

    def __exit__(self, *exc) -> bool:
        self.rf.__exit__(*exc)
        stack = _stack()
        if stack and stack[-1] is self.sp:
            stack.pop()
        _close(self.sp)
        return False


def span(name: str, **attrs: Any):
    """``with span("train.forward", micro=i): ...``: a span of the block
    on this thread, the child of the span open around it (``as`` gives
    the :class:`Span`, or None with no profiler running)."""
    if not _prof._is_profiler_enabled:
        return _NULL
    return _Scoped(name, attrs)


def begin(name: str, parent: Optional[Span] = None,
          **attrs: Any) -> Optional[Span]:
    """A span that :func:`end` ends, on any thread; its parent is
    ``parent`` (a handle), or none.  None with no profiler running."""
    if not _prof._is_profiler_enabled:
        return None
    return _open(name, parent, attrs)


def end(handle: Optional[Span], **attrs: Any) -> None:
    """End a :func:`begin` span, adding ``attrs`` to its attributes."""
    if handle is None:
        return
    handle.attrs.update(attrs)
    _close(handle)


def spans() -> List[Span]:
    """The newest session's finished spans, in the order they ended."""
    return list(_session.spans)
