"""The program's own spans and counters, kept in memory.

A span is a named stretch of host time at a layer boundary (``stream.request``,
``serve.forward``, ``train.step``, ...): its start and end
(``time.perf_counter_ns``), its id, its parent's id (the span open on the
same thread when it began; 0 for a root) and a request id, new at each
root and inherited by its children.  A counter is a named integer sum.

Tracing is off by default and costs one flag test a site while off:
:func:`span` then returns a shared no-op object, allocating nothing and
reading no clock.  :func:`enable` / :func:`disable` switch it;
:func:`collect` returns what was recorded and clears it.  :func:`anchor`
pairs the span clock with the wall clock, on which ``torch.profiler``'s
Chrome trace puts its events (``ts`` in microseconds plus the file's
``baseTimeNanoseconds``), and :func:`chrome_events` maps spans onto that
timeline, so that host spans and device kernels show on one timeline::

    from wiflow_tpu_torch.utils import trace
    trace.enable()
    with trace.span("my.work"):
        ...
    spans, counts = trace.collect()
"""

from __future__ import annotations

import itertools
import threading
import time
from time import perf_counter_ns
from typing import Dict, List, NamedTuple, Tuple


class Span(NamedTuple):
    name: str
    start_ns: int          # time.perf_counter_ns()
    end_ns: int
    id: int
    parent: int            # 0: a root
    request: int


class Collected(NamedTuple):
    spans: List[Span]      # in the order they ended
    counts: Dict[str, int]


class _NoSpan:
    """What a span site gets while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _OpenSpan:
    __slots__ = ("tracer", "stack", "name", "start", "id", "parent",
                 "request")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name = tracer, name
        stack = self.stack = tracer._stack()
        self.id = next(tracer._ids)
        if stack:
            top = stack[-1]
            self.parent, self.request = top.id, top.request
        else:
            self.parent, self.request = 0, next(tracer._requests)

    def __enter__(self):
        self.stack.append(self)
        self.start = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = perf_counter_ns()
        self.stack.pop()
        self.tracer._spans.append((self.name, self.start, end, self.id,
                                   self.parent, self.request))
        return False


class Tracer:
    """Spans (one stack a thread) and counters, in memory until
    :meth:`collect`."""

    def __init__(self):
        self.on = False
        self._local = threading.local()
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._requests = itertools.count(1)
        self._spans: List[tuple] = []       # Span's fields
        self._counts: Dict[str, int] = {}

    def _stack(self) -> list:
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        self.on = False

    def span(self, name: str):
        """A context manager that records ``name`` while tracing is on."""
        if not self.on:
            return NO_SPAN
        return _OpenSpan(self, name)

    def count(self, name: str, n: int = 1) -> None:
        if self.on:
            with self._lock:
                self._counts[name] = self._counts.get(name, 0) + int(n)

    def collect(self) -> Collected:
        """Every span ended and every count since the last call; clears
        them."""
        with self._lock:
            spans, self._spans = self._spans, []
            counts, self._counts = self._counts, {}
        return Collected([Span._make(s) for s in spans], counts)


def anchor() -> Tuple[int, int]:
    """``(perf_counter_ns, time_ns)`` read back to back: the span clock at
    a moment of the wall clock (the middle of two span-clock reads)."""
    p0 = perf_counter_ns()
    wall = time.time_ns()
    p1 = perf_counter_ns()
    return (p0 + p1) // 2, wall


def to_wall_ns(t_ns: int, at: Tuple[int, int]) -> int:
    """A span-clock time on the wall clock, by the anchor ``at``."""
    return t_ns - at[0] + at[1]


def chrome_events(spans: List[Span], at: Tuple[int, int], base_ns: int,
                  pid=0, tid=0) -> List[dict]:
    """``spans`` as Chrome trace events (``ph`` "X", ``cat``
    "program_span") on a trace whose ``ts`` is microseconds after the wall
    clock's ``base_ns``."""
    return [{"ph": "X", "cat": "program_span", "name": s.name,
             "pid": pid, "tid": tid,
             "ts": (to_wall_ns(s.start_ns, at) - base_ns) / 1e3,
             "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {"id": s.id, "parent": s.parent,
                      "request": s.request}} for s in spans]


TRACER = Tracer()
enable = TRACER.enable
disable = TRACER.disable
span = TRACER.span
count = TRACER.count
collect = TRACER.collect

