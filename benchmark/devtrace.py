"""The device trace of a traced sub-window, and its reduction.

``capture(fn)`` runs ``fn`` under ``torch.profiler`` with CUDA activity
only: no host operator is recorded, so the profiler adds next to nothing
to the host's time a launch, and a sub-window paced by the host runs at
its untraced pace.  ``fn`` runs between two marker kernels
(``torch.cuda._sleep``, the kernel ``spin_kernel``), the second followed
by a synchronize; the trace is written as Chrome JSON to the run's
temporary directory, read back and deleted.  :class:`Trace` holds what
the metrics read:

* the window: from the end of the first marker to the start of the
  last, in the trace's own clock: the device's view of ``fn``, from the
  moment the host starts on it to the end of the last work it queued;
* every device operation (kernels, copies, fills) in it;
* ``busy_s``: the union of the device operations' intervals, so that
  overlapping operations count once;
* the idle gaps between them, each named by the innermost CUDA runtime or
  driver call that spans the gap's middle (what the host was doing
  meanwhile), or as host code where none does.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Callable, Dict, List, Tuple

MARK = re.compile(r"spin_kernel")
MARK_CYCLES = 20_000
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")

Interval = Tuple[float, float]          # seconds, in the trace's clock


def capture(fn: Callable[[], None]) -> "Trace":
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(MARK_CYCLES)
        fn()
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return Trace.from_events(events)


def short_name(name: str) -> str:
    """A kernel's name without ``void``, anonymous namespaces and its
    arguments."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            return name[:i]
    return name


def union(intervals: List[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class Trace:
    def __init__(self, window: Interval, device: List[Tuple[str, Interval]],
                 host: List[Tuple[str, Interval]]):
        self.window = window
        lo, hi = window
        self.device = [(n, (max(a, lo), min(b, hi))) for n, (a, b) in device
                       if b > lo and a < hi]
        self.host = host
        self.busy = union([iv for _, iv in self.device])

    @classmethod
    def from_events(cls, events: List[dict]) -> "Trace":
        device, host, marks = [], [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            iv = (float(e["ts"]) * 1e-6, (float(e["ts"]) + float(e["dur"]))
                  * 1e-6)
            cat, name = e.get("cat", ""), e.get("name", "?")
            if cat in DEVICE_CATS and MARK.search(name):
                marks.append(iv)
            elif cat in DEVICE_CATS:
                device.append((name, iv))
            elif cat in HOST_CATS:
                host.append((name, iv))
        if len(marks) < 2:
            raise RuntimeError("the trace holds no two marker kernels")
        marks.sort()
        return cls((marks[0][1], marks[-1][0]), device, host)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy)

    def gaps(self) -> List[Interval]:
        """Idle stretches of the device inside the window."""
        out, t = [], self.window[0]
        for a, b in self.busy:
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.window[1] > t:
            out.append((t, self.window[1]))
        return out

    def host_at(self, t: float) -> str:
        """The innermost host operation running at ``t``."""
        best = None
        for name, (a, b) in self.host:
            if a <= t <= b and (best is None or b - a < best[1]):
                best = (name, b - a)
        return best[0] if best else "host code, no CUDA call"

    def kernels(self, pattern: str) -> List[Tuple[str, float]]:
        """(name, seconds) of each device operation whose name matches."""
        rx = re.compile(pattern)
        return [(n, b - a) for n, (a, b) in self.device if rx.search(n)]

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        by_name: Dict[str, float] = {}
        for n, (a, b) in self.device:
            k = short_name(n)[:120]
            by_name[k] = by_name.get(k, 0.0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self.host_at((a + b) / 2)[:120], b - a]
                              for a, b in gaps]}
