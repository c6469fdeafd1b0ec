"""The program's own spans on the device trace's clock: a capture that
records them, and the attribution of device time and idle time to them.

``capture(fn, tracer)`` is :func:`benchmark.devtrace.capture` with the
program's tracer (``wiflow_tpu_torch/utils/trace.py``) on between the two
marker kernels, and nowhere else.  Before the first marker it takes the
tracer's anchor (a back-to-back read of the span clock and the wall
clock, on which the profiler's Chrome trace puts ``ts`` plus the file's
``baseTimeNanoseconds``) and reads the span clock just before and just
after the first marker's launch.  The same events give
:class:`benchmark.devtrace.Trace`, so every metric that reads it reads
what it read before, and an :class:`Attribution`:

* the clock check: the first marker's ``cudaLaunchKernel`` event, mapped
  by the anchor, must lie inside the host interval around its launch,
  give or take ``SLACK_NS`` each side; if not, nothing is attributed;
* a device operation belongs to the innermost program span open at the
  trace time of the runtime or driver call that enqueued it (the call
  with the operation's ``correlation`` id); with no span open, to
  ``caller`` (the benchmark's own copies, gathers and loop); with no
  such call in the trace, to ``unmatched``;
* an idle gap of the device belongs to the innermost span open at its
  middle, and is named by that span and the innermost CUDA call open
  there (``devtrace``'s rule for the call);
* times are whole nanoseconds, so the time attributed to spans, caller
  and unmatched sums to the device operations' time exactly.

:meth:`Attribution.notes` gives the per-span table (count, host self ms,
device ms, idle ms), the ten longest idle gaps named ``<span> / <CUDA
call>``, the clock check and the unmatched operations;
:meth:`Attribution.quantities` the per-layer numbers the spans give.

``python3 -m benchmark.spantrace --workload <cell> --seed <n> --spans
<0|1>`` sets a cell up as ``run.py`` does, runs its window untraced,
then its traced sub-window once (one capture a process, as in
``run.py``: a second profiler session in one process has lost its
marker kernels), with the program's spans on or off, and prints the pace
against the untraced rate, the mean host ms of the benchmark's own spans
in the untraced window and, with spans on, the notes and quantities.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Tuple

from benchmark import devtrace

SLACK_NS = 50_000
UNMATCHED_LIMIT = 0.01          # share of device time: above it, no numbers
CALLER = "caller"
UNMATCHED = "unmatched"
# the port's own kernels: every pattern of the roofline files' groups
KERNEL_FILES = ("roofline.tcn", "roofline.conv_stack", "roofline.attention",
                "roofline.stage", "roofline.join", "roofline.attention_train")
WRAPPERS = ("serve.tcn", "serve.conv_stack", "serve.attention")


def program_tracer():
    """The program's tracer module, or None where the program has none."""
    try:
        from wiflow_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


class Span(NamedTuple):
    """A program span on the trace's clock (ns after the file's base)."""

    name: str
    start: int
    end: int
    id: int
    parent: int


class Captured(NamedTuple):
    trace: "devtrace.Trace"
    attribution: Optional["Attribution"]


def capture(fn: Callable[[], None], tracer=None) -> Captured:
    """``fn`` traced between two markers; with ``tracer`` (the program's
    tracer module), its spans and counters recorded meanwhile."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        at = tracer.anchor() if tracer else None
        a = time.perf_counter_ns()
        torch.cuda._sleep(devtrace.MARK_CYCLES)
        b = time.perf_counter_ns()
        if tracer:
            tracer.collect()
            tracer.enable()
        try:
            fn()
        finally:
            if tracer:
                tracer.disable()
        torch.cuda._sleep(devtrace.MARK_CYCLES)
        torch.cuda.synchronize()
    got = tracer.collect() if tracer else None
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    tr = devtrace.Trace.from_events(events)
    if got is None:
        return Captured(tr, None)
    base = int(doc.get("baseTimeNanoseconds", 0)) if isinstance(doc, dict) \
        else 0
    return Captured(tr, Attribution(events, got.spans, got.counts, at,
                                    (a, b), base))


def _ns(us) -> int:
    """A Chrome trace time (microseconds, to the nanosecond) in ns."""
    return round(float(us) * 1000)


class _Innermost:
    """The innermost span open at a time, from properly nested spans."""

    def __init__(self, spans: List[Span]):
        self.pieces: List[Tuple[int, int, Span]] = []
        stack: List[Span] = []
        cur = None

        def upto(t):
            nonlocal cur
            if stack and cur is not None and t > cur:
                self.pieces.append((cur, t, stack[-1]))
            cur = t

        for s in sorted(spans, key=lambda s: (s.start, -s.end)):
            while stack and stack[-1].end <= s.start:
                upto(stack[-1].end)
                stack.pop()
            upto(s.start)
            stack.append(s)
        while stack:
            upto(stack[-1].end)
            stack.pop()
        self.starts = [p[0] for p in self.pieces]

    def at(self, t: int) -> Optional[Span]:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.pieces[i][1]:
            return self.pieces[i][2]
        return None


class Attribution:
    """Device and idle time of one capture, by program span."""

    def __init__(self, events: List[dict], spans, counts: Mapping[str, int],
                 at: Tuple[int, int], marker_host: Tuple[int, int],
                 base_ns: int):
        self.counts = dict(counts)
        launches: Dict[int, int] = {}     # correlation -> launch start
        launch_end: Dict[int, int] = {}
        host: List[Tuple[str, int, int]] = []
        marks, ops = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat, name = e.get("cat", ""), e.get("name", "?")
            a = _ns(e["ts"])
            b = a + _ns(e["dur"])
            corr = (e.get("args") or {}).get("correlation")
            if cat in devtrace.HOST_CATS:
                host.append((name, a, b))
                if corr is not None and (corr not in launches
                                         or a < launches[corr]):
                    launches[corr], launch_end[corr] = a, b
            elif cat in devtrace.DEVICE_CATS:
                if devtrace.MARK.search(name):
                    marks.append((a, b, corr))
                else:
                    ops.append((name, a, b, corr))
        if len(marks) < 2:
            raise RuntimeError("the trace holds no two marker kernels")
        marks.sort()
        self.window = (marks[0][1], marks[-1][0])
        lo, hi = self.window
        self.ops = [(n, max(a, lo), min(b, hi), c) for n, a, b, c in ops
                    if b > lo and a < hi]
        self.host = host

        def on_trace(t_ns: int) -> int:
            return t_ns - at[0] + at[1] - base_ns

        # the clock check on the first marker's launch
        first = marks[0][2]
        self.clock: Dict[str, object] = {"slack_us": SLACK_NS / 1e3}
        if first in launches:
            ha, hb = on_trace(marker_host[0]), on_trace(marker_host[1])
            la, lb = launches[first], launch_end[first]
            self.clock.update(launch_after_host_start_us=(la - ha) / 1e3,
                              host_end_after_launch_us=(hb - lb) / 1e3)
            self.clock["ok"] = la >= ha - SLACK_NS and lb <= hb + SLACK_NS
        else:
            self.clock["ok"] = False
            self.clock["why"] = "no launch event of the first marker"

        self.spans = [Span(s.name, on_trace(s.start_ns), on_trace(s.end_ns),
                           s.id, s.parent) for s in spans]
        self.by_id = {s.id: s for s in self.spans}
        inner = _Innermost(self.spans)

        self.total_ns = sum(b - a for _, a, b, _ in self.ops)
        self.owner: List[Optional[Span]] = []   # per op; None: no span
        self.device_ns: Dict[str, int] = {}
        for n, a, b, c in self.ops:
            s = inner.at(launches[c]) if c in launches else None
            self.owner.append(s)
            k = s.name if s else (CALLER if c in launches else UNMATCHED)
            self.device_ns[k] = self.device_ns.get(k, 0) + b - a
        self.unmatched_ns = self.device_ns.get(UNMATCHED, 0)
        self.unmatched_ops = sum(c not in launches for *_, c in self.ops)

        busy = devtrace.union([(a, b) for _, a, b, _ in self.ops])
        self.gaps: List[Tuple[int, int, Optional[Span]]] = []
        t = lo
        for a, b in busy + [(hi, hi)]:
            if a > t:
                self.gaps.append((t, a, inner.at((t + a) // 2)))
            t = max(t, b)
        self.idle_ns: Dict[str, int] = {}
        for a, b, s in self.gaps:
            k = s.name if s else CALLER
            self.idle_ns[k] = self.idle_ns.get(k, 0) + b - a

    # --- reading ------------------------------------------------------------

    @property
    def usable(self) -> Optional[str]:
        """Why the numbers cannot be read, or None where they can."""
        if not self.clock["ok"]:
            return "clock check failed: " + json.dumps(self.clock)
        if self.total_ns and self.unmatched_ns > UNMATCHED_LIMIT * \
                self.total_ns:
            return (f"device ops with no matched launch: "
                    f"{self.unmatched_ns / self.total_ns:.2%} of device time")
        return None

    def ancestry(self, s: Optional[Span]) -> List[str]:
        out = []
        while s is not None:
            out.append(s.name)
            s = self.by_id.get(s.parent)
        return out

    def self_ns(self) -> Dict[str, int]:
        """Host self time by span name: each span's duration less its
        children's (spans of one thread nest)."""
        out: Dict[str, int] = {}
        for s in self.spans:
            out[s.name] = out.get(s.name, 0) + s.end - s.start
            p = self.by_id.get(s.parent)
            if p is not None:
                out[p.name] = out.get(p.name, 0) - (s.end - s.start)
        return out

    def host_call_at(self, t: int) -> str:
        best = None
        for name, a, b in self.host:
            if a <= t <= b and (best is None or b - a < best[1]):
                best = (name, b - a)
        return best[0] if best else "host code, no CUDA call"

    def table(self) -> Dict[str, Dict[str, float]]:
        counts: Dict[str, int] = {}
        for s in self.spans:
            counts[s.name] = counts.get(s.name, 0) + 1
        self_ns = self.self_ns()
        names = sorted(set(counts) | set(self.device_ns) | set(self.idle_ns))
        return {n: {"count": counts.get(n, 0),
                    "host_self_ms": self_ns.get(n, 0) / 1e6,
                    "device_ms": self.device_ns.get(n, 0) / 1e6,
                    "idle_ms": self.idle_ns.get(n, 0) / 1e6} for n in names}

    def named_gaps(self, top: int = 10) -> List[list]:
        gaps = sorted(self.gaps, key=lambda g: g[0] - g[1])[:top]
        return [[f"{s.name if s else CALLER} / "
                 f"{self.host_call_at((a + b) // 2)}"[:120], (b - a) / 1e9]
                for a, b, s in gaps]

    def notes(self) -> Dict[str, object]:
        return {"program_spans": self.table(),
                "program_idle_gaps": self.named_gaps(),
                "program_clock": dict(
                    self.clock, unmatched_ops=self.unmatched_ops,
                    unmatched_share=(self.unmatched_ns / self.total_ns
                                     if self.total_ns else 0.0),
                    usable=self.usable or "yes")}

    def device_ns_inside(self, inside, outside=(), kernels=None) -> int:
        """Device ns of the ops whose owner has a span of ``inside`` among
        its ancestors and none of ``outside``; ``kernels``: only those
        whose name does not match."""
        total = 0
        for (n, a, b, _), s in zip(self.ops, self.owner):
            names = self.ancestry(s)
            if (any(x in names for x in inside)
                    and not any(x in names for x in outside)
                    and not (kernels and kernels.search(n))):
                total += b - a
        return total

    def quantities(self, kernels: Optional[re.Pattern] = None
                   ) -> Optional[Dict[str, float]]:
        """The per-layer numbers of this capture, or None where
        :attr:`usable` says why not.  ``kernels``: the port's own
        kernels (:func:`own_kernels`)."""
        if self.usable:
            return None
        window = self.window[1] - self.window[0]
        out: Dict[str, float] = {}
        idle_in = sum(b - a for a, b, s in self.gaps if s is not None)
        if window > 0:
            out["idle_share.in_program"] = 100.0 * idle_in / window
        if self.total_ns and any(s.name == "stream.request"
                                 for s in self.spans):
            out["stream.own_device_share"] = 100.0 * self.device_ns_inside(
                ("stream.request",), ("serve.forward",)) / self.total_ns
        calls = [s for s in self.spans if s.name == "serve.forward"]
        if calls:
            wrapped = {s.id: 0 for s in calls}
            for s in self.spans:
                if s.name in WRAPPERS and s.parent in wrapped:
                    wrapped[s.parent] += s.end - s.start
            out["serve.glue_host_ms_per_call"] = sum(
                s.end - s.start - wrapped[s.id] for s in calls) \
                / len(calls) / 1e6
        steps = self.counts.get("train.steps", 0)
        if steps:
            out["train.optimizer_device_ms_per_step"] = \
                self.device_ns_inside(("train.optimizer",)) / steps / 1e6
            out["train.stock_ops_ms_per_step"] = self.device_ns_inside(
                ("train.forward", "train.loss", "train.backward"),
                kernels=kernels) / steps / 1e6
        return out


def own_kernels(metrics_dir: Path = Path(__file__).resolve().parent
                / "metrics") -> re.Pattern:
    """One pattern of every kernel group of the roofline files: the
    port's own ``csrc/`` kernels."""
    pats = []
    for name in KERNEL_FILES:
        spec = json.loads((metrics_dir / f"{name}.json").read_text())
        pats += [g["kernels"] for g in spec["groups"]]
    return re.compile("|".join(f"(?:{p})" for p in pats))


def stream_rows_check(counts: Mapping[str, int], batches: List[int],
                      windows: int) -> Dict[str, object]:
    """The program's ``stream.rows`` and ``stream.pad_rows`` against the
    benchmark's own count of the same requests: the rows of every call of
    the served forward and the useful windows."""
    rows = sum(batches)
    return {"program_rows": counts.get("stream.rows", 0),
            "benchmark_rows": rows,
            "program_pad_rows": counts.get("stream.pad_rows", 0),
            "benchmark_pad_rows": rows - windows,
            "equal": (counts.get("stream.rows", 0) == rows
                      and counts.get("stream.pad_rows", 0) == rows - windows)}


# --- the measurement entry point ---------------------------------------------

def _measure(name: str, seed: int, seconds: float, spans_on: bool) -> Dict:
    import importlib

    import torch

    from benchmark import harness
    cell = harness.load_cell(name)
    ctx = harness.Ctx(cell, seed, torch.device("cuda", 0),
                      time.perf_counter())
    ctx.program.build_kernels(cell["kernels"])
    drv = importlib.import_module(
        f"benchmark.traffic.{cell['generator']}").setup(ctx)
    e2e = drv.run(seconds)
    untraced = {k: 1e3 * sum(v) / len(v) for k, v in ctx.spans.seconds.items()}
    ctx.spans.on = False
    traced: Dict = {}
    got = capture(lambda: traced.update(drv.traced(cell["trace"])),
                  program_tracer() if spans_on else None)
    drv.free()
    line = {"cell": name, "seed": seed, "spans_on": spans_on,
            "pace": harness.pace(e2e, traced, got.trace),
            "idle_share": 100.0 * (1 - got.trace.busy_s / got.trace.window_s),
            "untraced_host_ms": untraced}
    at = got.attribution
    if at is not None:
        line.update(at.notes())
        line["quantities"] = at.quantities(own_kernels())
        if cell["generator"] == "stream":
            line["stream_rows"] = stream_rows_check(
                at.counts, traced["batches"], traced["windows"])
    return line


def main(argv=None) -> int:
    import argparse
    import subprocess
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--spans", type=int, choices=(0, 1), default=1)
    p.add_argument("--out", default=None,
                   help="also append the line to this file")
    args = p.parse_args(argv)
    line = _measure(args.workload, args.seed, args.seconds, bool(args.spans))
    line["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
