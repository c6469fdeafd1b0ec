"""The comparison that decides ``correct``, driven on the CPU through a
whole run (set-up, window, check) at small sizes, the look for a card
skipped: the program passes; the control (the reference in float8) and
each fault a cell can have, planted in the reference put in the
program's place, come out as not correct.  And the reduction of a device
trace to busy time, idle gaps and a roofline share."""

import time

import pytest
import torch

from benchmark import devtrace, harness
from benchmark.control import StandIn
from benchmark.metrics import idle, roofline

SMALL = {
    "stream": dict(store_frames=2048, frames=[150, 400], batch=128,
                   check_every=2),
    "sessions": dict(subjects=2, actions=4, frames=32, max_sequences=4,
                     chunk=128, check_every=2),
    "epochs": dict(windows=96, batch=32, check_steps=3, warm_steps=0),
}
SERVE = ("wiflow.stream.b4096", "wiflow_mmfi.serve.b4096")
TRAIN = ("wiflow.train.fused.b2048", "wiflow.train.stock.b2048")


def run(name, program=None, seconds=0.5):
    torch.set_num_threads(2)
    cell = harness.load_cell(name)
    cell["params"] = dict(cell["params"], **SMALL[cell["generator"]])
    return harness.run_cell(cell, 2 ** 31 + 977, seconds, False,
                            torch.device("cpu"), time.perf_counter(),
                            program)


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_program_is_correct(name):
    out = run(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("name,kind", [(n, k) for n in SERVE for k in
                                       ("control", "half", "altered")]
                         + [(n, k) for n in TRAIN[1:] for k in
                            ("control", "half", "unchanged")])
def test_control_and_faults_are_not_correct(name, kind):
    out = run(name, StandIn(kind))
    assert not out["correct"], out["checks"]


SPIN = "void at::cuda::(anonymous namespace)::spin_kernel(long)"


def _events(window=(0, 100)):
    """Marker kernels ending at ``window[0]`` and starting at
    ``window[1]`` (microseconds), three kernels, a runtime call and a host
    operator."""
    ev = [{"ph": "X", "cat": "kernel", "name": SPIN, "ts": window[0] - 3,
           "dur": 3},
          {"ph": "X", "cat": "kernel", "name": SPIN, "ts": window[1],
           "dur": 3}]
    for ts, dur, name in ((10, 20, "void tcn_level_kernel<bf16>(Args)"),
                          (25, 10, "void conv_stack_kernel<bf16>(Args)"),
                          (60, 20, "void tcn_level_kernel<bf16>(Args)")):
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                   "dur": dur})
    ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
               "ts": 40, "dur": 15})
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::copy_",
               "ts": 35, "dur": 30})
    return ev


def test_trace_busy_gaps_and_names():
    tr = devtrace.Trace.from_events(_events())
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(45e-6)       # 10-35 and 60-80
    gaps = sorted(tr.gaps())
    assert [(round(a * 1e6), round(b * 1e6)) for a, b in gaps] == [
        (0, 10), (35, 60), (80, 100)]
    bd = tr.breakdown()
    assert bd["device_ops"][0][0] == "tcn_level_kernel<bf16>"
    assert bd["idle_gaps"][0][0] == "cudaLaunchKernel"   # 35-60, at 47.5


def test_trace_window_between_markers():
    """The window runs from the end of the first marker kernel to the start
    of the last; the markers are not device work of the window, and a gap
    no CUDA call spans is host code."""
    tr = devtrace.Trace.from_events(_events((-2, 95)))
    assert tr.window == pytest.approx((-2e-6, 95e-6))
    assert tr.busy_s == pytest.approx(45e-6)
    assert not tr.kernels("spin_kernel")
    names = dict((round(s * 1e6), n) for n, s in tr.breakdown()["idle_gaps"])
    assert names == {25: "cudaLaunchKernel", 12: "host code, no CUDA call",
                     15: "host code, no CUDA call"}


class _Reading:
    def __init__(self, trace, launches, traced, cfg):
        self.trace, self.launches, self.traced, self.cfg = (
            trace, launches, traced, cfg)
        self.notes = {}


def test_roofline_scales_dropped_launches():
    """Two tcn launches recorded of four counted: the recorded time is
    doubled; none recorded: no reading."""
    cfg = harness.load_cell("wiflow.stream.b4096")["cfg"]
    tr = devtrace.Trace.from_events(_events())
    spec = {"name": "roofline.tcn", "work": "serve.tcn",
            "groups": [{"kernels": "tcn_level_kernel",
                        "calls": "tcn_level_kernel",
                        "counters": ["tcn_level"]}]}
    r = _Reading(tr, {"tcn_level": 4}, {"batches": [1]}, cfg)
    from benchmark import work
    bound = work.serve_bounds(cfg, [1])["tcn"]
    assert roofline.read(spec, r) == pytest.approx(100 * bound / 80e-6)
    assert r.notes["roofline.tcn"]["tcn_level_kernel"]["recorded_calls"] == 2
    r = _Reading(tr, {"tcn_level": 0}, {"batches": [1]}, cfg)
    assert roofline.read(spec, r) is None
    assert idle.read({}, r) == pytest.approx(55.0)
