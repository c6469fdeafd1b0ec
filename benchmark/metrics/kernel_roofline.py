"""A hand-written kernel's share of its roofline over the traced
sub-window, in percent, for a kernel that the program's launch counters
(``benchmark/program.py::KERNELS``) do not list: the kernel launches once
a call of the served forward, so the calls are the traced sub-window's
(``traced["batches"]``).

Spec: ``kernels`` (a regex of the kernel's device name) and ``work`` (a
module of the benchmark whose ``bound_s(cfg, batches)`` gives the least
seconds of the kernel's work over those calls, from the configuration's
shapes).  The kernel's device time is that of the launches the profiler
recorded, scaled by the calls over the launches recorded (it drops some
short launches).  Where the trace holds no such kernel (a program
without it) the metric gives nothing.
"""

import importlib


def read(spec, r):
    batches = r.traced.get("batches")
    if not batches or r.trace is None:
        return None
    kernels = r.trace.kernels(spec["kernels"])
    if not kernels:
        return None
    device_s = sum(s for _, s in kernels) * len(batches) / len(kernels)
    bound = importlib.import_module(f"benchmark.{spec['work']}").bound_s(
        r.cfg, batches)
    r.notes[spec["name"]] = {"recorded_calls": len(kernels),
                             "counted_calls": len(batches),
                             "device_s": device_s, "bound_s": bound}
    return 100.0 * bound / device_s
