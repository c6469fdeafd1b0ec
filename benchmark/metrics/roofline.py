"""An op's share of its roofline over the traced sub-window, in percent:
the least time the card could take for the op's work, worked out from
the configuration's shapes (``benchmark/work.py``), over the device time
of the kernels that run it.

Spec:

* ``work``: ``serve.<op>`` (the op over the traced sub-window's calls of
  the served forward, at each call's rows) or ``train.<op>`` (over the
  traced steps);
* ``groups``: the op's kernels, each group ``{"kernels": regex of every
  device kernel its entry points launch, "calls": regex of the one kernel
  each call launches once, "counters": the program's launch counters of
  those entry points}``.

The profiler drops some short launches, so a group's time is the time of
the kernels it recorded, scaled by the calls counted over the calls
recorded.  A group with no recorded call gives nothing, and so does the
metric.
"""

from benchmark import work


def bound_s(spec, r):
    kind, op = spec["work"].split(".", 1)
    if kind == "serve":
        batches = r.traced.get("batches")
        return work.serve_bounds(r.cfg, batches)[op] if batches else None
    steps = r.traced.get("steps")
    if not steps:
        return None
    return steps * work.train_step_bounds(r.cfg, r.traced["batch"])[op]


def read(spec, r):
    bound = bound_s(spec, r)
    if not bound or r.trace is None:
        return None
    total = 0.0
    notes = {}
    for g in spec["groups"]:
        kernels = r.trace.kernels(g["kernels"])
        recorded = len(r.trace.kernels(g["calls"]))
        counted = sum(r.launches.get(c, 0) for c in g["counters"])
        notes[g["calls"]] = {"recorded_calls": recorded,
                             "counted_calls": counted,
                             "recorded_kernels": len(kernels)}
        if not recorded or not counted:
            return None
        total += sum(s for _, s in kernels) * counted / recorded
    r.notes[spec["name"]] = dict(notes, device_s=total, bound_s=bound)
    return 100.0 * bound / total
