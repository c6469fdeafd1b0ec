"""A share of the card's peak: the analytic FLOPs of the windows an
end-to-end rate counts (``benchmark/work.py::forward_flops`` times
``passes``: 1 for a forward, 3 for a train step's forward and two
backward products) at that rate, over the peak FLOP/s of the
configuration's compute dtype.  Spec: ``rate`` (an end-to-end metric in
windows/s, taken outside the traced sub-window) and ``passes``."""

from benchmark import work


def read(spec, r):
    rate = r.e2e.get(spec["rate"])
    if not rate:
        return None
    flops = spec["passes"] * work.forward_flops(r.cfg) * rate
    return 100.0 * flops / work.PEAK_FLOPS[r.cfg["compute_dtype"]]
