"""Mean host milliseconds of one of the benchmark's spans, taken outside
the traced sub-window.  Spec: ``span`` (its name)."""

import statistics


def read(spec, r):
    values = r.spans.seconds.get(spec["span"])
    if not values:
        return None
    return statistics.fmean(values) * 1e3
