"""A share of one counter in another, in percent, counted outside the
traced sub-window.  Spec: ``part`` and ``whole`` (counter names), and
``complement`` (true: the share of the whole that is not the part)."""


def read(spec, r):
    whole = r.spans.counts.get(spec["whole"], 0)
    if not whole:
        return None
    part = r.spans.counts.get(spec["part"], 0)
    share = part / whole
    return 100.0 * (1.0 - share if spec.get("complement") else share)
