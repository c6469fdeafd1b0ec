"""The device's idle share of the traced sub-window, in percent:
``1 - busy / window``, busy the union of every device operation's
interval (kernels, copies, fills), so that overlaps count once."""


def read(spec, r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
