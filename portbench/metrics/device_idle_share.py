"""The share of the traced window in which nothing ran on the device, in
percent: 1 - (the union of the intervals of the device's kernels, copies and
sets) / the window's span."""


def read(run):
    if run.window_s <= 0:
        return None
    busy = run.trace.busy_s()
    return 100.0 * (1.0 - busy / run.window_s) if busy > 0 else None
