"""Device kernels per train step: the kernel events of the traced window
(copies and sets left out) over the steps in it."""


def read(run):
    if not run.units:
        return None
    n = run.trace.kernel_count()
    return n / run.units if n else None
