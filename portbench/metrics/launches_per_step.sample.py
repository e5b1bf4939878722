"""Launches of the program's hand-written kernels per sampler step on the
device, from ``p_sample``'s ``stats`` (each kernel wrapper's launches in the
eager steps and the graph replays) over the steps run."""


def read(run):
    if not run.stats:
        return None
    steps = run.stats.get("eager_steps", 0) + run.stats.get("replays", 0)
    if not steps:
        return None
    launches = sum(run.stats["launches"].values())
    return launches / steps if launches else None
