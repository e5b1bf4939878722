"""One run of one cell: set-up, the window (under the profiler with
``trace``), the per-layer metrics, the check against the reference, and the
result line's dictionary. ``run.py`` adds the look for a chip and the look
for JAX around it; the tests call :func:`run_cell` on the CPU."""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from . import roofline
from .jobs import JOBS, sync
from .spec import Cell, metric_reader
from .trace import WINDOW, profiled, reduce

GIB = float(2**30)


class RunView:
    """What a per-layer metric's reader sees of a traced run: the cell's
    traffic mix and configuration (the reference's flat view),
    the work units of the window (calls or steps), the trace and the
    program's counters."""

    def __init__(self, job, trace, stats):
        self.traffic, self.cfg = job.tr, job.cfg
        self.units = job.units
        self.trace, self.stats = trace, stats
        self.window_s = trace.window_s
        self.peak_flops = roofline.PEAK_FLOPS[job.tr["dtype"]]
        self._job = job

    def flops(self) -> float:
        """The model operations of the traced window's work."""
        return self._job.flops_per_unit() * self.units

    def attention_least_s(self) -> float:
        """The least time of the traced window's attention calls."""
        return self._job.attention_least_s_per_unit() * self.units


def _failed_items(job, numbers: dict, limits: dict) -> int:
    """The compared items of a run that is not correct that are wrong: the
    sampled rows over a per-row limit, else every row or checked step."""
    per_row = [("row_rms", "sample_rms"), ("row_max", "sample_max")]
    rows = {i for key, limit in per_row if limit in limits
            for i, v in enumerate(numbers.get(key, [])) if not v <= limits[limit]}
    return len(rows) or len(numbers.get("row_rms", [])) or job.tr["checked_steps"]


def _memory_peak(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def device_info(device, peak: int) -> dict:
    device = torch.device(device)
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             setup_clock: Callable[[], float], fault: Optional[str] = None, log=print) -> dict:
    """Run ``cell`` once and return the result line's dictionary.
    ``setup_clock()`` gives the seconds since the process started."""
    job = JOBS[cell.traffic["job"]](cell, seed, device, fault)
    job.setup()
    sync(device)
    setup_peak = _memory_peak(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = setup_clock()
    with profiled(trace) as prof:
        with torch.profiler.record_function(WINDOW):
            e2e = job.window(seconds)
    window_peak = _memory_peak(device)
    log(f"window: {job.units} {'calls' if job.tr['job'] == 'sample' else 'steps'}, "
        f"{job.elapsed:.3f} s, set-up {setup_s:.3f} s ("
        + ", ".join(f"{name} {s:.3f} s" for name, s in job.phases) + ")", flush=True)
    metrics = {}
    if trace:
        tr = reduce(prof)
        view = RunView(job, tr, getattr(getattr(job, "sampler", None), "stats", None))
        for m in cell.per_layer:
            value = metric_reader(m["name"], cell.root)(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e["peak_mem_gib"] = window_peak / GIB
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    numbers = job.check()
    limits = cell.limits["limits"]
    checks = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": job.attempted,
              "failed": 0 if correct else _failed_items(job, numbers, limits),
              "metrics": metrics, "device": device_info(device, max(setup_peak, window_peak))}
    if trace:
        result["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    result["checks"] = checks
    return result
