"""Tracing and timing utilities (counterpart of ``vdiff_tpu/utils/profiling.py``).

* :func:`trace` — context manager around ``torch.profiler`` (CPU and, on a
  CUDA host, CUDA activities) that writes a Chrome/TensorBoard trace into
  ``log_dir``.
* :func:`annotate` — a named region that shows up in traces:
  ``torch.profiler.record_function``, plus an NVTX range on CUDA.
* :func:`benchmark` — per-iteration times of ``fn(*args)`` after a warm-up,
  the dict the JAX package's ``benchmark`` returns. On CUDA (the default) it
  records a CUDA event between iterations and synchronises once, after the
  last; on the CPU it reads ``time.perf_counter``.
* :func:`device_memory_stats` — per-device memory in bytes, the JAX
  package's keys.
* :func:`device_us` — the device time of one ``key_averages()`` event of a
  trace, the filter the profile scripts sum.

The JAX package's ``xla_dump`` has no counterpart: PyTorch runs eagerly and
compiles no XLA programs, and the port's kernels are built by ``nvcc``
(``vdiff_tpu_torch/kernels.py``, whose flags can be read there).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` and write its trace as a
    ``*.pt.trace.json`` file into ``log_dir`` (open it in TensorBoard or
    chrome://tracing). Yields the profiler, whose ``key_averages()`` give the
    sums by kernel."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str):
    """Named trace region: ``with annotate('data-load'): ...``."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


def benchmark(fn: Callable, *args, warmup: int = 2, iters: int = 10, device="cuda") -> dict:
    """Time ``fn(*args)`` ``iters`` times after ``warmup`` calls; returns the
    seconds of one call as ``mean``, ``median``, ``min`` and ``max``, and
    ``iters``. On a CUDA ``device`` each call is timed on the device between
    two CUDA events, and the host waits once, after the last call: the times
    are those of the work the calls queued, whenever the host issued it. On
    the CPU each call is timed on the host clock."""
    device = torch.device(device)
    for _ in range(warmup):
        fn(*args)
    if device.type == "cuda":
        with torch.cuda.device(device):
            torch.cuda.synchronize()
            events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
            events[0].record()
            for ev in events[1:]:
                fn(*args)
                ev.record()
            events[-1].synchronize()
            times = [a.elapsed_time(b) / 1e3 for a, b in zip(events, events[1:])]
    else:
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    mean = sum(times) / len(times)
    times.sort()
    return {"mean": mean, "median": times[len(times) // 2], "min": times[0], "max": times[-1],
            "iters": iters}


def device_memory_stats() -> dict:
    """Per-device memory (bytes) of every visible CUDA device: what PyTorch's
    allocator holds now and at its peak, and the device's total memory. Empty
    where no CUDA device is visible."""
    stats = {}
    for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        s = torch.cuda.memory_stats(i)
        _, total = torch.cuda.mem_get_info(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_limit": total,
        }
    return stats


def device_us(evt) -> float:
    """Device time (µs) of a kernel or memcpy event of ``key_averages()``; 0
    for host-side (aten) events and for user ranges on the device timeline
    (``annotate`` regions, ``Optimizer.step#AdamW.step``), whose device time
    would count their kernels a second time."""
    if not str(evt.device_type).endswith("CUDA") or getattr(evt, "is_user_annotation", False):
        return 0
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0)
