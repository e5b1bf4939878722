"""vdiff_tpu_torch.utils.profiling on the CPU: the timing dict of the JAX
package's ``benchmark``, a ``span`` region in a profiler's exported trace,
and imports free of JAX (``tests/test_torch_spans.py`` holds the spans)."""

import os
import sys

import torch

import procs

pytest_plugins = ["torch_limits"]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_benchmark_on_the_cpu_returns_the_root_keys_in_order():
    from vdiff_tpu_torch.utils.profiling import benchmark

    calls = []
    a = torch.randn(64, 64)
    out = benchmark(lambda m: calls.append(m @ m), a, warmup=2, iters=5, device="cpu")
    assert set(out) == {"mean", "median", "min", "max", "iters"}
    assert out["iters"] == 5 and len(calls) == 7
    assert 0 < out["min"] <= out["median"] <= out["max"]
    assert out["min"] <= out["mean"] <= out["max"]


def test_trace_writes_a_trace_with_the_annotated_region(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    from vdiff_tpu_torch.utils.profiling import span

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("vdiff-region"):
            torch.randn(32, 32) @ torch.randn(32, 32)
    names = [e.key for e in prof.key_averages()]
    assert "vdiff-region" in names
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    assert os.path.getsize(path) > 0
    with open(path) as f:
        assert "vdiff-region" in f.read()


def test_profiling_and_bench_import_no_jax():
    """In a fresh interpreter: neither module pulls in JAX or the JAX package."""
    code = (
        "import importlib, sys\n"
        "for m in ('vdiff_tpu_torch.utils.profiling', 'vdiff_tpu_torch.bench'): "
        "importlib.import_module(m)\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'orbax', 'vdiff_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    p = procs.start([sys.executable, "-c", code], cwd=REPO)
    ((out, _),) = procs.wait_all([p])
    assert p.returncode == 0, out
