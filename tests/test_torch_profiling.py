"""vdiff_tpu_torch.utils.profiling on the CPU: the timing dict of the JAX
package's ``benchmark``, a trace file written by ``trace`` with an
``annotate`` region in it, the memory dict, and imports free of JAX."""

import os
import subprocess
import sys

import torch

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
    from vdiff_tpu_torch.utils.profiling import annotate, trace

    with trace(str(tmp_path)) as prof:
        with annotate("vdiff-region"):
            torch.randn(32, 32) @ torch.randn(32, 32)
    names = [e.key for e in prof.key_averages()]
    assert "vdiff-region" in names
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert files and os.path.getsize(tmp_path / files[0]) > 0
    with open(tmp_path / files[0]) as f:
        assert "vdiff-region" in f.read()


def test_device_memory_stats_is_a_dict_of_the_root_keys():
    from vdiff_tpu_torch.utils.profiling import device_memory_stats

    stats = device_memory_stats()
    assert isinstance(stats, dict)
    for per_device in stats.values():  # empty without a CUDA device
        assert set(per_device) == {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}


def test_profiling_and_bench_import_no_jax():
    """In a fresh interpreter: neither module pulls in JAX or the JAX package."""
    code = (
        "import importlib, sys\n"
        "for m in ('vdiff_tpu_torch.utils.profiling', 'vdiff_tpu_torch.bench'): "
        "importlib.import_module(m)\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'orbax', 'vdiff_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
