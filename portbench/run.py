"""Run one cell of the benchmark of ``vdiff_tpu_torch`` once, on this machine's
CUDA card:

    python portbench/run.py --workload cifar10_cond.sample_cfg_b128 --seed 7 \\
        --seconds 10 --trace 0

The cell, its configuration, traffic mix, limits and per-layer metrics are
found by name from ``BENCHMARK.json`` (see ``core/spec.py``). The last line of
standard output is the result as one JSON object; the numbers compared with
the reference go to standard error as its last lines, each beside its limit,
and under ``checks``, the result's last key. With ``--trace 0`` the metrics
are the cell's end-to-end ones, with ``--trace 1`` its per-layer ones, read
from a ``torch.profiler`` trace of the window.

Exits non-zero, printing no result, without a CUDA card (or with fewer than
the cell asks for), when the program cannot be imported, and when a module
of JAX, Flax or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: build and kernel caches at fixed paths inside the checkout
CACHE = os.path.join(ROOT, ".portbench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["USE_FLAX"] = "0"
#: modules whose presence fails the run, by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "vdiff_tpu")


def _process_age() -> float:
    """Seconds since this process was created (``/proc``), or 0 where that
    cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


_T0 = time.perf_counter() - _process_age()


def forbidden_modules() -> list:
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        print(f"--seed must be a whole number of at least 0, got {args.seed}", file=sys.stderr)
        return 2

    sys.path.insert(0, ROOT)
    import torch

    from portbench.core.runner import run_cell
    from portbench.core.spec import load_cell

    cell = load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 3
    import vdiff_tpu_torch  # noqa: F401  (fails here, before any work, without the program)

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                      setup_clock=lambda: time.perf_counter() - _T0,
                      log=lambda *a, **k: print(*a, file=sys.stderr, **k))
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
