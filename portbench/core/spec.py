"""The benchmark's data: ``BENCHMARK.json`` and the files it names by name.

A cell's configuration is ``configs/<config>.json``, its traffic mix
``traffic/<traffic>.json``, its correctness limits ``limits/<cell>.json``,
and each per-layer metric the reader ``metrics/<metric>.py``, or, for a
metric split by the end-to-end metric it moves (``mfu.train``), the reader
of its quantity ``metrics/<quantity>.py`` (``mfu.py``). Nothing here
lists a cell, a mix or a metric: a new one is a new file and a new entry.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    root: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def benchmark(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: dict, cell: str) -> bool:
    """A metric with a ``workloads`` list applies to those cells; one without
    applies to every cell."""
    return cell in metric.get("workloads", (cell,))


def load_cell(name: str, root: str = ROOT, bench: Optional[dict] = None) -> Cell:
    bench = bench if bench is not None else benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(by_name)}")
    w = by_name[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    here = os.path.join(root, "portbench")
    return Cell(
        name=name,
        root=root,
        config=_load_json(os.path.join(root, conf["file"])),
        traffic=_load_json(os.path.join(here, "traffic", f"{w['traffic']}.json")),
        limits=_load_json(os.path.join(here, "limits", f"{name}.json")),
        chips=w["chips"],
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def metric_reader(name: str, root: str = ROOT):
    """The ``read(run)`` function of ``metrics/<name>.py``, or else of
    ``metrics/<quantity>.py`` for a name ``<quantity>.<part>``."""
    path = os.path.join(root, "portbench", "metrics", f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(root, "portbench", "metrics", f"{name.split('.', 1)[0]}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def sub_seed(seed: int, *words) -> int:
    """A 63-bit seed for one purpose (a word list of strings and numbers)
    derived from the run's seed, the same on every machine."""
    entropy = [int(seed) & (2**64 - 1), int(seed) >> 64]
    for w in words:
        entropy.append(w if isinstance(w, int) else int.from_bytes(str(w).encode(), "little"))
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0] >> 1)


def model_cfg(config: dict) -> Dict:
    """The reference's flat view of a configuration file: the model's
    widths, its label kind, the head and the log-SNR range."""
    m = dict(config["model"])
    d, data = config["diffusion"], config["data"]
    m.update(in_channels=data["channels"], num_classes=data.get("num_classes", 0),
             multitags=data.get("multitags", False), tag_rate=data.get("tag_rate", 0.0),
             resolution=data["resolution"],
             head=d["model_out_type"], logsnr_min=d["logsnr_min"], logsnr_max=d["logsnr_max"],
             out_channels=data["channels"] * (2 if d["model_out_type"] == "both" else 1))
    return m
