"""BENCHMARK.json against the rules of its format, every cell and metric
resolving to its files, and a new cell, mix and metric added as new files
alone."""

import hashlib
import json
import os
import re
import shutil

import pytest

from portbench.core.jobs import JOBS
from portbench.core.spec import benchmark, load_cell, metric_reader
from portbench_cells import CELLS, ROOT

BENCH = benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = 24  # a full check of the most cells any later PR may hold fits its time
    runs = 2 + 14 * cells
    assert runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_entries_keep_to_the_format():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[key]]
    assert len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/") and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] == 1
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves(name):
    cell = load_cell(name, ROOT)
    assert cell.traffic["job"] in JOBS
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(metric_reader(m["name"], ROOT))
    assert cell.limits["limits"] and cell.limits["compare"]
    for k in cell.config["reduced"]:
        assert k in cell.config


def test_per_layer_metrics_move_metrics_their_cells_report():
    for m in BENCH["per_layer"]:
        for w in m["workloads"]:
            assert m["moves"] in {x["name"] for x in load_cell(w, ROOT).end_to_end}


def _digests(root):
    out = {}
    for base, _, files in os.walk(os.path.join(root, "portbench")):
        if "__pycache__" in base:
            continue
        for f in files:
            with open(os.path.join(base, f), "rb") as fh:
                out[os.path.relpath(os.path.join(base, f), root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_a_new_cell_mix_and_metric_are_new_files_alone(tmp_path):
    """A throwaway configuration, traffic mix, limits and per-layer metric,
    added as files and entries to a copy of the benchmark, resolve and run
    (on the CPU, cut to a tiny size) without a change to any file the
    benchmark has."""
    root = str(tmp_path)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "portbench"), os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(root)
    pb = os.path.join(root, "portbench")
    config = json.load(open(os.path.join(pb, "configs", "cifar10_cond.json")))
    config["model"].update(hid_channels=32, ch_multipliers=[1, 2], num_res_blocks=1,
                           apply_attn=[False, True])
    config["data"]["resolution"] = 16
    json.dump(config, open(os.path.join(pb, "configs", "tiny_cond.json"), "w"))
    traffic = json.load(open(os.path.join(pb, "traffic", "sample_cfg_b128.json")))
    traffic.update(batch=4, steps=2, dtype="float32")
    json.dump(traffic, open(os.path.join(pb, "traffic", "sample_b4.json"), "w"))
    json.dump({"compare": {"rows": 2, "block": 2}, "limits": {"sample_rms": 1e-3}},
              open(os.path.join(pb, "limits", "tiny_cond.sample_b4.json"), "w"))
    with open(os.path.join(pb, "metrics", "calls_in_window.sample.py"), "w") as f:
        f.write("def read(run):\n    return float(run.units)\n")
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["configs"].append({"name": "tiny_cond", "source": "test", "why": "test",
                             "file": "portbench/configs/tiny_cond.json", "reduced": []})
    bench["workloads"].append({"name": "tiny_cond.sample_b4", "config": "tiny_cond",
                               "traffic": "sample_b4", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("samples_per_s",):
            m["workloads"].append("tiny_cond.sample_b4")
    bench["per_layer"].append({"name": "calls_in_window.sample", "unit": "calls",
                               "better": "higher", "source": "host_clock", "layer": "CLI loops",
                               "moves": "samples_per_s", "workloads": ["tiny_cond.sample_b4"]})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    after = _digests(root)
    assert all(after[k] == v for k, v in before.items())

    from portbench.core.runner import run_cell

    cell = load_cell("tiny_cond.sample_b4", root)
    assert [m["name"] for m in cell.per_layer] == ["calls_in_window.sample"]
    result = run_cell(cell, 3, 0.0, True, "cpu", setup_clock=lambda: 1.0, log=lambda *a, **k: 0)
    assert result["correct"], result["checks"]
    assert result["metrics"]["calls_in_window.sample"]["value"] >= 1
