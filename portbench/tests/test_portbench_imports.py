"""What the benchmark imports: nothing of JAX or the JAX package anywhere,
nothing of the program in the reference, and a run that finds JAX, or no
card, or no program, fails without a result."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

from portbench_cells import ROOT

PB = os.path.join(ROOT, "portbench")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


def _sources(sub=""):
    for base, _, files in os.walk(os.path.join(PB, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        for top, level in _imports(path):
            assert level or top not in ("jax", "jaxlib", "flax", "vdiff_tpu"), (path, top)


def test_the_reference_imports_only_torch_numpy_and_itself():
    for path in _sources("reference"):
        for top, level in _imports(path):
            assert level == 1 or top in ("__future__", "math", "typing", "numpy", "torch"), \
                (path, top)


def test_only_the_program_adapter_imports_the_program():
    for path in _sources("core"):
        names = {top for top, level in _imports(path) if not level}
        if os.path.basename(path) != "program.py":
            assert "vdiff_tpu_torch" not in names, path
    src = open(os.path.join(PB, "core", "program.py")).read()
    assert "vdiff_tpu_torch" in src


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.reference.unet, portbench.reference.steps, "
            "portbench.reference.precision\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'vdiff_tpu_torch', 'vdiff_tpu', 'jax', 'jaxlib', 'flax'}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    sys.path.insert(0, PB)
    import run

    base = {k: v for k, v in sys.modules.items()
            if k.split(".")[0] not in run.FORBIDDEN}
    monkeypatch.setattr(sys, "modules", dict(base, vdiff_tpu_torch=sys, **{
        "vdiff_tpu_torch.ops": sys, "jax_helpers": sys}))
    assert run.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", dict(base, **{"vdiff_tpu.ops": sys, "jaxlib": sys}))
    assert run.forbidden_modules() == ["jaxlib", "vdiff_tpu"]


def _run(cwd, *extra):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "cifar10_cond.sample_cfg_b128", "--seed", "3", "--seconds", "1",
                           "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_run_without_a_card_fails_with_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_with_the_benchmark_alone_fails_with_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PB, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
