"""The port's quality gate (``python -m vdiff_tpu_torch.quality_gate``), the
counterpart of ``scripts/quality_gate.py``: its checkpoint pick against the
port's ``CheckpointManager.latest_path`` (the twin of
tests/test_train_lib.py::test_latest_path_orders_numerically_and_skips_tmp_dirs),
its flags against the JAX gate's (both parsers read, the JAX one with
``ast``), one whole train → generate → eval run on the CPU, and a failing
stage ending the gate with that stage's exit code. Imports nothing of JAX."""

import ast
import json
import math
import os
import subprocess
import sys
import tempfile

import procs

pytest_plugins = ["torch_limits"]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gate(cwd, *args, code=None):
    """The gate in a subprocess from ``cwd`` (the repository on PYTHONPATH);
    ``code``, where given, runs in place of
    ``-m vdiff_tpu_torch.quality_gate``."""
    env = dict(os.environ, PYTHONPATH=REPO)
    cmd = [sys.executable] + (["-c", code] if code else ["-m", "vdiff_tpu_torch.quality_gate"])
    p = procs.start(cmd + list(args), cwd=cwd, env=env, stderr=subprocess.PIPE)
    ((out, err),) = procs.wait_all([p])
    return subprocess.CompletedProcess(p.args, p.returncode, out, err)


def test_latest_ckpt_is_the_checkpoint_managers_pick(tmp_path):
    """The newest run by mtime; in it ckpt_last outranks every epoch, ckpt_10
    outranks ckpt_9 (numeric order), and an interrupted save's temporary file
    is never picked: the gate's pick is CheckpointManager.latest_path's."""
    from vdiff_tpu_torch.quality_gate import latest_ckpt
    from vdiff_tpu_torch.train_lib import CheckpointManager

    exps = tmp_path / "exps"
    old, new = exps / "2026-01-01T000000", exps / "2026-01-02T000000"
    for run, names in ((old, ["ckpt_99.pt"]), (new, ["ckpt_1.pt", "ckpt_9.pt", "ckpt_10.pt",
                                                     "ckpt_last.pt", "ckpt_11.pt.123.tmp"])):
        (run / "ckpts").mkdir(parents=True)
        for name in names:
            (run / "ckpts" / name).write_bytes(b"")
    os.utime(old, (1, 1))
    mgr = CheckpointManager(str(new / "ckpts"))
    assert latest_ckpt(str(exps)) == mgr.latest_path() == str(new / "ckpts" / "ckpt_last.pt")
    (new / "ckpts" / "ckpt_last.pt").unlink()
    assert latest_ckpt(str(exps)) == mgr.latest_path() == str(new / "ckpts" / "ckpt_10.pt")
    for name in ("ckpt_1.pt", "ckpt_9.pt", "ckpt_10.pt"):
        (new / "ckpts" / name).unlink()
    assert mgr.latest_path() is None  # only the temporary file is left
    try:
        latest_ckpt(str(exps))
    except FileNotFoundError as e:
        assert "no checkpoints" in str(e)
    else:
        raise AssertionError("the gate picked a temporary file")


def _jax_gate_options():
    """{option: its add_argument keywords, literal values} of scripts/quality_gate.py."""
    with open(os.path.join(REPO, "scripts", "quality_gate.py")) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument":
            kw = {k.arg: k.value.id if isinstance(k.value, ast.Name) else ast.literal_eval(k.value)
                  for k in node.keywords if k.arg != "help"}
            out[node.args[0].value] = kw
    return out


def test_gate_flags_are_the_jax_gates():
    """Every option of the JAX gate with its type, action, nargs and default,
    and no other, but --platform → --device (default cuda). Defaults naming
    the JAX package's configs name the port's copies; the work directory
    lies under the temporary directory (/tmp unless TMPDIR says otherwise)."""
    from vdiff_tpu_torch.quality_gate import build_parser

    jax_opts = _jax_gate_options()
    assert len(jax_opts) == 18 and "--platform" in jax_opts
    port = {a.option_strings[0]: a for a in build_parser()._actions if a.option_strings
            and a.option_strings[0] != "-h"}
    assert set(port) == set(jax_opts) - {"--platform"} | {"--device"}
    assert port["--device"].default == "cuda" and port["--device"].type is None
    for flag, kw in jax_opts.items():
        if flag == "--platform":
            continue
        a = port[flag]
        assert (a.type.__name__ if a.type else None) == kw.get("type"), flag
        store_true = kw.get("action") == "store_true"
        assert a.nargs == (0 if store_true else kw.get("nargs")), flag
        assert (a.const is True) == store_true, flag
        want = kw.get("default", False if store_true else None)
        if flag == "--config":
            want = want.replace("vdiff_tpu/", "vdiff_tpu_torch/")
        if flag == "--work-dir":
            assert os.path.dirname(a.default) == tempfile.gettempdir()
            assert os.path.basename(a.default) == os.path.basename(want)
            continue
        assert a.default == want, flag


def test_gate_runs_the_chain_on_the_cpu(tmp_path):
    """synthetic_smoke on the CPU: train writes ckpt_last.pt, generate 8 PNGs
    from it, eval skips fid (no FID statistics or Inception weights here) with
    the CLI's message and computes a finite nll; the last line is the JSON."""
    work = tmp_path / "gate"
    proc = _gate(tmp_path, "--device", "cpu", "--work-dir", str(work), "--total-size", "8",
                 "--sample-timesteps", "4", "--eval-total-size", "8", "--metrics", "fid", "nll")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    last = json.loads(lines[-1])
    assert last["quality_gate"] == "ok"
    assert last["checkpoint"].startswith(str(work / "exps" / "dpm_synthetic_smoke"))
    assert last["checkpoint"].endswith(os.path.join("ckpts", "ckpt_last.pt"))
    images = last["images"]
    assert images.startswith(str(work / "images" / "synthetic_smoke"))
    assert len([f for f in os.listdir(images) if f.endswith(".png")]) == 8
    assert [line.split(":")[0] for line in lines if line.startswith("=== ")] == [
        "=== train", "=== generate", "=== eval"]
    assert any(line.startswith("FID skipped: ") for line in lines)
    nll = [float(line.split()[1]) for line in lines if line.startswith("NLL: ")]
    assert len(nll) == 1 and math.isfinite(nll[0])
    with open(os.path.join(images, "eval_summary.json")) as f:
        summary = json.load(f)
    assert summary["results"] == {"nll": nll[0]}


def test_gate_stops_at_a_failing_stage(tmp_path):
    """An explicit --ckpt-path that does not exist skips train; the generate
    stage exits non-zero, and the gate exits with its code, names the stage,
    runs no eval stage and prints no JSON line. The gate's own process
    imported no torch."""
    missing = str(tmp_path / "missing.pt")
    code = ("import runpy, sys\n"
            "try:\n"
            "    runpy.run_module('vdiff_tpu_torch.quality_gate', run_name='__main__')\n"
            "finally:\n"
            "    print('gate imported torch:', 'torch' in sys.modules, file=sys.stderr)\n")
    proc = _gate(tmp_path, "--device", "cpu", "--work-dir", str(tmp_path / "gate"),
                 "--ckpt-path", missing, code=code)
    failed = [line for line in proc.stdout.splitlines() if line.startswith("quality gate FAILED")]
    assert failed == [f"quality gate FAILED at stage 'generate' (exit {proc.returncode})"]
    assert proc.returncode != 0
    assert "=== train" not in proc.stdout and "=== eval" not in proc.stdout
    assert "quality_gate" not in proc.stdout.splitlines()[-1]
    assert "gate imported torch: False" in proc.stderr
