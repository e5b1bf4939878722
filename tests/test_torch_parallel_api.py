"""vdiff_tpu_torch.parallel without a process group, and its dry run: the
package imports no JAX; row splits, batch shards and the split sampler's
noise draws; the per-process loader against the JAX package's for several
process counts; the CLIs' multi-GPU refusals outside torchrun (the
model-parallel modes' too) and the fused switches the model-parallel modes
refuse; ``dryrun_multichip(2)`` on the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_parallel_imports_no_jax():
    code = ("import sys\n"
            "import vdiff_tpu_torch.parallel, vdiff_tpu_torch.parallel.dryrun\n"
            "bad = [m for m in ('jax', 'flax', 'optax', 'orbax', 'vdiff_tpu') if m in sys.modules]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_row_range_and_shard_batch():
    from vdiff_tpu_torch.parallel.mesh import row_range, shard_batch

    assert [row_range(12, r, 3) for r in range(3)] == [(0, 4), (4, 8), (8, 12)]
    with pytest.raises(ValueError, match="does not split"):
        row_range(10, 0, 4)
    x = np.arange(6)
    got_x, got_none = shard_batch(x, None)  # one process keeps the whole batch
    assert np.array_equal(got_x, x) and got_none is None


def test_draw_rows_is_the_whole_batch_draw_sliced():
    """A rank's noise is its rows of the whole batch's draw from the same
    generator, zeros in the padding past the batch, and the generator ends
    where the whole draw leaves it."""
    from vdiff_tpu_torch.diffusion import draw_rows

    whole = torch.randn((5, 2, 3), generator=torch.Generator().manual_seed(1))
    for start, want in ((0, whole[:3]), (3, torch.cat([whole[3:], torch.zeros(1, 2, 3)]))):
        g = torch.Generator().manual_seed(1)
        got = draw_rows((3, 2, 3), g, "cpu", torch.float32, (start, 5))
        assert torch.equal(got, want)
        out = torch.full((3, 2, 3), 7.0)
        draw_rows((3, 2, 3), torch.Generator().manual_seed(1), "cpu", torch.float32,
                  (start, 5), out=out)
        assert torch.equal(out, want)
        assert torch.equal(torch.rand(2, generator=g),
                           torch.rand(2, generator=_after_whole_draw()))
    g = torch.Generator().manual_seed(1)
    assert torch.equal(draw_rows((5, 2, 3), g, "cpu", torch.float32), whole)


def _after_whole_draw():
    g = torch.Generator().manual_seed(1)
    torch.randn((5, 2, 3), generator=g)
    return g


@pytest.mark.parametrize("count", [2, 3])
def test_process_shards_match_jax_dataloader(count):
    """Each process's batches over two epochs, flips on: the port's
    DataLoader(process_index, process_count) gives the JAX package's."""
    pytest.importorskip("jax")
    from vdiff_tpu import data as jdata
    from vdiff_tpu_torch import data

    ref_ds = jdata._build_dataset("synthetic", "", "train")
    ds = data._build_dataset("synthetic", "", "train")
    ref_ds.random_flip = ds.random_flip = True
    for index in range(count):
        ref = jdata.DataLoader(ref_ds, batch_size=48, seed=5, process_index=index,
                               process_count=count)
        got = data.DataLoader(ds, batch_size=48, seed=5, process_index=index,
                              process_count=count)
        assert len(got) == len(ref) == 512 // count // 48
        for epoch in range(2):
            ref.set_epoch(epoch)
            got.set_epoch(epoch)
            batches = list(zip(got, ref))
            assert len(batches) == len(ref)
            for (x, y), (rx, ry) in batches:
                np.testing.assert_array_equal(x, rx)
                np.testing.assert_array_equal(y, ry)


@pytest.mark.parametrize("argv", [
    ["--tp"], ["--spatial-shard"], ["--dp", "--tp"], ["--dp"]])
def test_generate_refusals(argv, monkeypatch):
    """--dp cannot combine with --tp or --spatial-shard; outside torchrun
    each of the three stops naming the launcher."""
    from vdiff_tpu_torch.generate import main

    monkeypatch.delenv("RANK", raising=False)
    match = "torchrun"
    if argv == ["--dp", "--tp"]:
        match = "cannot combine"
    with pytest.raises(SystemExit, match=match):
        main(["--config-path", "x.json", "--ckpt-path", "x.pt", "--device", "cpu", *argv])


@pytest.mark.parametrize("env,argv,match", [
    ({"VDIFF_FUSED_CONV": "1"}, ["--tp"], "--tp cannot run VDIFF_FUSED_CONV=1"),
    ({"VDIFF_FUSED_CONV": "1"}, ["--spatial-shard"], "--spatial-shard cannot run VDIFF_FUSED_CONV"),
    ({"VDIFF_FUSED_GN": "1"}, ["--spatial-shard"], "--spatial-shard cannot run VDIFF_FUSED_GN=1"),
    ({"VDIFF_FUSED_GN": "1"}, ["--tp"], "torchrun"),  # allowed: B10 runs on whole activations
], ids=["tp-conv", "sp-conv", "sp-gn", "tp-gn-allowed"])
def test_generate_model_parallel_fused_switches(env, argv, match, monkeypatch):
    """The fused switches a model-parallel mode cannot run stop the CLI
    before anything runs; VDIFF_FUSED_GN=1 under --tp goes on (here to the
    torchrun refusal)."""
    from vdiff_tpu_torch.generate import main

    monkeypatch.delenv("RANK", raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    with pytest.raises(SystemExit, match=match):
        main(["--config-path", "x.json", "--ckpt-path", "x.pt", "--device", "cpu", *argv])


def test_dryrun_multichip_two_ranks(capfd):
    from vdiff_tpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(2, device="cpu")
    out = capfd.readouterr().out
    assert "dryrun_multichip(2) on cpu: DDP loss" in out
    assert "TP and SP forwards within 0.0001 of the plain forward, TP parameter bytes" in out


def test_dryrun_multichip_on_cuda_needs_a_card_a_rank(monkeypatch):
    """Without --device cpu the dry run asks for a GPU a rank and stops,
    naming the count it found, where there are fewer: no quiet gloo run."""
    from vdiff_tpu_torch.parallel.dryrun import dryrun_multichip

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="needs 2 GPUs, found 1"):
        dryrun_multichip(2)


def test_resolve_fsdp_axis():
    """The state shards over the hybrid mesh's minor "fsdp" axis, else over
    the 1-D mesh's "data" axis, as in the JAX package."""
    from types import SimpleNamespace

    from vdiff_tpu_torch.parallel import DATA_AXIS, FSDP_AXIS, resolve_fsdp_axis

    assert resolve_fsdp_axis(SimpleNamespace(mesh_dim_names=("data", "fsdp"))) == FSDP_AXIS
    assert resolve_fsdp_axis(SimpleNamespace(mesh_dim_names=("data",))) == DATA_AXIS
