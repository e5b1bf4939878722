"""The port's model-parallel serving modes on the CPU (vdiff_tpu_torch.parallel.tp,
.spatial, generate --tp / --spatial-shard), the twin of tests/test_tp.py.

The sharding rule against JAX's ``tp_param_shardings`` runs in this process.
One launch of tests/torch_parallel_worker.py on two gloo ranks runs the TP,
SP and TP+SP forwards, the 4-step CFG trajectories and the generate CLI,
while this process compiles JAX's forwards and samplers on a 2-device mesh
(``tp_shard_params``, ``spatial_constraint``) of the 8 CPU devices
tests/conftest.py provides; a second launch on four ranks runs the SP forward
at two rows a rank. Each port result is held within 1e-5 of the port's one-rank
result (the same math; the reductions split over ranks) and within 1e-4 of
JAX's (tests/test_torch_unet.py's bound against JAX)."""

import functools
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tests import torch_parallel_setup as S  # noqa: E402

ONE_RANK_TOL = 1e-5  # a port mode against the port's one-rank run
JAX_TOL = 1e-4  # against JAX's mode on its 2-device mesh
PHASES = ("tp_forward", "tp_sample", "tp_generate")


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("tp_two_ranks")
    setup = S.write_tp_setup(workdir)
    return setup, S.Ranks(workdir, 2, PHASES)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("tp_four_ranks")
    S.write_tp_setup(workdir)
    return S.Ranks(workdir, 4, ("tp_forward",))


def _mesh(n=2):
    from vdiff_tpu.parallel.tp import create_tp_mesh

    return create_tp_mesh(devices=jax.devices()[:n])


@functools.lru_cache(maxsize=None)
def _jax_forward(mode):
    """JAX's forward of the same weights and inputs on the 2-device mesh:
    TP params, a height-sharded x, or both."""
    from vdiff_tpu.parallel.spatial import spatial_constraint
    from vdiff_tpu.parallel.tp import tp_shard_params

    model, params = S.jax_tp_model_and_params()
    mesh = _mesh()
    params = jax.tree.map(jnp.asarray, params)
    if "tp" in mode:
        params = tp_shard_params(mesh, params)
    constrain = "sp" in mode

    def fwd(p, x, t, y):
        if constrain:
            x = spatial_constraint(x, mesh)
        return model.apply({"params": p}, x, t, y, train=False)

    x, t, y = S.tp_inputs()[:3]
    return np.asarray(jax.jit(fwd)(params, x, t, y))


def _jax_sample(mode):
    """JAX's 4-step DDIM trajectory with CFG (w=0.3) from the same x_T."""
    from vdiff_tpu.diffusion import GaussianDiffusion
    from vdiff_tpu.ops.numerics import get_logsnr_schedule
    from vdiff_tpu.parallel.spatial import spatial_constraint
    from vdiff_tpu.parallel.tp import tp_shard_params

    model, params = S.jax_tp_model_and_params()
    mesh = _mesh()
    params = jax.tree.map(jnp.asarray, params)
    if mode == "tp":
        params = tp_shard_params(mesh, params)
    diffusion = GaussianDiffusion(logsnr_fn=get_logsnr_schedule("cosine"), **S.TP_DIFFUSION)

    def denoise_fn(x_t, t_, y_):
        if mode == "sp":
            x_t = spatial_constraint(x_t, mesh)
        return model.apply({"params": params}, x_t, t_, y_, train=False)

    _, _, _, x_T, y4 = S.tp_inputs()
    return np.asarray(jax.jit(lambda x, y: diffusion.p_sample(
        denoise_fn, x.shape, jax.random.key(0), noise=x, label=y, use_ddim=True))(x_T, y4))


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()))


# --------------------------------------------------------------------------
# the sharding rule, one process
# --------------------------------------------------------------------------


def test_tp_rule_on_jax_cases():
    """tests/test_tp.py's five leaves through the port's rule on the torch
    layouts (the output dim first) at 8 ranks."""
    from vdiff_tpu_torch.parallel.tp import shards

    assert shards((32, 32, 3, 3), 8)       # conv (O, I, kh, kw), 9216 elements
    assert shards((128, 128), 8)           # dense (O, I)
    assert not shards((128,), 8)           # a bias: rank 1
    assert not shards((12, 64, 3, 3), 8)   # O=12 does not divide by 8
    assert not shards((8, 8), 8)           # under TP_MIN_SHARD_SIZE


@pytest.mark.parametrize("n", [2, 8])
def test_tp_plan_is_jax_rule_on_every_parameter(n):
    """The port shards a parameter of the small UNet exactly when JAX's
    ``tp_param_shardings`` gives its leaf a non-empty spec (the specs
    carried through the weight converter as all-ones and all-zeros)."""
    from vdiff_tpu.parallel.tp import tp_param_shardings
    from vdiff_tpu_torch.models.unet import UNet
    from vdiff_tpu_torch.parallel.tp import tp_shard_plan

    _, params = S.jax_tp_model_and_params()
    specs = tp_param_shardings(_mesh(n), jax.tree.map(jnp.asarray, params))
    flags = jax.tree.map(lambda leaf, sh: np.full(np.shape(leaf), float(any(sh.spec))),
                         params, specs)
    want = {k for k, v in S.flax_params_to_state_dict_np(flags, S.TP_CFG).items() if v.all()}
    model = UNet(**S.TP_CFG)
    assert want and set(tp_shard_plan(model, n)) == want
    assert len(want) < len(list(model.parameters()))


@pytest.mark.parametrize("n,share", [(2, 0.5008), (4, 0.2513)])
def test_full_width_cifar_bytes_a_rank(n, share):
    """The full-width cifar10_cond model on the meta device: a rank keeps
    0.5008 of the f32 parameter bytes at 2 ranks (116.2 MiB) and 0.2513 at
    4."""
    from vdiff_tpu_torch.factory import CONFIG_DIR, build_unet, load_experiment_config
    from vdiff_tpu_torch.parallel.tp import tp_shard_plan

    cfg, _ = load_experiment_config(os.path.join(CONFIG_DIR, "cifar10_cond.json"))
    with torch.device("meta"):
        model = build_unet(cfg["model"], in_channels=3, num_classes=10, multitags=False,
                           model_out_type=cfg["diffusion"]["model_out_type"])
    plan = set(tp_shard_plan(model, n))
    sizes = {k: p.numel() * 4 for k, p in model.named_parameters()}
    rank = sum(b // n if k in plan else b for k, b in sizes.items())
    assert round(rank / sum(sizes.values()), 4) == share
    if n == 2:
        assert round(rank / 2**20, 1) == 116.2


def test_rows_per_rank():
    from vdiff_tpu_torch.parallel.spatial import rows_per_rank

    assert rows_per_rank(32, 3, 2) == 16 and rows_per_rank(16, 2, 4) == 4
    with pytest.raises(ValueError, match="H=32 with 6 levels leaves 1 rows"):
        rows_per_rank(32, 6, 2)
    with pytest.raises(ValueError, match="divisible by the 3 ranks"):
        rows_per_rank(16, 2, 3)


# --------------------------------------------------------------------------
# two ranks over gloo
# --------------------------------------------------------------------------


def test_tp_param_bytes_equal_jax(ranks):
    """Each rank's parameter bytes under TP are JAX's
    ``state_bytes_per_device`` of ``tp_shard_params`` on the 2-device mesh,
    and each planned weight holds O/2 rows."""
    from vdiff_tpu.parallel.fsdp import state_bytes_per_device
    from vdiff_tpu.parallel.tp import tp_shard_params
    from vdiff_tpu_torch.models.unet import UNet
    from vdiff_tpu_torch.parallel.tp import tp_shard_plan

    _, params = S.jax_tp_model_and_params()
    want = state_bytes_per_device(tp_shard_params(_mesh(), jax.tree.map(jnp.asarray, params)))
    setup, r = ranks
    plan = set(tp_shard_plan(UNet(**S.TP_CFG), 2))
    total = sum(v.numel() * 4 for v in setup["weights"].values())
    for res in r.results():
        assert res["tp_bytes"] == want < 0.55 * total
        for k, full in setup["weights"].items():
            rows = full.shape[0] // 2 if k in plan else full.shape[0]
            assert res["tp_shapes"][k] == (rows,) + tuple(full.shape[1:]), k


@pytest.mark.parametrize("mode", ["tp", "sp", "tpsp"])
def test_two_rank_forward(ranks, mode):
    """TP, SP and TP+SP forwards on every rank against the one-rank forward
    and JAX's forward under the same mode."""
    _, r = ranks
    want = _jax_forward(mode)
    for res in r.results():
        got = res[f"{mode}_out"].numpy()
        assert np.isfinite(got).all()
        _close(got, res["one_out"], ONE_RANK_TOL)
        _close(got, want, JAX_TOL)


@pytest.mark.parametrize("mode", ["tp", "sp"])
def test_two_rank_cfg_trajectory(ranks, mode):
    """Four DDIM steps with CFG (w=0.3, B=4) from the same x_T: one rank,
    and JAX's sampler under the same mode."""
    _, r = ranks
    want = _jax_sample(mode)
    assert np.abs(want - S.tp_inputs()[3]).max() > 0.1  # the sampler moved
    for res in r.results():
        got = res[f"sample_{mode}"].numpy()
        _close(got, res["sample_one"], ONE_RANK_TOL)
        _close(got, want, JAX_TOL)


def test_spatial_shapes_and_refusals(ranks):
    """On a height shard every conv wrote, and every GroupNorm and resample
    read, half the rows of the one-rank forward's same call (TP+SP too); the
    shard refuses autograd and both fused switches."""
    _, r = ranks
    for res in r.results():
        plain = res["plain_rows"]
        assert {kind for kind, _ in plain} == {"conv2d", "group_norm", "avg_pool2d",
                                               "interpolate"}
        for name in ("sp_rows", "tpsp_rows"):
            assert [k for k, _ in res[name]] == [k for k, _ in plain]
            assert [rows * 2 for _, rows in res[name]] == [rows for _, rows in plain]
        refused = res["sp_refusals"]
        assert "inference only" in refused["grad"]
        assert "VDIFF_FUSED_CONV=1" in refused["VDIFF_FUSED_CONV"]
        assert "VDIFF_FUSED_GN=1" in refused["VDIFF_FUSED_GN"]


@pytest.fixture(scope="module")
def one_rank_cli(ranks, tmp_path_factory):
    """The one-rank generate CLI's float samples, before the PNG writer."""
    from vdiff_tpu_torch import generate

    setup, _ = ranks
    captured, write = [], generate.write_pngs
    generate.write_pngs = lambda save_dir, x: (captured.append(np.array(x)), write(save_dir, x))
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        generate.main(setup["generate_args"]
                      + ["--save-dir", str(tmp_path_factory.mktemp("one_rank_cli"))])
    finally:
        generate.write_pngs = write
        torch.set_num_threads(n)
    return np.concatenate(captured)


@pytest.mark.parametrize("mode", ["tp", "sp", "tpsp"])
def test_generate_cli_matches_one_rank(ranks, one_rank_cli, mode):
    """generate with each mode on two ranks: rank 0 writes the PNGs, which
    are the one-rank CLI's within one level of 255; the sampler ran its eager
    loop on each rank."""
    _, r = ranks
    want = one_rank_cli
    quant = lambda x: np.clip(x * 127.5 + 127.5, 0, 255).astype(np.uint8).astype(int)  # noqa: E731
    res = r.results()
    got = res[0][f"generate_{mode}"]
    assert got.shape == want.shape == (6, 32, 32, 3) and res[1][f"generate_{mode}"] is None
    assert np.abs(quant(got) - quant(want)).max() <= 1
    summary = res[0][f"generate_{mode}_summary"]
    pngs = [f for f in os.listdir(summary["save_dir"]) if f.endswith(".png")]
    assert len(pngs) == 6 and summary["world_size"] == 2
    for rank_res in res:
        stats = rank_res[f"generate_{mode}_summary"]["stats"]
        assert stats["graph"] is False and stats["eager_steps"] == 8 and stats["captures"] == 0


def test_generate_refuses_rows_that_do_not_split(ranks):
    """--spatial-shard on a config whose lowest level has one row."""
    _, r = ranks
    for res in r.results():
        assert "--spatial-shard: a height shard needs" in res["six_levels_refused"]


def test_four_rank_spatial_forward(four_ranks):
    """Four ranks: the 8x8 level at two rows a rank (and TP at 4)."""
    want = _jax_forward("sp")
    for res in four_ranks.results():
        assert [rows * 4 for _, rows in res["sp_rows"]] == [rows for _, rows in res["plain_rows"]]
        for mode in ("tp", "sp", "tpsp"):
            _close(res[f"{mode}_out"].numpy(), res["one_out"], ONE_RANK_TOL)
        _close(res["sp_out"].numpy(), want, JAX_TOL)
