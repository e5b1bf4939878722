"""HSDP on four ranks over gloo: ``Trainer(fsdp_size=2)`` on the 2-D (data,
fsdp) mesh, whose state is sharded within pairs of ranks and replicated
across them, takes the one-rank step on the global batch (CFG on, two
micro-batches of one row a rank, the clip biting) within
tests/test_torch_train_parity.py's bounds; a one-process checkpoint restores
into FSDP over the four ranks bit for bit."""

import pytest

import torch

from tests import torch_parallel_setup as S

pytest.importorskip("jax")  # the set-up converts JAX's params


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("four_ranks")
    S.write_setup(workdir)
    return S.Ranks(workdir, 4, ("hsdp", "replicated")).results()


def test_hsdp_step_matches_the_one_rank_step(ranks):
    one = ranks[0]["one"]
    norm = S.check_step(ranks[0]["hsdp"], one["loss"], S.as_numpy(one["grads"]),
                        S.as_numpy(one["params"]), S.as_numpy(one["ema"]))
    assert norm > S.GRAD_NORM  # the clip bit
    whole = 4 * sum(v.numel() * 4 for v in one["params"].values())  # params, EMA, 2 moments
    for res in ranks:
        S.assert_same_state(res["hsdp"]["params"], ranks[0]["hsdp"]["params"])
        assert res["hsdp"]["state_bytes"] <= 0.55 * whole  # one copy per pair of ranks


def test_one_process_checkpoint_restores_into_four_fsdp_ranks(ranks):
    for res in ranks:
        S.assert_same_state(res["restored"]["params"], ranks[0]["one"]["params"])
        S.assert_same_state(res["restored"]["opt"], ranks[0]["one_opt"])
    assert torch.isfinite(torch.tensor(ranks[0]["one"]["loss"]))
