"""Data-parallel vector CQL, visual RIL and online SAC train steps on the
CPU: two gloo ranks against one rank on the global batch and against the
JAX step on a dp=2 mesh (tests/torch_ddp_harness.py). SAC's ranks play one
env stream: the play step's draws are whole on each rank."""

import pytest

from tests import torch_ddp_harness as ddp

FAMILIES, DRAWN = ("cql_vector", "ril", "sac"), ("cql_vector", "sac")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ddp.run_families(tmp_path_factory.mktemp("ddp"), FAMILIES, DRAWN)


@pytest.mark.parametrize("name, mode", ddp.modes(FAMILIES, DRAWN))
def test_two_ranks_agree_and_were_broadcast(runs, name, mode):
    ddp.check_ranks_agree(runs, name, mode)


@pytest.mark.parametrize("name, mode", ddp.modes(FAMILIES, DRAWN))
def test_two_ranks_match_one_rank_on_the_global_batch(runs, name, mode):
    ddp.check_one_rank(runs, name, mode)


@pytest.mark.parametrize("name", FAMILIES)
def test_two_ranks_match_the_jax_dp2_mesh_step(runs, name):
    ddp.check_jax(runs, name)
