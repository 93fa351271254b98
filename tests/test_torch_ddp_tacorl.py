"""Data-parallel TACO-RL train steps on the CPU (stage 2, grafted from a
stage-1 checkpoint, its frozen subtrees taking no part): two gloo ranks
against one rank on the global batch and against the JAX step on a dp=2
mesh (tests/torch_ddp_harness.py)."""

import pytest
import torch

from tests import test_torch_tacorl as taco
from tests import torch_ddp_harness as ddp
from tests.torch_threads import share_cores

share_cores()  # the xdist workers share the cores

FAMILIES, DRAWN = ("tacorl",), ("tacorl",)


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


def test_frozen_subtrees_take_no_part(runs):
    """The grafted, frozen parts are bit-unchanged by the two ranks' steps."""
    got = runs["ranks"][0][("tacorl", "given")]["sd"]
    start = torch.load(runs["root"] / "specs.pt", weights_only=False)["tacorl"]["sd0"]
    frozen = [k for k in got if k.startswith(taco.FROZEN)]
    assert frozen and all(torch.equal(got[k], start[k]) for k in frozen)
