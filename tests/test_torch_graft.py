"""The port's param-tree surgery (``core/checkpoint.py:graft`` and
``freeze_mask``) against the JAX package's on converted trees: a tiny
vector CQL state's params (and the critics' targets) through
``cql_state_dict_from_jax``. The JAX functions take '/'-paths into the
nested tree, the port's dotted prefixes into the state dict."""

import jax
import numpy as np
import pytest
import torch

from tacorl_tpu.core.checkpoint import freeze_mask as jax_freeze_mask
from tacorl_tpu.core.checkpoint import graft as jax_graft
from tacorl_tpu.modules.cql import CQLModule as JaxCQLModule
from tacorl_tpu_torch.core.checkpoint import freeze_mask, graft
from tacorl_tpu_torch.utils.convert import cql_state_dict_from_jax
from tests.test_torch_cql import np_tree
from tests.test_torch_cql_flat import vector_batch, vector_cfg


@pytest.fixture(scope="module")
def trees():
    jmod = JaxCQLModule(vector_cfg())
    params = np_tree(jmod.init_state(jax.random.key(1), vector_batch(0)).params)
    other = np_tree(jmod.init_state(jax.random.key(2), vector_batch(0)).params)
    return params, other


def _port(params, critics=None):
    """The converted state dict; the targets (aux) are the critics of
    ``critics`` (default: of ``params``)."""
    critics = params if critics is None else critics
    return cql_state_dict_from_jax(params, {"target_q1": critics["q1"], "target_q2": critics["q2"]}, ())


@pytest.mark.parametrize(
    "jax_mapping, port_mapping",
    [
        ({"q2": "q1"}, {"q2": "q1"}),
        ({"q1/goal_encoder": "actor/goal_encoder", "actor/actor/policy/fc0": "actor/actor/policy/fc1"},
         None),
        ({"q1/goal_encoder": "actor/goal_encoder"}, {"q1.goal_encoder": "actor.goal_encoder"}),
        ({"log_alpha": "log_alpha_prime"}, {"log_alpha": "log_alpha_prime"}),
    ],
    ids=["critic", "rank_mismatch", "goal_encoder", "leaf"],
)
def test_graft_matches_jax(trees, jax_mapping, port_mapping):
    target, source = trees
    if port_mapping is None:
        # a kernel (16, 16) into one of (78, 16): same rank, so JAX grafts it;
        # the port's fc_layers.0 <- fc_layers.1 is the same graft
        port_mapping = {"q1.goal_encoder": "actor.goal_encoder",
                        "actor.actor.policy.fc_layers.0": "actor.actor.policy.fc_layers.1"}
    # the targets are aux, not params: both sides keep the target's
    want = _port(jax_graft(target, source, jax_mapping), critics=target)
    got = graft(_port(target), _port(source), port_mapping)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_graft_copies_and_leaves_its_inputs(trees):
    target, source = (_port(t) for t in trees)
    before = {k: v.clone() for k, v in target.items()}
    out = graft(target, source, {"q2": "q1"})
    out["q2.critic.Q.out.bias"].add_(1.0)
    out["log_alpha"].add_(1.0)
    assert all(torch.equal(before[k], target[k]) for k in target)
    assert torch.equal(out["q2.critic.Q.out.weight"], source["q1.critic.Q.out.weight"])
    assert not torch.equal(out["q2.critic.Q.out.bias"], source["q1.critic.Q.out.bias"])


@pytest.mark.parametrize(
    "jax_mapping, port_mapping",
    [
        ({"actor/goal_encoder": "q1/critic"}, {"actor.goal_encoder": "q1.critic"}),
        # a kernel into a vector: another rank
        ({"log_alpha": "q1/critic/q_network/out/kernel"}, {"log_alpha": "q1.critic.Q.out.weight"}),
    ],
    ids=["keys", "rank"],
)
def test_graft_refuses_a_structure_mismatch_as_jax_does(trees, jax_mapping, port_mapping):
    target, source = trees
    with pytest.raises(ValueError, match="graft structure mismatch"):
        jax_graft(target, source, jax_mapping)
    (dst, src), = port_mapping.items()
    with pytest.raises(ValueError, match=f"graft structure mismatch at '{dst}' <- '{src}'"):
        graft(_port(target), _port(source), port_mapping)


def test_graft_of_a_missing_prefix_raises_as_jax_does(trees):
    target, source = trees
    with pytest.raises(KeyError):
        jax_graft(target, source, {"q1": "q3"})
    with pytest.raises(KeyError):
        graft(_port(target), _port(source), {"q1": "q3"})


@pytest.mark.parametrize(
    "jax_frozen, port_frozen",
    [
        (["actor/goal_encoder", "q1"], ["actor.goal_encoder", "q1"]),
        (["log_alpha", "q2/critic"], ["log_alpha", "q2.critic"]),
        ([], []),
    ],
)
def test_freeze_mask_matches_jax(trees, jax_frozen, port_frozen):
    """JAX's mask as markers (ones where trainable), converted: each port
    key's flag is its tensor's marker."""
    params = trees[0]
    mask = jax_freeze_mask(params, jax_frozen)
    markers = jax.tree.map(lambda x, m: np.full(x.shape, float(m), np.float32), params, mask)
    want = _port(markers)
    got = freeze_mask(_port(params), port_frozen)
    assert set(got) == set(want)
    for k, v in want.items():
        if k.startswith("target_"):
            continue  # the targets are not params in the JAX tree
        assert v.min() == v.max() and got[k] == bool(v.max()), k
    # a prefix names whole path parts only: "q1" does not freeze "q10..."
    assert freeze_mask({"q10.w": 0, "q1": 0, "q1.w": 0}, ["q1"]) == {"q10.w": True, "q1": False, "q1.w": False}
