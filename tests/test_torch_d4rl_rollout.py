"""The port's D4RL rollout path held against the JAX package on the CPU at
tiny widths, on the weights of tests/test_torch_d4rl.py's checkpoints
(converted from JAX by tacorl_tpu_torch/utils/convert.py):

* both hierarchical D4RL agents and the flat one on the JAX rollout's own
  observations (each JAX key turned into the draws the JAX agent makes
  from it): plans, actions and decoder carries at atol 1e-5;
* whole episodes of each rollout manager, the port's driven by a draw
  source that splits the JAX manager's key chain;
* ``python -m tacorl_tpu_torch.evaluate_d4rl`` against
  scripts/evaluate_d4rl.py: the same JSON.

The JAX draws: a replan of the Play-LMP agent samples eps ~ N(0, 1)
(1, latent) from its key; a decode step splits its key into k_mix, k_u and
draws the mixture uniforms on [1e-5, 1 - 1e-5); the TACO-RL plan and the
flat action are deterministic and draw nothing."""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from scripts.evaluate_d4rl import main as jax_evaluate_d4rl
from tacorl_tpu.core.checkpoint import CheckpointManager as JaxCheckpointManager
from tacorl_tpu.envs.fake_d4rl import FakeD4RLEnv as JaxFakeD4RLEnv
from tacorl_tpu.evaluation import agents as jax_agents
from tacorl_tpu.evaluation import rollout_manager_d4rl as jax_rm
from tacorl_tpu.modules.cql import CQLModule as JaxCQLModule
from tacorl_tpu.modules.tacorl_d4rl import TACORLD4RLModule as JaxTACORLD4RLModule
from tacorl_tpu_torch import evaluate_d4rl
from tacorl_tpu_torch.core.checkpoint import CheckpointManager
from tacorl_tpu_torch.envs.fake_d4rl import FakeD4RLEnv
from tacorl_tpu_torch.evaluation import agents
from tacorl_tpu_torch.evaluation import rollout_manager_d4rl as rm
from tacorl_tpu_torch.modules.cql import CQLModule
from tacorl_tpu_torch.modules.tacorl_d4rl import TACORLD4RLModule
from tacorl_tpu_torch.utils.convert import cql_state_dict_from_jax, tacorl_d4rl_state_dict_from_jax
from tests.test_torch_cql import np_tree
from tests.test_torch_d4rl import (  # noqa: F401  (lmp_dirs is a fixture)
    ACT_DIM,
    ATOL,
    LATENT,
    N_ACT,
    OBS_DIM,
    _t,
    _uniforms,
    lmp_dirs,
    tacorl_cfg,
)

REPO = Path(__file__).resolve().parent.parent




def draws_from_key(family, call, key):
    """The draws the JAX D4RL agent makes from a key."""
    if call == "decode":
        return _uniforms(key, 1, 1)
    if family == "play_lmp_d4rl" and call == "propose":
        return {"eps": _t(jax.random.normal(key, (1, LATENT)))}
    return None  # the TACO-RL plan and the flat action draw nothing


def jax_draw_source(family, seed=0):
    """The JAX manager's key chain (key, sub = split(key) per agent call)."""
    chain = {"key": jax.random.key(seed)}

    def source(call):
        chain["key"], sub = jax.random.split(chain["key"])
        return draws_from_key(family, call, sub)

    return source


CQL_CFG = {
    "_target_": "tacorl_tpu.modules.cql.CQLModule", "state_based": True, "state_dim": OBS_DIM,
    "goal_dim": 2, "action_dim": ACT_DIM, "n_action_samples": N_ACT, "with_lagrange": True,
    "policy": {"num_layers": 2, "hidden_dim": 16}, "q_network": {"num_layers": 2, "hidden_dim": 16},
}


@pytest.fixture(scope="module")
def families(lmp_dirs, tmp_path_factory):
    """Per family: the JAX (module, state) and the port's, on the same
    weights, each also saved as a checkpoint (JAX dir, port dir)."""
    jax_dir, port_dir, batch = lmp_dirs
    from tacorl_tpu.core.checkpoint import load_module_from_checkpoint as jax_load
    from tacorl_tpu_torch.core.checkpoint import load_module_from_checkpoint

    out = {"play_lmp_d4rl": (jax_load(jax_dir), load_module_from_checkpoint(port_dir, device="cpu"),
                             jax_dir, port_dir)}

    jt = JaxTACORLD4RLModule(tacorl_cfg(jax_dir))
    jts = jt.init_state(jax.random.key(1), batch)
    pt = TACORLD4RLModule(tacorl_cfg(port_dir), device="cpu")
    pts = pt.init_state(0)
    pt.net.load_state_dict(tacorl_d4rl_state_dict_from_jax(np_tree(jts.params), np_tree(jts.aux)))
    dirs = tmp_path_factory.mktemp("jax_rl"), tmp_path_factory.mktemp("port_rl")
    JaxCheckpointManager(dirs[0], config={"module": tacorl_cfg(jax_dir)}).save(0, jts)
    CheckpointManager(dirs[1], config={"module": tacorl_cfg(port_dir)}).save(0, pts)
    out["tacorl_d4rl"] = ((jt, jts), (pt, pts)) + dirs

    flat = {"observations": np.zeros((2, OBS_DIM + 2), np.float32), "actions": np.zeros((2, ACT_DIM), np.float32)}
    jc = JaxCQLModule(dict(CQL_CFG))
    jcs = jc.init_state(jax.random.key(4), flat)
    pc = CQLModule(dict(CQL_CFG), device="cpu")
    pcs = pc.init_state(0)
    pc.net.load_state_dict(cql_state_dict_from_jax(np_tree(jcs.params), np_tree(jcs.aux), modalities=()))
    dirs = tmp_path_factory.mktemp("jax_cql"), tmp_path_factory.mktemp("port_cql")
    JaxCheckpointManager(dirs[0], config={"module": dict(CQL_CFG)}).save(0, jcs)
    CheckpointManager(dirs[1], config={"module": dict(CQL_CFG)}).save(0, pcs)
    out["cql"] = ((jc, jcs), (pc, pcs)) + dirs
    return out


JAX_AGENTS = {
    "play_lmp_d4rl": (jax_agents.LatentPlanD4RLAgent, jax_rm.LatentPlanRolloutD4RL),
    "tacorl_d4rl": (jax_agents.TACORLD4RLAgent, jax_rm.TACORLRolloutD4RL),
    "cql": (jax_agents.FlatPolicyAgent, jax_rm.RLRolloutD4RL),
}
PORT_AGENTS = {
    "play_lmp_d4rl": (agents.LatentPlanD4RLAgent, rm.LatentPlanRolloutD4RL),
    "tacorl_d4rl": (agents.TACORLD4RLAgent, rm.TACORLRolloutD4RL),
    "cql": (agents.FlatPolicyAgent, rm.RLRolloutD4RL),
}


def _jax_pair(family, families, plan_duration=5, seed=0):
    (jmod, jstate), (pmod, pstate) = families[family][:2]
    agent_cls, manager_cls = JAX_AGENTS[family]
    kw = {} if family == "cql" else {"plan_duration": plan_duration}
    return agent_cls(jmod, jstate), manager_cls(seed=seed, **kw)


class _Recorder:
    """Wraps a JAX D4RL agent and records each call: kind, inputs, key,
    output and the decoder carry after a decode step."""

    def __init__(self, agent):
        self.agent, self.calls = agent, []

    def reset(self):
        self.agent.reset()
        self.calls.append(("reset", None, None, None))

    def act(self, obs, key):
        out = self.agent.act(obs, key)
        self.calls.append(("act", obs, key, out))
        return out

    def propose_plan_d4rl(self, obs, goal, key):
        plan = self.agent.propose_plan_d4rl(obs, goal, key)
        self.calls.append(("propose", (obs, goal), key, np.asarray(plan)))
        return plan

    def decode_step(self, obs, plan, key):
        out = self.agent.decode_step(obs, plan, key)
        carry = np.stack([np.asarray(c) for c in self.agent.carry])
        self.calls.append(("decode", obs, key, (out, carry)))
        return out


@pytest.mark.parametrize("family", list(PORT_AGENTS))
def test_make_d4rl_agent_picks_the_jax_agent_and_manager(families, family):
    pmod, pstate = families[family][1]
    agent, manager = agents.make_d4rl_agent(pmod, pstate, plan_duration=7)
    agent_cls, manager_cls = PORT_AGENTS[family]
    assert type(agent) is agent_cls and type(manager) is manager_cls
    assert manager_cls.__name__ == JAX_AGENTS[family][1].__name__
    assert getattr(manager, "plan_duration", 7) == 7


@pytest.mark.parametrize("family", list(PORT_AGENTS))
def test_agent_matches_jax_on_a_shared_observation_stream(families, family):
    jagent, jmanager = _jax_pair(family, families)
    recorder = _Recorder(jagent)
    env = JaxFakeD4RLEnv(obs_dim=OBS_DIM, act_dim=ACT_DIM, max_episode_steps=20, seed=0)
    for _ in range(2):
        jmanager.episode_rollout(recorder, env)
    pmod, pstate = families[family][1]
    pagent, _ = agents.make_d4rl_agent(pmod, pstate)
    plan, compared = None, 0
    for i, (kind, obs, key, want) in enumerate(recorder.calls):
        draws = None if key is None else draws_from_key(family, kind, key)
        if kind == "reset":
            pagent.reset()
        elif kind == "act":
            np.testing.assert_allclose(pagent.act(obs, draws), want, atol=ATOL, err_msg=f"call {i}")
            compared += 1
        elif kind == "propose":
            plan = pagent.propose_plan_d4rl(*obs, draws)
            np.testing.assert_allclose(plan.numpy(), want, atol=ATOL, err_msg=f"plan at call {i}")
        else:
            action, carry = want
            np.testing.assert_allclose(pagent.decode_step(obs, plan, draws), action, atol=ATOL, err_msg=f"call {i}")
            np.testing.assert_allclose(pagent.carry.numpy(), carry, atol=ATOL, err_msg=f"carry at call {i}")
            compared += 1
    assert compared == sum(k in ("act", "decode") for k, *_ in recorder.calls) > 0
    if family != "cql":
        assert sum(k == "propose" for k, *_ in recorder.calls) >= 4  # replans inside each episode


@pytest.mark.parametrize("family", list(PORT_AGENTS))
def test_whole_episodes_match_jax(families, family):
    """Three episodes from one manager each (the key chain and the env's
    goal draws run on), the port's manager driven by the JAX key chain's
    draws."""
    jagent, jmanager = _jax_pair(family, families, seed=3)
    pmod, pstate = families[family][1]
    pagent, _ = agents.make_d4rl_agent(pmod, pstate)
    kw = {} if family == "cql" else {"plan_duration": 5}
    pmanager = PORT_AGENTS[family][1](seed=3, draw_source=jax_draw_source(family, seed=3), **kw)
    jenv = JaxFakeD4RLEnv(obs_dim=OBS_DIM, act_dim=ACT_DIM, max_episode_steps=25, seed=1)
    penv = FakeD4RLEnv(obs_dim=OBS_DIM, act_dim=ACT_DIM, max_episode_steps=25, seed=1)
    for _ in range(3):
        want = jmanager.episode_rollout(jagent, jenv)
        got = pmanager.episode_rollout(pagent, penv)
        assert got == want
        assert set(got) == {"episode_length", "episode_return", "score", "success"}
    np.testing.assert_allclose(penv._obs, jenv._obs, atol=ATOL)


def test_manager_generator_restarts_with_each_manager(families):
    """Without a draw source a manager draws from its own generator seeded
    from ``seed``: two managers of one seed roll the same episodes on envs
    of one seed; another seed differs."""
    pmod, pstate = families["play_lmp_d4rl"][1]
    agent, _ = agents.make_d4rl_agent(pmod, pstate)

    def episodes(seed):
        manager, env = rm.LatentPlanRolloutD4RL(4, seed=seed), FakeD4RLEnv(max_episode_steps=12, seed=0)
        return [manager.episode_rollout(agent, env) for _ in range(2)], env._obs.copy()

    (a, pos_a), (b, pos_b), (_, pos_c) = episodes(0), episodes(0), episodes(1)
    assert a == b and np.array_equal(pos_a, pos_b) and not np.array_equal(pos_a, pos_c)


@pytest.mark.parametrize("family", list(PORT_AGENTS))
def test_evaluate_d4rl_writes_what_scripts_evaluate_d4rl_writes(families, family, tmp_path):
    jax_dir, port_dir = families[family][2:]
    common = ["num_rollouts=3", "plan_duration=4", "env.max_episode_steps=20"]
    want = jax_evaluate_d4rl([f"module_path={jax_dir}", f"filename={tmp_path / 'jax.json'}", *common])
    port_args = ["+device=cpu", f"module_path={port_dir}", f"filename={tmp_path / 'port.json'}", *common]
    if family == "cql":
        # the command a user runs; the flat policy draws nothing
        proc = subprocess.run([sys.executable, "-m", "tacorl_tpu_torch.evaluate_d4rl", *port_args],
                              cwd=REPO, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
    else:
        evaluate_d4rl.main(port_args, draw_source=jax_draw_source(family, seed=0))
    got = (tmp_path / "port.json").read_text()
    assert got == (tmp_path / "jax.json").read_text()
    assert set(want) == {"accuracy", "avg_normalized_score", "avg_episode_return", "num_rollouts"}


def test_evaluate_d4rl_raises_without_cuda(families, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate_d4rl.main([f"module_path={families['cql'][3]}", f"filename={tmp_path / 'x.json'}"])
