"""The sequential long-horizon protocol at depth 3 with learned agents, held
against the JAX package on the CPU: ``evaluate_lh_seq_tasks`` of both
packages on one expert-play validation set with chains of three tasks,
the env's state carried from each sub-goal's episode into the next, driven
by the tiny Play-LMP of tests/test_torch_tacorl.py (the same weights in
both formats) and by a TACO-RL agent grafted from it. The port's rollout
manager takes the JAX manager's key chain as draws
(tests/test_torch_rollout.py). Each agent call is held step for step
(plans and actions within atol 1e-5, the gripper equal, the decoder's
carry too), then the env's final state and the results JSON, which must
be equal."""

import json

import numpy as np
import pytest

from tacorl_tpu.envs.fake_calvin import FakeCalvinEnv as JaxFakeCalvinEnv
from tacorl_tpu.evaluation import manager as jax_manager
from tacorl_tpu.evaluation import rollout_generator as jax_generators
from tacorl_tpu.evaluation import rollout_manager as jax_rm
from tacorl_tpu_torch.data.expert_play import generate_expert_play
from tacorl_tpu_torch.envs.fake_calvin import FakeCalvinEnv
from tacorl_tpu_torch.evaluation import manager, rollout_generator as generators
from tacorl_tpu_torch.evaluation import rollout_manager as rm
from tests.test_torch_rollout import ATOL, _Recorder, agent_pairs, jax_draw_source, lmp_modules  # noqa: F401
from tests.test_torch_tacorl import lmp_dirs  # noqa: F401

DEPTH, CHAINS, STEPS, PLAN, SEED = 3, 2, 8, 3, 5
FAMILIES = {"play_lmp": (jax_rm.LatentPlanRollout, rm.LatentPlanRollout),
            "tacorl": (jax_rm.TACORLRollout, rm.TACORLRollout)}


class _PortRecorder:
    """The port agent's calls, recorded as ``_Recorder`` records the JAX
    agent's: kind and output, and the decoder's carry after a decode step."""

    def __init__(self, agent):
        self.agent, self.calls = agent, []
        self.device = agent.device

    def reset(self):
        self.agent.reset()
        self.calls.append(("reset", None))

    def propose_plan(self, obs, draws=None, generator=None):
        plan = self.agent.propose_plan(obs, draws, generator)
        self.calls.append(("propose", plan.numpy().copy()))
        return plan

    def decode_step(self, obs, plan, draws=None, generator=None):
        out = self.agent.decode_step(obs, plan, draws, generator)
        self.calls.append(("decode", (out, self.agent.carry.numpy().copy())))
        return out


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """A validation split whose chains hold three tasks each."""
    root = tmp_path_factory.mktemp("lh_seq")
    generate_expert_play(root, n_train_episodes=1, n_val_episodes=3, tasks_per_episode=DEPTH,
                         idle_steps=(3, 7), seed=11, distinct_tasks=True)
    return root / "validation"


def _evaluate(pkg, data_dir, agent, rollout, out):
    gen_mod, env_cls, mgr_mod = pkg
    env = env_cls(image_hw=64, max_episode_steps=STEPS, task_set="hard")
    gen = gen_mod.LongHorizonSequentialRolloutGenerator(
        data_dir=data_dir, start_end_tasks=data_dir / "start_end_tasks.json", min_seq_len=1,
        max_seq_len=400, tasks_per_rollout=DEPTH,
    )
    evaluation = mgr_mod.EvaluationManager(agent=agent, env=env, rollout_manager=rollout, lh_seq_generator=gen)
    results = evaluation.evaluate_lh_seq_tasks(filename=str(out), max_rollouts=CHAINS)
    return results, env


@pytest.fixture(scope="module", params=list(FAMILIES))
def evaluated(request, agent_pairs, chains, tmp_path_factory):  # noqa: F811
    family = request.param
    jax_cls, port_cls = FAMILIES[family]
    jagent, (pagent, _) = agent_pairs[family]
    out = tmp_path_factory.mktemp(f"lh_seq_{family}")
    jrec, prec = _Recorder(jagent), _PortRecorder(pagent)
    want, jenv = _evaluate((jax_generators, JaxFakeCalvinEnv, jax_manager), chains, jrec,
                           jax_cls(plan_duration=PLAN, seed=SEED), out / "jax.json")
    got, penv = _evaluate((generators, FakeCalvinEnv, manager), chains, prec,
                          port_cls(plan_duration=PLAN, seed=SEED, draw_source=jax_draw_source(family, seed=SEED)),
                          out / "port.json")
    return dict(family=family, want=want, got=got, jenv=jenv, penv=penv, jcalls=jrec.calls, pcalls=prec.calls,
                jjson=(out / "jax.json").read_text(), pjson=(out / "port.json").read_text())


def test_every_agent_call_of_the_depth_3_chains_matches_jax(evaluated):
    jcalls, pcalls = evaluated["jcalls"], evaluated["pcalls"]
    assert [c[0] for c in pcalls] == [c[0] for c in jcalls]
    # one episode a sub-goal, each run to the step limit (the untrained agents complete nothing)
    assert [c[0] for c in jcalls].count("reset") == CHAINS * DEPTH
    assert [c[0] for c in jcalls].count("decode") == CHAINS * DEPTH * STEPS
    for i, ((kind, got), (_, _, _, want)) in enumerate(zip(pcalls, jcalls)):
        if kind == "propose":
            np.testing.assert_allclose(got, np.array(want), atol=ATOL, err_msg=f"plan at call {i}")
        elif kind == "decode":
            (action, carry), (jaction, jcarry) = got, want
            np.testing.assert_allclose(action[:-1], jaction[:-1], atol=ATOL, err_msg=f"action at call {i}")
            assert action[-1] == jaction[-1], f"gripper differs at call {i}"
            np.testing.assert_allclose(carry, jcarry, atol=ATOL, err_msg=f"carry at call {i}")


def test_the_env_state_carried_through_the_chains_matches_jax(evaluated):
    jenv, penv = evaluated["jenv"], evaluated["penv"]
    np.testing.assert_allclose(penv.robot_obs, jenv.robot_obs, atol=ATOL)
    np.testing.assert_allclose(penv.scene_obs, jenv.scene_obs, atol=ATOL)


def test_the_results_json_equals_jax(evaluated):
    assert evaluated["pjson"] == evaluated["jjson"]
    results = json.loads(evaluated["pjson"])
    assert results["num_rollouts"] == CHAINS and results["tasks_per_rollout"] == DEPTH
    assert sum(results["tasks_info"]["failed"].values()) + sum(results["tasks_info"]["success"].values()) \
        == CHAINS * DEPTH
