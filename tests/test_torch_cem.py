"""CEM planning of the port held against the JAX package on the CPU:

  * ``cem_optimize`` against the JAX ``cem_optimize`` for JAX's own normals
    (``split(key, num_iterations)``, one (P, B, A) draw per iteration), with
    a continuous and a discrete-gripper action, at atol 1e-6 (the elite
    mean may be summed in another order);
  * the CEM-refined FlatPolicyAgent (actions, gripper snapped) and
    TACORLAgent (latent plans, clipped to [-1, 1]) against the JAX agents,
    on the JAX rollout's own observations and over whole episodes driven by
    the JAX manager's key chain, at the tiny configs of
    tests/test_torch_rollout.py;
  * the ``python -m tacorl_tpu_torch.evaluate`` entry point with
    ``use_cem=true`` against scripts/evaluate.py on one tiny CQL
    checkpoint."""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scripts.evaluate import main as jax_evaluate
from tacorl_tpu.core.checkpoint import CheckpointManager as JaxCheckpointManager
from tacorl_tpu.envs.fake_calvin import FakeCalvinEnv as JaxFakeCalvinEnv
from tacorl_tpu.evaluation import agents as jax_agents
from tacorl_tpu.evaluation import rollout_manager as jax_rm
from tacorl_tpu.modules.cem import cem_optimize as jax_cem_optimize
from tacorl_tpu.modules.cql import CQLModule as JaxCQLModule
from tacorl_tpu_torch import evaluate
from tacorl_tpu_torch.core.checkpoint import CheckpointManager
from tacorl_tpu_torch.envs.fake_calvin import FakeCalvinEnv
from tacorl_tpu_torch.evaluation import agents, rollout_manager as rm
from tacorl_tpu_torch.modules.cem import cem_optimize
from tacorl_tpu_torch.modules.cql import CQLModule
from tacorl_tpu_torch.utils.convert import cql_state_dict_from_jax
from tests.test_torch_cql import _batch as cql_batch, _cfg as cql_cfg, np_tree
from tests.test_torch_rollout import RESET, _env, agent_pairs, decode_draws, lmp_modules  # noqa: F401
from tests.test_torch_tacorl import lmp_dirs  # noqa: F401
from tests.torch_threads import share_cores

share_cores()  # the xdist workers share the cores

CEM = {"num_iterations": 2, "population_size": 6, "num_elites": 2, "init_std": 0.3}


def cem_eps(key, b, a, num_iterations=2, population_size=6):
    """The normals the JAX ``cem_optimize`` draws from its key."""
    keys = jax.random.split(key, num_iterations)
    return torch.from_numpy(
        np.stack([np.asarray(jax.random.normal(k, (population_size, b, a))) for k in keys])
    )


# -- cem_optimize ---------------------------------------------------------------------------


def _critic(b, a, e=5, h=16, seed=0):
    """A fixed two-layer critic over (the state embedding tiled over the
    population, the action), in both packages."""
    rs = np.random.RandomState(seed)
    emb = rs.randn(b, e).astype(np.float32)
    w1 = rs.randn(e + a, h).astype(np.float32)
    w2 = rs.randn(h, 1).astype(np.float32)

    def jax_q(x):
        tiled = jnp.tile(emb, (x.shape[0] // b, 1))
        return jnp.tanh(jnp.concatenate([tiled, x], -1) @ w1) @ w2

    def port_q(x):
        tiled = torch.from_numpy(emb).repeat(x.shape[0] // b, 1)
        return torch.tanh(torch.cat([tiled, x], -1) @ torch.from_numpy(w1)) @ torch.from_numpy(w2)

    return jax_q, port_q


@pytest.mark.parametrize("discrete_gripper", [False, True], ids=["continuous", "gripper"])
@pytest.mark.parametrize("seed", [0, 1])
def test_cem_optimize_matches_jax(discrete_gripper, seed):
    b, a = 4, 7
    jax_q, port_q = _critic(b, a, seed=seed)
    init = np.random.RandomState(10 + seed).uniform(-1, 1, (b, a)).astype(np.float32)
    key = jax.random.key(seed)
    kw = dict(num_iterations=3, population_size=16, num_elites=4, init_std=0.5,
              discrete_gripper=discrete_gripper)
    want = np.asarray(jax_cem_optimize(key, jax_q, jnp.asarray(init), **kw))
    got = cem_optimize(port_q, torch.from_numpy(init), eps=cem_eps(key, b, a, 3, 16), **kw)
    assert got.shape == (b, a)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert np.all(np.abs(got.numpy()) <= 1.0)
    if discrete_gripper:
        np.testing.assert_array_equal(np.abs(got[:, -1].numpy()), 1.0)
    # the refinement moved the action toward a higher value
    assert float(port_q(got).mean()) > float(port_q(torch.from_numpy(init)).mean())


def test_cem_draws_from_the_generator_without_eps():
    _, port_q = _critic(2, 3)
    init = torch.zeros(2, 3)
    run = lambda seed: cem_optimize(port_q, init, generator=torch.Generator().manual_seed(seed))  # noqa: E731
    assert torch.equal(run(0), run(0)) and not torch.equal(run(0), run(1))
    with pytest.raises(ValueError, match="expected"):
        cem_optimize(port_q, init, num_iterations=2, eps=torch.zeros(3, 64, 2, 3))


# -- the agents ----------------------------------------------------------------------------------

def _cem_pair(agent_pairs, family):  # noqa: F811
    """The JAX and port agents of tests/test_torch_rollout.py rebuilt with
    CEM on the same modules and weights."""
    jagent, (pagent, _) = agent_pairs[family]
    jcls = jax_agents.FlatPolicyAgent if family == "cql" else jax_agents.TACORLAgent
    jcem = jcls(jagent.module, SimpleNamespace(params=jagent.params), use_cem=True, cem_cfg=CEM)
    pcem, manager_cls = agents.make_agent(pagent.module, SimpleNamespace(net=pagent.net),
                                          use_cem=True, cem_cfg=CEM)
    assert type(pcem) is type(pagent) and pcem.use_cem and pcem.cem_cfg == CEM
    return jcem, pcem


def _width(pagent, family):
    return 7 if family == "cql" else pagent.module.action_dim


def draws_from_key(family, call, key, width):
    """The draws of one JAX agent call: the CEM normals of the flat action
    or of the plan, the decoder's uniforms."""
    if call == "decode":
        return decode_draws(key)
    return {"cem_eps": cem_eps(key, 1, width)}


class _Recorder:
    def __init__(self, agent):
        self.agent, self.calls = agent, []

    def reset(self):
        self.agent.reset()
        self.calls.append(("reset", None, None, None))

    def act(self, obs, key):
        out = self.agent.act(obs, key)
        self.calls.append(("act", obs, key, out))
        return out

    def propose_plan(self, obs, key):
        plan = self.agent.propose_plan(obs, key)
        self.calls.append(("propose", obs, key, np.array(plan)))
        return plan

    def decode_step(self, obs, plan, key):
        out = self.agent.decode_step(obs, plan, key)
        self.calls.append(("decode", obs, key, out))
        return out


@pytest.mark.parametrize("family", ["cql", "tacorl"])
def test_cem_agent_matches_jax_on_a_shared_observation_stream(agent_pairs, family):  # noqa: F811
    jagent, pagent = _cem_pair(agent_pairs, family)
    width = _width(pagent, family)
    recorder = _Recorder(jagent)
    manager = jax_rm.RLRollout() if family == "cql" else jax_rm.TACORLRollout(plan_duration=5)
    manager.episode_rollout(recorder, _env(JaxFakeCalvinEnv, 15), RESET)
    plan, compared = None, 0
    for i, (kind, obs, key, want) in enumerate(recorder.calls):
        if kind == "reset":
            pagent.reset()
            continue
        draws = draws_from_key(family, kind, key, width)
        if kind == "act":
            got = pagent.act(obs, draws)
            np.testing.assert_allclose(got[:-1], want[:-1], atol=1e-5, err_msg=f"call {i}")
            assert got[-1] == want[-1] and abs(got[-1]) == 1.0, f"gripper at call {i}"
            compared += 1
        elif kind == "propose":
            plan = pagent.propose_plan(obs, draws)
            np.testing.assert_allclose(plan.numpy(), want, atol=1e-5, err_msg=f"plan at call {i}")
            assert float(plan.abs().max()) <= 1.0
        else:
            got = pagent.decode_step(obs, plan, draws)
            np.testing.assert_allclose(got[:-1], want[:-1], atol=1e-5, err_msg=f"call {i}")
            assert got[-1] == want[-1]
            compared += 1
    assert compared == sum(c[0] in ("act", "decode") for c in recorder.calls) >= 8


@pytest.mark.parametrize("family", ["cql", "tacorl"])
def test_cem_episodes_match_jax(agent_pairs, family):  # noqa: F811
    """Two episodes from one manager each, the port's driven by the JAX
    manager's key chain (key, sub = split(key) per agent call)."""
    jagent, pagent = _cem_pair(agent_pairs, family)
    width = _width(pagent, family)
    chain = {"key": jax.random.key(4)}

    def source(call):
        chain["key"], sub = jax.random.split(chain["key"])
        return draws_from_key(family, call, sub, width)

    if family == "cql":
        jmanager, pmanager = jax_rm.RLRollout(seed=4), rm.RLRollout(seed=4, draw_source=source)
    else:
        jmanager = jax_rm.TACORLRollout(plan_duration=5, seed=4)
        pmanager = rm.TACORLRollout(plan_duration=5, seed=4, draw_source=source)
    jenv, penv = _env(JaxFakeCalvinEnv, 12), _env(FakeCalvinEnv, 12)
    for reset in (RESET, {"task_info": {"task": "lift_block", "index": 2}}):
        assert pmanager.episode_rollout(pagent, penv, reset) == jmanager.episode_rollout(jagent, jenv, reset)
    np.testing.assert_allclose(penv.robot_obs, jenv.robot_obs, atol=1e-5)


# -- the entry point -------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cql_dirs(tmp_path_factory):
    """A tiny JAX CQL checkpoint, the same weights as a port checkpoint, and
    an expert-play validation set."""
    from tacorl_tpu_torch.data.expert_play import generate_expert_play

    cfg = {"_target_": "tacorl_tpu.modules.cql.CQLModule", **cql_cfg()}
    jmod = JaxCQLModule(dict(cfg))
    jstate = jmod.init_state(jax.random.key(1), cql_batch())
    jax_dir = tmp_path_factory.mktemp("jax_cql")
    JaxCheckpointManager(jax_dir, config={"module": dict(cfg)}).save(int(jstate.step), jstate)
    port_dir = tmp_path_factory.mktemp("port_cql")
    pmod = CQLModule(dict(cfg), device="cpu")
    pstate = pmod.init_state(0)
    pmod.net.load_state_dict(cql_state_dict_from_jax(np_tree(jstate.params), np_tree(jstate.aux)))
    CheckpointManager(port_dir, config={"module": cfg}).save(0, pstate)
    data = tmp_path_factory.mktemp("cem_eval_data")
    generate_expert_play(data, n_train_episodes=1, n_val_episodes=2, tasks_per_episode=3,
                         idle_steps=(3, 7), seed=11, distinct_tasks=True)
    return jax_dir, port_dir, data / "validation"


def test_evaluate_with_cem_writes_what_scripts_evaluate_writes(cql_dirs, tmp_path):
    jax_dir, port_dir, data_dir = cql_dirs
    common = [f"data_dir={data_dir}", "min_seq_len=1", "max_seq_len=400", "max_rollouts=2",
              "env.max_episode_steps=6", "use_cem=true"] + [f"+cem.{k}={v}" for k, v in CEM.items()]
    port_out, jax_out = tmp_path / "port.json", tmp_path / "jax.json"
    evaluate.main(["+device=cpu", f"module_path={port_dir}", f"filename={port_out}"] + common)
    jax_evaluate([f"module_path={jax_dir}", f"filename={jax_out}"] + common)
    got, want = json.loads(port_out.read_text()), json.loads(jax_out.read_text())
    assert {t: (sorted(r), r["num_rollouts"]) for t, r in got.items()} == {
        t: (sorted(r), r["num_rollouts"]) for t, r in want.items()}
    assert got and all(r["num_rollouts"] > 0 for r in got.values())
