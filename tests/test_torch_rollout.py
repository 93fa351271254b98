"""The port's rollout path held against the JAX package on the CPU at tiny
configs, with weights carried across by tacorl_tpu_torch/utils/convert.py:

* the decoder's streaming ``act`` against the JAX ``act`` with JAX's own
  mixture uniforms (actions, carry, chosen component, gripper), and, in the
  port alone, T streamed steps against one T-step forward;
* the stage-1 rollout pieces (``encode_frame``, ``propose_plan``,
  ``recognize_plan``, ``decode_action``);
* each agent against its JAX agent on one shared observation stream (the
  JAX rollout's own observations, so no closed-loop fork can hide a
  difference), the JAX agent's keys turned into the port's draws;
* whole episodes of each rollout manager, the port's driven by a draw
  source that splits the JAX manager's key chain.

The JAX draws: a replan samples ``eps ~ N(0, 1)`` (1, latent) from its key
(``TanhNormal.sample``); a decode step splits its key into k_mix, k_u and
draws ``u_mix`` (1, 1, A, K) and ``u`` (1, 1, A) on [1e-5, 1 - 1e-5)
(``logistic_mixture_sample``); the TACO-RL plan and the flat CQL action are
deterministic and draw nothing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacorl_tpu.core.checkpoint import load_module_from_checkpoint as jax_load_module
from tacorl_tpu.envs.fake_calvin import FakeCalvinEnv as JaxFakeCalvinEnv
from tacorl_tpu.evaluation import agents as jax_agents
from tacorl_tpu.evaluation import rollout_manager as jax_rm
from tacorl_tpu.modules.cql import CQLModule as JaxCQLModule
from tacorl_tpu.modules.tacorl import TACORLModule as JaxTACORLModule
from tacorl_tpu.networks.action_decoder import ActionDecoderLogistic as JaxDecoder
from tacorl_tpu_torch.core.checkpoint import load_module_from_checkpoint
from tacorl_tpu_torch.envs.fake_calvin import FakeCalvinEnv
from tacorl_tpu_torch.evaluation import agents, rollout_manager as rm
from tacorl_tpu_torch.modules.cql import CQLModule
from tacorl_tpu_torch.modules.tacorl import TACORLModule
from tacorl_tpu_torch.networks.action_decoder import ActionDecoderLogistic
from tacorl_tpu_torch.ops import image_aug
from tacorl_tpu_torch.utils.convert import (
    action_decoder_state_dict,
    cql_state_dict_from_jax,
    tacorl_state_dict_from_jax,
)
from tests.test_torch_cql import _batch as cql_batch, _cfg as cql_cfg, np_tree
from tests.test_torch_tacorl import LATENT, _batch as tacorl_batch, _tacorl_cfg, lmp_dirs  # noqa: F401

A, K = 6, 4  # continuous action columns, mixtures (the tiny decoder's)
ATOL = 1e-5
R1, R2 = 1e-5, 1.0 - 1e-5


def _np(x):
    return np.array(x)


def decode_draws(key, a=A, k=K):
    """The uniforms the JAX decoder draws from its key."""
    k_mix, k_u = jax.random.split(key)
    return {
        "u_mix": torch.from_numpy(_np(jax.random.uniform(k_mix, (1, 1, a, k), minval=R1, maxval=R2))),
        "u": torch.from_numpy(_np(jax.random.uniform(k_u, (1, 1, a), minval=R1, maxval=R2))),
    }


def draws_from_key(family, call, key):
    if call == "decode":
        return decode_draws(key)
    if family == "play_lmp" and call == "propose":
        return {"eps": torch.from_numpy(_np(jax.random.normal(key, (1, LATENT))))}
    return None  # the TACO-RL plan and the flat action draw nothing


def jax_draw_source(family, seed=0):
    """The JAX manager's key chain (key, sub = split(key) per agent call),
    each key turned into the draws the JAX agent makes from it."""
    chain = {"key": jax.random.key(seed)}

    def source(call):
        chain["key"], sub = jax.random.split(chain["key"])
        return draws_from_key(family, call, sub)

    return source


# -- the decoder's streaming act ---------------------------------------------------

DEC = dict(state_dim=8, latent_plan_dim=5, hidden_size=16, num_layers=2, n_mixtures=K)


@pytest.fixture(scope="module")
def decoders():
    jdec = JaxDecoder(**DEC)
    emb = jnp.zeros((2, 3, DEC["state_dim"]))
    params = jdec.init(jax.random.key(3), jnp.zeros((2, DEC["latent_plan_dim"])), emb)["params"]
    pdec = ActionDecoderLogistic(**DEC)
    pdec.load_state_dict(action_decoder_state_dict(np_tree(params)))
    return jdec, params, pdec.eval()


def _component(logit_probs, u_mix):
    return np.argmax(np.asarray(logit_probs) - np.log(-np.log(np.asarray(u_mix))), axis=-1)


def test_decoder_act_streams_like_jax(decoders):
    jdec, params, pdec = decoders
    rs = np.random.RandomState(0)
    plan = rs.randn(2, DEC["latent_plan_dim"]).astype(np.float32)
    jcarry, pcarry = None, None
    for t in range(6):
        emb = rs.randn(2, 1, DEC["state_dim"]).astype(np.float32)
        key = jax.random.key(t)
        jact, jcarry_next = jdec.apply({"params": params}, key, plan, emb, None, jcarry, method="act")
        k_mix, k_u = jax.random.split(key)
        draws = {
            "u_mix": torch.from_numpy(_np(jax.random.uniform(k_mix, (2, 1, A, K), minval=R1, maxval=R2))),
            "u": torch.from_numpy(_np(jax.random.uniform(k_u, (2, 1, A), minval=R1, maxval=R2))),
        }
        with torch.no_grad():
            logits = pdec(torch.from_numpy(plan), torch.from_numpy(emb), None, pcarry)[0]
            pact, pcarry = pdec.act(torch.from_numpy(plan), torch.from_numpy(emb), None, pcarry, draws)
        jlogits = jdec.apply({"params": params}, plan, emb, None, jcarry)[0]
        jcarry = jcarry_next
        # the Gumbel-max choice, exactly: a flip would move the action by a
        # whole component
        np.testing.assert_array_equal(
            _component(logits.numpy(), draws["u_mix"]), _component(jlogits, draws["u_mix"]),
            err_msg=f"mixture component differs at step {t}",
        )
        np.testing.assert_allclose(pact[..., :-1].numpy(), _np(jact)[..., :-1], atol=ATOL, err_msg=f"step {t}")
        np.testing.assert_array_equal(pact[..., -1].numpy(), _np(jact)[..., -1])
        # the JAX carry is a tuple of per-layer (B, H); nn.RNN's is (L, B, H)
        np.testing.assert_allclose(pcarry.numpy(), np.stack([_np(c) for c in jcarry]), atol=ATOL)
    assert pcarry.shape == (2, 2, DEC["hidden_size"])


def test_streamed_steps_equal_one_window_forward(decoders):
    _, _, pdec = decoders
    g = torch.Generator().manual_seed(0)
    plan = torch.randn(3, DEC["latent_plan_dim"], generator=g)
    emb = torch.randn(3, 7, DEC["state_dim"], generator=g)
    u_mix = torch.rand(3, 7, A, K, generator=g) * (R2 - R1) + R1
    u = torch.rand(3, 7, A, generator=g) * (R2 - R1) + R1
    with torch.no_grad():
        window = pdec(plan, emb)
        window_act, window_carry = pdec.act(plan, emb, draws={"u_mix": u_mix, "u": u})
        carry, acts = None, []
        for t in range(7):
            step = pdec(plan, emb[:, t : t + 1], None, carry)
            for a, b in zip(step[:4], window[:4]):
                torch.testing.assert_close(a, b[:, t : t + 1], atol=1e-6, rtol=1e-6)
            act, carry = pdec.act(
                plan, emb[:, t : t + 1], None, carry,
                {"u_mix": u_mix[:, t : t + 1], "u": u[:, t : t + 1]},
            )
            acts.append(act)
    torch.testing.assert_close(torch.cat(acts, dim=1), window_act, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(carry, window_carry, atol=1e-6, rtol=1e-6)


def test_act_draws_missing_uniforms_from_the_generator(decoders):
    _, _, pdec = decoders
    plan, emb = torch.zeros(1, DEC["latent_plan_dim"]), torch.ones(1, 1, DEC["state_dim"])
    with torch.no_grad():
        a1, _ = pdec.act(plan, emb, generator=torch.Generator().manual_seed(5))
        a2, _ = pdec.act(plan, emb, generator=torch.Generator().manual_seed(5))
        a3, _ = pdec.act(plan, emb, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a1, a2) and not torch.equal(a1, a3)
    assert a1.shape == (1, 1, A + 1) and set(a1[..., -1].flatten().tolist()) <= {-1.0, 1.0}


# -- stage-1 pieces and the LMP agent -------------------------------------------------


@pytest.fixture(scope="module")
def lmp_modules(lmp_dirs):  # noqa: F811
    """The same tiny Play-LMP in both packages (tests/test_torch_tacorl.py's
    checkpoints)."""
    jax_dir, port_dir = lmp_dirs
    jmod, jstate = jax_load_module(jax_dir)
    pmod, pstate = load_module_from_checkpoint(port_dir, device="cpu")
    return jmod, jstate, pmod, pstate


def _frames(seed, n=1, hw=64):
    rs = np.random.RandomState(seed)
    return {"rgb_static": rs.randint(0, 256, (n, hw, hw, 3), dtype=np.uint8)}


def test_stage1_pieces_match_jax(lmp_modules):
    jmod, jstate, pmod, pstate = lmp_modules
    p = {"params": jstate.params}
    net = pstate.net.eval()
    obs, goal = _frames(1, n=2), _frames(2, n=2)
    jobs = jmod.transforms(jax.random.key(0), obs, train=False)
    jgoal = jmod.transforms(jax.random.key(0), goal, train=False)
    pobs, pgoal = pmod.transforms(obs, train=False), pmod.transforms(goal, train=False)
    with torch.no_grad():
        np.testing.assert_allclose(
            net.encode_frame(pobs, ["rgb_static"]).numpy(),
            _np(jmod.net.apply(p, jobs, ["rgb_static"], method="encode_frame")), atol=ATOL)
        pdist = net.propose_plan(pobs, pgoal)
        jdist = jmod.net.apply(p, jobs, jgoal, method="propose_plan")
        np.testing.assert_allclose(pdist.mean.numpy(), _np(jdist.mean), atol=ATOL)
        np.testing.assert_allclose(pdist.std.numpy(), _np(jdist.std), atol=ATOL)
        window = {"rgb_static": np.random.RandomState(3).randint(0, 256, (2, 4, 64, 64, 3), dtype=np.uint8)}
        prec = net.recognize_plan(pmod.transforms(window, train=False))
        jrec = jmod.net.apply(p, jmod.transforms(jax.random.key(0), window, train=False),
                              method="recognize_plan")
        np.testing.assert_allclose(prec.mean.numpy(), _np(jrec.mean), atol=ATOL)
        np.testing.assert_allclose(prec.std.numpy(), _np(jrec.std), atol=ATOL)
        plan = np.random.RandomState(4).uniform(-1, 1, (2, LATENT)).astype(np.float32)
        jcarry = None
        pcarry = None
        for t in range(3):
            key = jax.random.key(10 + t)
            k_mix, k_u = jax.random.split(key)
            draws = {
                "u_mix": torch.from_numpy(_np(jax.random.uniform(k_mix, (2, 1, A, K), minval=R1, maxval=R2))),
                "u": torch.from_numpy(_np(jax.random.uniform(k_u, (2, 1, A), minval=R1, maxval=R2))),
            }
            frame = _frames(20 + t, n=2)
            jact, jcarry = jmod.net.apply(
                p, key, plan, jmod.transforms(key, frame, train=False), jcarry, method="decode_action")
            pact, pcarry = net.decode_action(
                torch.from_numpy(plan), pmod.transforms(frame, train=False), pcarry, draws=draws)
            np.testing.assert_allclose(pact[:, :-1].numpy(), _np(jact)[:, :-1], atol=ATOL)
            np.testing.assert_array_equal(pact[:, -1].numpy(), _np(jact)[:, -1])
            np.testing.assert_allclose(pcarry.numpy(), np.stack([_np(c) for c in jcarry]), atol=ATOL)


class _Recorder:
    """Wraps a JAX agent and records each call: its kind, observation, key
    and output, and the agent's carry after a decode step."""

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
        self.calls.append(("propose", obs, key, _np(plan)))
        return plan

    def decode_step(self, obs, plan, key):
        out = self.agent.decode_step(obs, plan, key)
        self.calls.append(("decode", obs, key, (out, np.stack([_np(c) for c in self.agent.carry]))))
        return out


def _replay(family, calls, agent):
    """Feeds the JAX rollout's observations and keys to the port agent;
    returns the number of actions compared."""
    plan, compared = None, 0
    for i, (kind, obs, key, want) in enumerate(calls):
        draws = None if key is None else draws_from_key(family, kind, key)
        if kind == "reset":
            agent.reset()
        elif kind == "act":
            got = agent.act(obs, draws)
            np.testing.assert_allclose(got[:-1], want[:-1], atol=ATOL, err_msg=f"call {i}")
            assert got[-1] == want[-1], f"gripper differs at call {i}"
            compared += 1
        elif kind == "propose":
            plan = agent.propose_plan(obs, draws)
            np.testing.assert_allclose(plan.numpy(), want, atol=ATOL, err_msg=f"plan at call {i}")
        else:
            got = agent.decode_step(obs, plan, draws)
            action, carry = want
            np.testing.assert_allclose(got[:-1], action[:-1], atol=ATOL, err_msg=f"call {i}")
            assert got[-1] == action[-1], f"gripper differs at call {i}"
            np.testing.assert_allclose(agent.carry.numpy(), carry, atol=ATOL, err_msg=f"carry at call {i}")
            compared += 1
    return compared


RESET = {"task_info": {"task": "open_drawer", "index": 0}}


def _env(module, steps=20):
    return module(image_hw=64, max_episode_steps=steps, seed=0)


@pytest.fixture(scope="module")
def agent_pairs(lmp_modules, lmp_dirs):  # noqa: F811
    """(JAX agent, port agent, JAX manager class, port manager class) per
    family, on the same weights."""
    jmod, jstate, pmod, pstate = lmp_modules
    pairs = {"play_lmp": (jax_agents.LatentPlanAgent(jmod, jstate), agents.make_agent(pmod, pstate))}

    jax_dir, port_dir = lmp_dirs
    jt = JaxTACORLModule(_tacorl_cfg(jax_dir))
    jts = jt.init_state(jax.random.key(1), tacorl_batch())
    pt = TACORLModule(_tacorl_cfg(port_dir), device="cpu")
    pts = pt.init_state(0)
    pt.net.load_state_dict(tacorl_state_dict_from_jax(np_tree(jts.params), np_tree(jts.aux)))
    pairs["tacorl"] = (jax_agents.TACORLAgent(jt, jts), agents.make_agent(pt, pts))

    jc = JaxCQLModule(cql_cfg())
    jcs = jc.init_state(jax.random.key(1), cql_batch())
    pc = CQLModule(cql_cfg(), device="cpu")
    pcs = pc.init_state(0)
    pc.net.load_state_dict(cql_state_dict_from_jax(np_tree(jcs.params), np_tree(jcs.aux)))
    pairs["cql"] = (jax_agents.FlatPolicyAgent(jc, jcs), agents.make_agent(pc, pcs))
    return pairs


FAMILIES = {
    "play_lmp": (jax_rm.LatentPlanRollout, rm.LatentPlanRollout, agents.LatentPlanAgent),
    "tacorl": (jax_rm.TACORLRollout, rm.TACORLRollout, agents.TACORLAgent),
    "cql": (jax_rm.RLRollout, rm.RLRollout, agents.FlatPolicyAgent),
}


def _manager(cls, **kw):
    return cls(**kw) if cls in (jax_rm.RLRollout, rm.RLRollout) else cls(plan_duration=6, **kw)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_make_agent_picks_the_jax_agent_and_manager(agent_pairs, family):
    jax_cls, port_cls, agent_cls = FAMILIES[family]
    (agent, manager_cls) = agent_pairs[family][1]
    assert type(agent) is agent_cls and manager_cls is port_cls
    assert manager_cls.__name__ == jax_cls.__name__


@pytest.mark.parametrize("family", list(FAMILIES))
def test_agent_matches_jax_on_a_shared_observation_stream(agent_pairs, family):
    jagent, (pagent, _) = agent_pairs[family]
    jax_manager_cls = FAMILIES[family][0]
    recorder = _Recorder(jagent)
    env = _env(JaxFakeCalvinEnv)
    manager = _manager(jax_manager_cls)
    for _ in range(2):
        manager.episode_rollout(recorder, env, RESET)
    kinds = [c[0] for c in recorder.calls]
    if family != "cql":
        assert kinds.count("propose") >= 6  # replans inside each episode
    assert _replay(family, recorder.calls, pagent) == 40


@pytest.mark.parametrize("family", list(FAMILIES))
def test_whole_episodes_match_jax(agent_pairs, family):
    """Two episodes from one manager each (the key chain runs on), the
    port's manager driven by the JAX key chain's draws."""
    jagent, (pagent, _) = agent_pairs[family]
    jax_manager_cls, port_manager_cls, _ = FAMILIES[family]
    jmanager = _manager(jax_manager_cls, seed=3)
    pmanager = _manager(port_manager_cls, seed=3, draw_source=jax_draw_source(family, seed=3))
    jenv, penv = _env(JaxFakeCalvinEnv, 25), _env(FakeCalvinEnv, 25)
    for reset in (RESET, {"task_info": {"task": "lift_block", "index": 2}}):
        want = jmanager.episode_rollout(jagent, jenv, reset)
        got = pmanager.episode_rollout(pagent, penv, reset)
        assert got == want
        assert got["episode_length"] == 25
    np.testing.assert_allclose(penv.robot_obs, jenv.robot_obs, atol=ATOL)


def test_manager_generator_lives_on_the_agent_device_and_runs_on(agent_pairs):
    """Without a draw source the port manager draws from its own seeded
    generator, which carries on across episodes."""
    _, (pagent, _) = agent_pairs["play_lmp"]

    def episodes(manager):
        env = _env(FakeCalvinEnv, 8)
        return [manager.episode_rollout(pagent, env, RESET) for _ in range(2)], env.robot_obs.copy()

    m1 = rm.LatentPlanRollout(plan_duration=4, seed=0)
    first, pos1 = episodes(m1)
    assert m1._generator.device == torch.device("cpu")
    second, pos2 = episodes(rm.LatentPlanRollout(plan_duration=4, seed=0))
    _, pos3 = episodes(rm.LatentPlanRollout(plan_duration=4, seed=1))
    assert first == second and np.array_equal(pos1, pos2)
    assert not np.array_equal(pos1, pos3)


def test_interpolation_matrices_are_made_once_per_device():
    """The eval transform's interpolation matrices are built and copied to
    the device once: later calls reuse them, with the same values."""
    x = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, 3, 60, 50), dtype=np.uint8))
    first = image_aug.augment_rgb_eval(x, (40, 30))
    hits = image_aug._interp_on.cache_info().hits
    again = image_aug.augment_rgb_eval(x, (40, 30))
    assert image_aug._interp_on.cache_info().hits == hits + 2
    assert torch.equal(first, again)
    want = torch.as_tensor(image_aug._interp_matrix(60, 40))
    assert torch.equal(image_aug._interp(60, 40, x, torch.float32), want)
    with torch.inference_mode():
        made = image_aug._interp(61, 41, x, torch.float32)
    assert not made.is_inference()  # a rollout's matrix serves training too
