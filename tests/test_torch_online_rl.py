"""Online RL of the port (SAC, CQL-online, the replay buffer, the online
data module, the threaded vec env) held against the JAX package on the CPU:

  * the replay buffer: bit-equal batches for the same transitions and numpy
    seed, files saved by either package load in the other, eviction and
    the file index as the JAX buffer's;
  * ThreadedVecEnv over three FakeCalvinEnvs: observations, rewards, dones
    and terminal observations bit-equal; the parallel and the warm-start
    fills (``random``, ``zeros``) give bit-equal buffers;
  * one SAC and one CQL-online train step, visual (the tiny config of
    tests/test_online_rl.py, the JAX Pallas tail in interpret mode) and on
    vectors (the ``*_online_fake`` layout at narrow widths), from the same
    weights and with JAX's draws, the play step's included: the play
    action at atol 1e-5, metrics rtol 1e-5, gradients atol 1e-5 + rtol
    1e-4, post-Adam parameters atol 2.5 lr;
  * the online batches over 2 epochs with env steps in between, the
    trainer's example draw included: bit-equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacorl_tpu.data.loader import device_prefetch as jax_device_prefetch
from tacorl_tpu.data.online_datamodule import OnlineRLDataModule as JaxOnlineRLDataModule
from tacorl_tpu.data.replay_buffer import ReplayBuffer as JaxReplayBuffer
from tacorl_tpu.envs.fake_calvin import FakeCalvinEnv as JaxFakeCalvinEnv
from tacorl_tpu.envs.vec_env import ThreadedVecEnv as JaxThreadedVecEnv
from tacorl_tpu.modules.cql_online import CQLOnlineModule as JaxCQLOnlineModule
from tacorl_tpu.modules.sac import SACModule as JaxSACModule
from tacorl_tpu.ops import pallas_aug
from tacorl_tpu_torch.data.loader import DevicePut, device_prefetch
from tacorl_tpu_torch.data.online_datamodule import OnlineRLDataModule
from tacorl_tpu_torch.data.replay_buffer import ReplayBuffer
from tacorl_tpu_torch.envs.fake_calvin import FakeCalvinEnv
from tacorl_tpu_torch.envs.vec_env import ThreadedVecEnv
from tacorl_tpu_torch.modules.cql_online import CQLOnlineModule
from tacorl_tpu_torch.modules.sac import SACModule
from tacorl_tpu_torch.utils.convert import cql_state_dict_from_jax
from tests.test_torch_cql import actor_draws, cql_draws, nested_aug_draws, np_tree
from tests.test_torch_cql_flat import _group_grads, _port_group_names

B, N_ACT, LR, HW, PAD = 4, 3, 1e-3, 48, 2
FAKE = "tacorl_tpu.envs.fake_calvin."
VECTOR_DIMS = {"robot_obs": 15, "scene_obs": 24}
ENC = {"networks": {"rgb_static": {
    "_target_": "tacorl_tpu.networks.encoders.LMPVisionEncoder",
    "latent_dim": 8, "hidden_dim": 16, "compute_dtype": None,
}}}


def visual_cfg():
    """tests/test_online_rl.py:SAC_CFG with float32 convolutions and the
    Pallas tail (the port's kernel path)."""
    return {
        "action_dim": 7, "actor_lr": LR, "critic_lr": LR,
        "obs_modalities": ["rgb_static"], "goal_modalities": ["rgb_static"],
        "actor_encoder": ENC, "critic_encoder": ENC, "goal_encoder": {"hidden_size": 16},
        "policy": {"num_layers": 2, "hidden_dim": 16, "discrete_gripper": True},
        "q_network": {"num_layers": 2, "hidden_dim": 16},
        "warm_start_steps": 24, "replay_buffer_size": 1000, "n_action_samples": N_ACT,
        "transforms": {"rgb_static": {"kind": "rgb", "size": [HW, HW], "pad": PAD, "use_pallas": True}},
        "env": {"_target_": FAKE + "FakeCalvinEnv", "image_hw": HW, "max_episode_steps": 5},
    }


def vector_cfg():
    """configs/experiment/sac_online_fake.yaml's module at narrow widths."""
    mods = ["robot_obs", "scene_obs"]
    return {
        "action_dim": 7, "actor_lr": LR, "critic_lr": LR, "discount": 0.9,
        "obs_modalities": mods, "goal_modalities": mods, "vector_dims": dict(VECTOR_DIMS),
        "actor_encoder": ENC, "critic_encoder": ENC, "goal_encoder": {"hidden_size": 16},
        "policy": {"num_layers": 2, "hidden_dim": 16, "discrete_gripper": True},
        "q_network": {"num_layers": 2, "hidden_dim": 16},
        "warm_start_steps": 24, "replay_buffer_size": 1000, "n_action_samples": N_ACT,
        "conservative_weight": 0.3,
        "transforms": {m: {"kind": "vector"} for m in mods},
        "env": {"_target_": FAKE + "FakePlayTableEnv", "task": "open_drawer", "dense_reward": True,
                "tcp_shaping_weight": 1.0, "modalities": mods, "goal_modalities": mods,
                "max_episode_steps": 4},
    }


MODULES = {"sac": (JaxSACModule, SACModule), "cql_online": (JaxCQLOnlineModule, CQLOnlineModule)}


def _cfg(layout, family):
    cfg = {"visual": visual_cfg, "vector": vector_cfg}[layout]()
    if family == "cql_online":
        cfg["with_lagrange"] = True  # configs/module/cql_online.yaml
    return cfg


def assert_trees_equal(got, want, what=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), what
        for k in want:
            assert_trees_equal(got[k], want[k], f"{what}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def assert_buffers_equal(got, want):
    assert len(got) == len(want)
    assert (got.curr_file_idx, got.unsaved_transitions) == (want.curr_file_idx, want.unsaved_transitions)
    for i, (g, w) in enumerate(zip(got.buffer, want.buffer)):
        for field in ("state", "action", "next_state", "reward", "done"):
            assert_trees_equal(getattr(g, field), getattr(w, field), f"transition {i} {field}")


# -- the replay buffer ----------------------------------------------------------------


def _transitions(n, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        obs = lambda: {  # noqa: E731
            "observation": {"rgb_static": rs.randint(0, 256, (6, 6, 3), dtype=np.uint8),
                            "robot_obs": rs.randn(15).astype(np.float32)},
            "goal": {"rgb_static": rs.randint(0, 256, (6, 6, 3), dtype=np.uint8),
                     "robot_obs": rs.randn(15).astype(np.float32)},
        }
        out.append((obs(), rs.uniform(-1, 1, 7).astype(np.float32), obs(), float(rs.randn()), i % 3 == 0))
    return out


def _filled(cls, n, maxlen=100):
    buf = cls(maxlen)
    for t in _transitions(n):
        buf.add_transition(*t)
    return buf


@pytest.mark.parametrize("batch_size", [4, 16])
def test_replay_buffer_samples_bit_equal(batch_size):
    jbuf, pbuf = _filled(JaxReplayBuffer, 10), _filled(ReplayBuffer, 10)
    jrng, prng = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(3):
        want, got = jbuf.sample(batch_size, jrng), pbuf.sample(batch_size, prng)
        assert got["actions"].shape == (min(batch_size, 10), 7)
        assert_trees_equal(got, want)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_replay_buffer_files_load_in_the_other_package(tmp_path, direction):
    writer, reader = (JaxReplayBuffer, ReplayBuffer) if direction == "jax_to_port" else (ReplayBuffer, JaxReplayBuffer)
    saved = _filled(writer, 7)
    assert saved.save(tmp_path) and not saved.save(tmp_path)  # nothing new the second time
    assert sorted(p.name for p in tmp_path.iterdir()) == [f"transition_{i:09d}.npz" for i in range(1, 8)]
    loaded, twin = reader(100), writer(100)
    assert loaded.load(tmp_path) and twin.load(tmp_path)
    assert_buffers_equal(loaded, twin)
    assert loaded.curr_file_idx == 8 and len(loaded) == 7
    for g, (state, action, next_state, reward, done) in zip(loaded.buffer, _transitions(7)):
        assert_trees_equal(g.state, state)
        assert_trees_equal(g.next_state, next_state)
        np.testing.assert_array_equal(g.action, action)
        assert (g.reward, g.done) == (reward, done)


def test_replay_buffer_eviction_and_file_index_match_jax(tmp_path):
    """maxlen 5 after 8 appends, saved, 2 more, saved again, then loaded back
    into a buffer of 4: the same transitions, files and indices."""
    bufs = {}
    for name, cls in (("jax", JaxReplayBuffer), ("port", ReplayBuffer)):
        buf = _filled(cls, 8, maxlen=5)
        buf.save(tmp_path / name)
        for t in _transitions(2, seed=1):
            buf.add_transition(*t)
        buf.save(tmp_path / name)
        back = cls(4)
        back.load(tmp_path / name)
        bufs[name] = (buf, back, sorted(p.name for p in (tmp_path / name).iterdir()))
    (jbuf, jback, jfiles), (pbuf, pback, pfiles) = bufs["jax"], bufs["port"]
    assert pfiles == jfiles and len(pfiles) == 10
    assert_buffers_equal(pbuf, jbuf)
    assert_buffers_equal(pback, jback)
    assert pbuf.curr_file_idx == 11 and pback.curr_file_idx == 11 and len(pback) == 4
    for f in pfiles:
        want, got = np.load(tmp_path / "jax" / f, allow_pickle=True), np.load(tmp_path / "port" / f, allow_pickle=True)
        assert_trees_equal(got["state"].item(), want["state"].item(), f)
        np.testing.assert_array_equal(got["action"], want["action"])


# -- the vec env and the fills ----------------------------------------------------------


def _envs(cls):
    return [lambda s=s: cls(image_hw=32, max_episode_steps=4, seed=s) for s in range(3)]


def test_threaded_vec_env_steps_bit_equal_to_jax():
    jvec, pvec = JaxThreadedVecEnv(_envs(JaxFakeCalvinEnv)), ThreadedVecEnv(_envs(FakeCalvinEnv))
    assert pvec.num_envs == len(pvec) == 3
    for g, w in zip(pvec.reset(), jvec.reset()):
        assert_trees_equal(g, w)
    rs = np.random.RandomState(0)
    terminals = 0
    for step in range(9):
        actions = [rs.uniform(-1, 1, 7).astype(np.float32) for _ in range(3)]
        (pobs, prew, pdone, pinfo), (jobs, jrew, jdone, jinfo) = pvec.step(actions), jvec.step(actions)
        np.testing.assert_array_equal(prew, jrew)
        np.testing.assert_array_equal(pdone, jdone)
        for i in range(3):
            assert_trees_equal(pobs[i], jobs[i], f"step {step} env {i}")
            assert ("terminal_observation" in pinfo[i]) == bool(jdone[i])
            if jdone[i]:
                terminals += 1
                assert_trees_equal(pinfo[i]["terminal_observation"], jinfo[i]["terminal_observation"])
    assert terminals >= 3  # every env auto-reset at least once
    pvec.close()
    jvec.close()


def _populated(family, cfg, strategy=None, **populate_kw):
    if strategy is not None:
        cfg["fill_strategy"] = strategy
    jcls, pcls = MODULES[family]
    jmod, pmod = jcls(cfg), pcls(cfg, device="cpu")
    jmod.populate(None, **populate_kw)
    pmod.populate(None, **populate_kw)
    return jmod, pmod


def test_parallel_populate_fills_a_bit_equal_buffer():
    cfg = visual_cfg()
    cfg.update(num_parallel_envs=3, warm_start_steps=12)
    cfg["env"].update(image_hw=32, max_episode_steps=3)
    jmod, pmod = _populated("sac", cfg)
    assert len(pmod.replay_buffer) == 12 and any(t.done for t in pmod.replay_buffer.buffer)
    assert_buffers_equal(pmod.replay_buffer, jmod.replay_buffer)


@pytest.mark.parametrize("strategy", ["random", "zeros", "stochastic"])
def test_warm_start_fills_a_bit_equal_buffer(strategy):
    """FakePlayTableEnv, seed 0; without a net ``stochastic`` falls back to
    ``random`` in both packages. The random gripper is continuous."""
    jmod, pmod = _populated("sac", vector_cfg(), strategy)
    buf = pmod.replay_buffer
    assert len(buf) == 24 and buf.unsaved_transitions == 24 and pmod.episode_number == 6
    actions = np.stack([t.action for t in buf.buffer])
    if strategy == "zeros":
        assert not actions.any()
    else:
        assert actions.dtype == np.float32 and np.abs(actions).max() <= 1.0
        assert len(np.unique(actions[:, -1])) == 24
    assert_buffers_equal(buf, jmod.replay_buffer)
    assert list(pmod.episodes_returns) == list(jmod.episodes_returns)
    assert (pmod.episode_number, list(pmod.accuracies)) == (jmod.episode_number, list(jmod.accuracies))


# -- the online batches ------------------------------------------------------------------------


def test_online_batches_over_two_epochs_are_bit_equal():
    """Each package's data module and prefetch over its own module: the
    trainer's example draw, then 2 epochs of 3 batches with a (random) env
    step after each, so every batch after the first sees a grown buffer."""
    jmod, pmod = _populated("sac", vector_cfg(), steps=10)
    got, want = [], []
    for mod, dm_cls, prefetch, put, out in (
        (jmod, JaxOnlineRLDataModule, jax_device_prefetch, lambda b: b, want),
        (pmod, OnlineRLDataModule, device_prefetch, DevicePut("cpu"), got),
    ):
        dm = dm_cls(batch_size=8, steps_per_epoch=3, seed=5)
        dm.set_module(mod)
        dm.setup()
        loader = dm.train_loader()
        assert len(loader) == 3 and dm.val_loader() is None
        out.append(next(iter(loader)))
        for _ in range(2):
            for batch in prefetch(iter(loader), put, 1):
                out.append(batch)
                mod.play_step(None, "random")
    assert len(got) == len(want) == 7
    assert len(pmod.replay_buffer) == len(jmod.replay_buffer) == 16
    for i, (g, w) in enumerate(zip(got, want)):
        assert_trees_equal({k: np.asarray(v) for k, v in _flat(g).items()}, _flat(w), f"batch {i}")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def test_setup_needs_the_module_and_an_env():
    dm = OnlineRLDataModule()
    with pytest.raises(RuntimeError, match="set_module"):
        dm.setup()
    cfg = vector_cfg()
    cfg.pop("env")
    dm.set_module(SACModule(cfg, device="cpu"))
    with pytest.raises(RuntimeError, match="attach_env"):
        dm.setup()
    with pytest.raises(RuntimeError, match="attach_env"):
        dm.module.play_step(None, "random")


# -- one SAC / CQL-online train step against JAX ----------------------------------------------


SAC_METRICS = ["alpha", "alpha_loss", "actor_loss"] + [
    m.format(q) for q in ("q1", "q2") for m in ("{}_data", "bellman_{}_loss", "{}_loss")
]
CONSERVATIVE = ["alpha_prime", "alpha_prime_loss"] + [
    m.format(q) for q in ("q1", "q2")
    for m in ("{}_random", "{}_policy", "conservative_{}_loss", "conservative_{}_gap")
]
def step_draws(key, visual: bool):
    """The draws of one JAX CQL update from its (folded) step key."""
    draws = cql_draws(key, B, N_ACT, 7, discrete_gripper=True)
    if visual:
        k_aug = jax.random.split(key, 7)[0]
        draws["aug_obs"] = nested_aug_draws(k_aug, B, PAD)
        draws["aug_next_obs"] = nested_aug_draws(jax.random.fold_in(k_aug, 1), B, PAD)
    return draws


def run_step_case(family, layout):
    """One train step of each package from the same weights, buffer and
    batch, with JAX's draws; the visual layout's cases run in
    tests/test_torch_online_rl_visual.py."""
    visual = layout == "visual"
    mods = ("rgb_static",) if visual else ()
    jcls, pcls = MODULES[family]
    tail = pallas_aug.pallas_augment_tail
    pallas_aug.pallas_augment_tail = functools.partial(tail, interpret=True)
    try:
        jmod = jcls(_cfg(layout, family))
        jmod.populate(None, steps=8)
        batch = jmod.replay_buffer.sample(B, np.random.default_rng(5))
        jstate = jmod.init_state(jax.random.key(1), batch)
        params0, aux0 = np_tree(jstate.params), np_tree(jstate.aux)
        jgrads = {}
        update_group = jmod.optimizer.update_group

        def recording(name, grads, opt_state, params):
            jax.debug.callback(lambda g: jgrads.__setitem__(name, np_tree(g)), grads)
            return update_group(name, grads, opt_state, params)

        jmod.optimizer.update_group = recording
        play_key = jax.random.split(jmod._play_key)[1]
        rng = jax.random.key(0)
        jstate1, jmetrics = jmod.make_train_step()(
            jax.tree.map(jnp.copy, jstate), batch, rng, {"bc_phase": jnp.asarray(0.0)}
        )
        jax.block_until_ready(jstate1.params)
    finally:
        pallas_aug.pallas_augment_tail = tail

    pmod = pcls(_cfg(layout, family), device="cpu")
    pmod.populate(None, steps=8)
    pbatch = pmod.replay_buffer.sample(B, np.random.default_rng(5))
    pstate = pmod.init_state(0)
    sd0 = cql_state_dict_from_jax(params0, aux0, mods)
    pstate.net.load_state_dict(sd0)
    pgrads = {}
    step_group = pstate.optimizer.step_group

    def recording_port(name, grads):
        pgrads[name] = dict(zip(_port_group_names(pmod.net, name), [g.clone() for g in grads]))
        return step_group(name, grads)

    pstate.optimizer.step_group = recording_port
    draws = step_draws(jax.random.fold_in(rng, 0), visual)
    draws["play"] = {"action": actor_draws(play_key, (1,), 7, True)}
    if visual:
        draws["play"]["aug"] = nested_aug_draws(play_key, 1, PAD)
    pstate, pmetrics = pmod.make_train_step()(pstate, pbatch, {"bc_phase": 0.0}, draws=draws)
    return {
        "family": family, "layout": layout, "jmod": jmod, "pmod": pmod,
        "batches": (pbatch, batch), "params0": params0,
        "jax": {k: float(v) for k, v in jmetrics.items()},
        "port": {k: float(v) for k, v in pmetrics.items()},
        "jax_grads": {k: _group_grads(v, k, mods) for k, v in jgrads.items()},
        "port_grads": pgrads,
        "jax_sd1": cql_state_dict_from_jax(np_tree(jstate1.params), np_tree(jstate1.aux), mods),
        "port_sd1": pstate.net.state_dict(),
        "sd0": sd0, "step": pstate.step,
    }


@pytest.fixture(scope="module", params=["sac", "cql_online"])
def step_case(request):
    return run_step_case(request.param, "vector")


def test_the_step_samples_the_same_batch(step_case):
    got, want = step_case["batches"]
    assert_trees_equal(got, want)


def test_sac_state_has_lagrange_only_when_configured(step_case):
    """SAC defaults with_lagrange to False: no log_alpha_prime in either
    package's state; CQL-online's config sets it."""
    lagrange = step_case["family"] == "cql_online"
    assert ("log_alpha_prime" in step_case["params0"]) == lagrange
    assert ("log_alpha_prime" in step_case["port_sd1"]) == lagrange
    assert ("log_alpha_prime" in step_case["pmod"].group_hparams) == lagrange
    assert {k: tuple(v.shape) for k, v in step_case["port_sd1"].items()} == {
        k: tuple(v.shape) for k, v in step_case["sd0"].items()
    }


def test_the_play_step_matches_jax(step_case):
    """The env step of the train step: the action from the pre-update
    parameters at atol 1e-5 (the gripper equal), the transition it appends
    otherwise equal."""
    jbuf, pbuf = step_case["jmod"].replay_buffer, step_case["pmod"].replay_buffer
    assert len(pbuf) == len(jbuf) == 9 and step_case["step"] == 1
    got, want = pbuf.buffer[-1], jbuf.buffer[-1]
    np.testing.assert_allclose(got.action, want.action, atol=1e-5, rtol=0)
    assert got.action.dtype == want.action.dtype and got.action[-1] == want.action[-1]
    assert_trees_equal(got.state, want.state)
    assert got.done == want.done
    np.testing.assert_allclose(got.reward, want.reward, atol=1e-5)
    for part in ("observation", "goal"):
        for k, v in want.next_state[part].items():
            np.testing.assert_allclose(got.next_state[part][k], v, atol=1e-5 if v.dtype != np.uint8 else 0)


def test_the_metric_keys_match_jax(step_case):
    want = SAC_METRICS + (CONSERVATIVE if step_case["family"] == "cql_online" else [])
    assert set(step_case["port"]) == set(step_case["jax"]) == set(want)


@pytest.mark.parametrize("name", SAC_METRICS + CONSERVATIVE)
def test_train_step_metric_matches_jax(step_case, name):
    if name not in step_case["jax"]:
        assert name not in step_case["port"]
        return
    np.testing.assert_allclose(step_case["port"][name], step_case["jax"][name], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("group", ["actor", "q1", "q2", "log_alpha", "log_alpha_prime"])
def test_train_step_grads_match_jax(step_case, group):
    if group not in step_case["jax_grads"]:
        assert group not in step_case["port_grads"] and step_case["family"] == "sac"
        return
    want, got = step_case["jax_grads"][group], step_case["port_grads"][group]
    assert set(want) == set(got)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), atol=1e-5, rtol=1e-4, err_msg=name)


def test_post_step_params_match_jax(step_case):
    assert set(step_case["port_sd1"]) == set(step_case["jax_sd1"])
    for name, want in step_case["jax_sd1"].items():
        np.testing.assert_allclose(
            step_case["port_sd1"][name].numpy(), want.numpy(), atol=2.5 * LR, rtol=0, err_msg=name
        )


# -- the converter's online trees ---------------------------------------------------------


def _tree_batch(layout):
    rs = np.random.RandomState(2)
    if layout == "state_based":
        obs = lambda: rs.randn(B, 9).astype(np.float32)  # noqa: E731
    elif layout == "vector":
        obs = lambda: {part: {k: rs.randn(B, d).astype(np.float32) for k, d in VECTOR_DIMS.items()}  # noqa: E731
                       for part in ("observation", "goal")}
    else:
        obs = lambda: {part: {"rgb_static": rs.randint(0, 256, (B, HW, HW, 3), dtype=np.uint8)}  # noqa: E731
                       for part in ("observation", "goal")}
    return {"observations": obs(), "actions": rs.uniform(-1, 1, (B, 7)).astype(np.float32),
            "next_observations": obs(), "rewards": np.zeros(B, np.float32), "terminals": np.zeros(B, np.float32)}


@pytest.mark.parametrize("family", ["sac", "cql_online"])
@pytest.mark.parametrize("layout", ["visual", "vector", "state_based"])
def test_the_converter_carries_every_online_tree(family, layout):
    """JAX SAC / CQL-online params, with log_alpha_prime exactly under
    Lagrange, load strictly into the port's net over the visual, vector and
    state_based encoders, and the deterministic policies agree (atol 1e-5)."""
    if layout == "state_based":
        cfg = {"state_based": True, "state_dim": 6, "goal_dim": 3, "action_dim": 7,
               "policy": {"num_layers": 2, "hidden_dim": 16, "discrete_gripper": True},
               "q_network": {"num_layers": 2, "hidden_dim": 16}}
        if family == "cql_online":
            cfg["with_lagrange"] = True
    else:
        cfg = _cfg(layout, family)
        cfg.pop("env")
    jcls, pcls = MODULES[family]
    batch = _tree_batch(layout)
    jmod = jcls(cfg)
    jstate = jmod.init_state(jax.random.key(3), batch)
    sd = cql_state_dict_from_jax(np_tree(jstate.params), np_tree(jstate.aux),
                                 ("rgb_static",) if layout == "visual" else ())
    assert ("log_alpha_prime" in sd) == (family == "cql_online")
    pmod = pcls(cfg, device="cpu")
    state = pmod.init_state(0)
    state.net.load_state_dict(sd)  # strict: the same keys and shapes
    want = np.asarray(jmod.make_policy_fn()(jstate.params, batch["observations"], jax.random.key(0)))
    with torch.no_grad():
        got = pmod.make_policy_fn()(state.net, batch["observations"]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


# -- the rest of the module's surface ------------------------------------------------------


def test_get_action_strategies():
    mod = SACModule(vector_cfg(), device="cpu")
    state = mod.init_state(0)
    obs = mod.env.reset()
    a = mod.get_action(state.net, obs, "deterministic")
    b = mod.get_action(state.net, obs, "deterministic")
    np.testing.assert_array_equal(a, b)
    assert a.shape == (7,) and a.dtype == np.float32 and a[-1] in (-1.0, 1.0)
    s = mod.get_action(state.net, obs, "stochastic")
    assert s.shape == (7,) and np.all(np.abs(s) <= 1.0)
    np.testing.assert_array_equal(mod.get_action(None, obs, "zeros"), np.zeros(7, np.float32))
    with pytest.raises(ValueError, match="unknown strategy"):
        mod.get_action(state.net, obs, "greedy")


def test_play_step_counts_episodes():
    """The counters the rollout callback's episode cadence reads."""
    mod = SACModule(vector_cfg(), device="cpu")
    outs = [mod.play_step(None, "random") for _ in range(12)]
    ends = [i for i, o in enumerate(outs) if o["done"]]
    assert ends and mod.episode_number == len(ends) and len(mod.accuracies) == len(ends)
    assert mod.episode_done == outs[-1]["done"]
    assert list(mod.episodes_lengths) == list(np.diff([-1] + ends))
    assert all("episode_return" in outs[i] and "success" in outs[i] for i in ends)
    assert len(mod.replay_buffer) == 12
