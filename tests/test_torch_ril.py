"""Relay Imitation Learning of the port held against the JAX package on the
CPU, at tiny widths:

  * RILDataset items and BasicDataModule batches over 2 epochs, bit-equal,
    in both storage layouts;
  * one RILModule train step and one validation step, from the same
    converted weights and with JAX's per-leaf augmentation draws
    (``fold_in(key, stable_fold(leaf))``): a visual config (the Pallas tail
    in interpret mode) and the ``ril_fake_state`` vector layout with a
    discrete-gripper low level. Metrics rtol 1e-5, gradients atol 1e-5 +
    rtol 1e-4 (a misplaced stop-gradient shows in the goal encoder's),
    post-Adam params atol 2.5 lr;
  * the log-density both levels share, at targets near +-1;
  * ``ril_state_dict_from_jax`` loading strictly into the reference layout
    (tests/torch_ref.py:TRIL) and into the port's RILNet;
  * RILAgent and OracleSubgoalAgent on the JAX rollout's own observations
    (atol 1e-5), whole episodes, and the live env left as it was;
  * ``python -m tacorl_tpu_torch.evaluate_ril_oracle`` writing the JSON
    scripts/evaluate_ril_oracle.py writes, oracle and learned high level."""

import copy
import functools
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from scripts.evaluate_ril_oracle import main as jax_evaluate_ril_oracle
from tacorl_tpu.core.checkpoint import CheckpointManager as JaxCheckpointManager
from tacorl_tpu.data import datamodule as jax_datamodule
from tacorl_tpu.data import ril_dataset as jax_ril_dataset
from tacorl_tpu.data import storage as jax_storage
from tacorl_tpu.envs.fake_calvin import FakeCalvinEnv as JaxFakeCalvinEnv
from tacorl_tpu.evaluation import agents as jax_agents
from tacorl_tpu.evaluation import rollout_manager as jax_rm
from tacorl_tpu.modules.ril import RILModule as JaxRILModule
from tacorl_tpu.networks.actor import Actor as JaxActor, MLPPolicy as JaxMLPPolicy
from tacorl_tpu.ops import pallas_aug
from tacorl_tpu_torch.core.checkpoint import CheckpointManager
from tacorl_tpu_torch.data import datamodule, ril_dataset
from tacorl_tpu_torch.data.expert_play import generate_expert_play
from tacorl_tpu_torch.envs.fake_calvin import FakeCalvinEnv
from tacorl_tpu_torch.evaluation import agents, rollout_manager as rm
from tacorl_tpu_torch.modules.ril import LEAVES, RILModule, RILNet
from tacorl_tpu_torch.networks.actor import Actor, MLPPolicy
from tacorl_tpu_torch.utils.convert import mlp_policy_state_dict, ril_state_dict_from_jax
from tests.test_torch_cql import aug_draws, leaf_key, np_tree
from tests.test_torch_envs import assert_same
from tests.torch_ref import TRIL

REPO = Path(__file__).resolve().parent.parent
B, HW, PAD, LR = 3, 48, 2, 1e-3
VECTOR_DIMS = {"robot_obs": 15, "scene_obs": 24}
ENC = {"networks": {"rgb_static": {
    "_target_": "tacorl_tpu.networks.encoders.LMPVisionEncoder",
    "latent_dim": 8, "hidden_dim": 16, "compute_dtype": None,
}}}


def visual_cfg():
    return {
        "_target_": "tacorl_tpu.modules.ril.RILModule",
        "lr": LR, "action_dim": 7,
        "high_level_policy_modalities": ["rgb_static"],
        "low_level_policy_modalities": ["rgb_static"],
        "perceptual_encoder": ENC,
        "goal_encoder": {"out_features": 8, "hidden_size": 16, "last_layer_activation": "Tanh"},
        "high_level_policy": {"num_layers": 2, "hidden_dim": 16},
        "low_level_policy": {"num_layers": 2, "hidden_dim": 16},
        "transforms": {"rgb_static": {"kind": "rgb", "size": [HW, HW], "pad": PAD, "use_pallas": True}},
    }


def vector_cfg():
    """``experiment=ril_fake_state``'s layout at tiny widths."""
    cfg = visual_cfg()
    mods = list(VECTOR_DIMS)
    cfg.update(
        high_level_policy_modalities=mods, low_level_policy_modalities=mods,
        vector_dims=dict(VECTOR_DIMS),
        low_level_policy={"num_layers": 2, "hidden_dim": 16, "discrete_gripper": True},
        transforms={m: {"kind": "vector"} for m in mods},
    )
    return cfg


def _actions(rs, discrete_gripper):
    a = np.clip(rs.randn(B, 7), -1, 1).astype(np.float32)
    if discrete_gripper:
        a[:, -1] = np.where(a[:, -1] >= 0, 1.0, -1.0)
    return a


def visual_batch(seed=0):
    rs = np.random.RandomState(seed)
    batch = {k: {"rgb_static": rs.randint(0, 256, (B, HW, HW, 3), dtype=np.uint8)} for k in LEAVES}
    batch["low_level_action"] = _actions(rs, False)
    return batch


def vector_batch(seed=0):
    rs = np.random.RandomState(seed)
    batch = {k: {m: rs.randn(B, d).astype(np.float32) for m, d in VECTOR_DIMS.items()} for k in LEAVES}
    batch["low_level_action"] = _actions(rs, True)
    return batch


def jax_init(cfg, batch, seed):
    """The JAX module and its initial state (the init traced once: faster
    than flax's eager init)."""
    jmod = JaxRILModule(cfg)
    return jmod, jax.jit(jmod.init_state)(jax.random.key(seed), batch)


# case -> (config, batch, image modalities)
CASES = {"visual": (visual_cfg, visual_batch, ("rgb_static",)),
         "vector": (vector_cfg, vector_batch, ())}


# -- the dataset -------------------------------------------------------------------------

MODALITIES = ["rgb_static", "robot_obs", "scene_obs", "rel_actions_world"]


@pytest.fixture(scope="module")
def play(tmp_path_factory):
    """Expert play as frame dirs, and the same set packed."""
    root = tmp_path_factory.mktemp("play")
    generate_expert_play(root / "frames", n_train_episodes=3, n_val_episodes=2,
                         tasks_per_episode=2, image_hw=32, seed=5)
    for split in ("training", "validation"):
        jax_storage.pack_frames(root / "frames" / split, root / "packed" / split)
    return root


WINDOWS = dict(max_low_level_window=5, max_high_level_window=20)


@pytest.mark.parametrize("layout", ["frames", "packed"])
def test_dataset_items_match_jax(play, layout):
    split = play / layout / "training"
    port = ril_dataset.RILDataset(split, MODALITIES, **WINDOWS)
    ref = jax_ril_dataset.RILDataset(split, MODALITIES, **WINDOWS)
    assert len(port) == len(ref) > 50
    np.testing.assert_array_equal(port.episode_lookup, ref.episode_lookup)
    # every step, the episodes' last steps included (empty goal ranges)
    for idx in range(len(port)):
        got = port.sample(idx, np.random.default_rng((4, idx)))
        want = ref.sample(idx, np.random.default_rng((4, idx)))
        assert_same(got, want)
    item = port.sample(0, np.random.default_rng(0))
    assert set(item) == set(LEAVES) | {"low_level_action"}
    assert "rel_actions_world" not in item["obs"] and item["low_level_action"].shape == (7,)


def test_an_empty_goal_range_takes_its_end_without_a_draw():
    rng = np.random.default_rng(0)
    assert ril_dataset.RILDataset._sample_goal_step(rng, 7, 7) == 7
    assert ril_dataset.RILDataset._sample_goal_step(rng, 9, 4) == 4
    assert rng.integers(0, 1 << 30) == np.random.default_rng(0).integers(0, 1 << 30)


def test_action_type_must_be_a_modality(play):
    with pytest.raises(ValueError, match="rel_actions_world"):
        ril_dataset.RILDataset(play / "frames" / "training", ["robot_obs"])


@pytest.mark.parametrize("layout", ["frames", "packed"])
def test_datamodule_batches_match_jax_over_two_epochs(play, layout):
    kw = dict(
        data_dir=str(play / layout), batch_size=8, seed=3, val_percentage=1.0,
        dataset={"_target_": "tacorl_tpu.data.ril_dataset.RILDataset", "modalities": MODALITIES,
                 "action_type": "rel_actions_world", **WINDOWS},
    )
    port, ref = datamodule.BasicDataModule(**kw), jax_datamodule.BasicDataModule(**kw)
    port.setup()
    ref.setup()
    assert type(port.train_dataset).__module__ == "tacorl_tpu_torch.data.ril_dataset"
    for name in ("train_loader", "val_loader"):
        p_dl, r_dl = getattr(port, name)(), getattr(ref, name)()
        got = [list(p_dl) for _ in range(2)]
        want = [list(r_dl) for _ in range(2)]
        assert len(got[0]) == len(want[0]) > 0
        assert_same(got, want)
    assert got[0][0]["high_level_action"]["rgb_static"].shape == (8, 32, 32, 3)


# -- the train and validation steps ----------------------------------------------------


@pytest.fixture(scope="module", params=list(CASES))
def step_pair(request):
    cfg_fn, batch_fn, mods = CASES[request.param]
    batch = batch_fn()
    tail = pallas_aug.pallas_augment_tail
    pallas_aug.pallas_augment_tail = functools.partial(tail, interpret=True)
    try:
        jmod, jstate = jax_init(cfg_fn(), batch, 1)
        params0 = np_tree(jstate.params)
        jval, _ = jmod.make_val_step()(jstate, batch, jax.random.key(7), {})
        # the step's gradients, read out of its own optimizer update
        recorded = {}
        adam = jmod.optimizer

        def update(grads, opt_state, params=None):
            jax.debug.callback(lambda g: recorded.__setitem__("grads", np_tree(g)), grads)
            return adam.update(grads, opt_state, params)

        jmod.optimizer = optax.GradientTransformation(adam.init, update)
        rng = jax.random.key(0)
        k_step = jax.random.fold_in(rng, 0)  # the train step's fold-in of step 0
        jstate1, jmetrics = jmod.make_train_step()(jstate, batch, rng, {})
        jparams1 = np_tree(jstate1.params)
        jgrads = recorded["grads"]
    finally:
        pallas_aug.pallas_augment_tail = tail

    pmod = RILModule(cfg_fn(), device="cpu")
    pstate = pmod.init_state(0)
    pmod.net.load_state_dict(ril_state_dict_from_jax(params0, mods))
    pval, pout = pmod.make_val_step()(pstate, batch)
    draws = {leaf: {m: aug_draws(leaf_key(k_step, leaf, m), B, PAD) for m in mods} for leaf in LEAVES}
    pstate, pmetrics = pmod.make_train_step()(pstate, batch, draws=draws)
    return {
        "case": request.param,
        "mods": mods,
        "jax_metrics": {k: float(v) for k, v in jmetrics.items()},
        "port_metrics": {k: float(v) for k, v in pmetrics.items()},
        "jax_val": {k: float(v) for k, v in jval.items()},
        "port_val": {k: float(v) for k, v in pval.items()},
        "port_val_outputs": pout,
        "jax_grads": ril_state_dict_from_jax(jgrads, mods),
        "port_grads": {n: p.grad.clone() for n, p in pstate.net.named_parameters()},
        "jax_params1": ril_state_dict_from_jax(jparams1, mods),
        "port_state": pstate,
    }


METRICS = ["low_level_loss", "high_level_loss", "total_loss"]


@pytest.mark.parametrize("split", ["train", "val"])
def test_step_metrics_match_jax(step_pair, split):
    got = step_pair["port_metrics" if split == "train" else "port_val"]
    want = step_pair["jax_metrics" if split == "train" else "jax_val"]
    assert set(got) == set(want) == set(METRICS)
    for name in METRICS:
        # rtol 1e-5: float32 sums taken in another order
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5, atol=1e-6, err_msg=name)
    assert step_pair["port_val_outputs"] == {}


def test_grads_match_jax(step_pair):
    got, want = step_pair["port_grads"], step_pair["jax_grads"]
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), atol=1e-5, rtol=1e-4, err_msg=name)
    # the goal encoder learns from both goals; only the subgoal target is
    # held (a misplaced detach zeroes or inflates these)
    assert all(float(got[k].abs().max()) > 0 for k in got if k.startswith("goal_encoder."))


def test_post_step_params_match_jax(step_pair):
    state = step_pair["port_state"]
    assert state.step == 1
    sd = state.net.state_dict()
    assert set(sd) == set(step_pair["jax_params1"])
    for name, want in step_pair["jax_params1"].items():
        # Adam's first step moves each weight by about +-lr
        np.testing.assert_allclose(sd[name].numpy(), want.numpy(), atol=2.5 * LR, rtol=0, err_msg=name)


def test_parity_holds_over_five_adam_steps():
    """The vector case stepped five times in both packages on one batch:
    the metrics of every step at rtol 1e-5, the params at atol 2.5 lr a
    step."""
    batch = vector_batch(2)
    jmod, jstate = jax_init(vector_cfg(), batch, 4)
    pmod = RILModule(vector_cfg(), device="cpu")
    pstate = pmod.init_state(0)
    pmod.net.load_state_dict(ril_state_dict_from_jax(np_tree(jstate.params), ()))
    jstep, pstep = jmod.make_train_step(), pmod.make_train_step()
    for i in range(5):
        jstate, jm = jstep(jstate, batch, jax.random.key(0), {})
        pstate, pm = pstep(pstate, batch)
        for name in METRICS:
            np.testing.assert_allclose(float(pm[name]), float(jm[name]), rtol=1e-5, err_msg=f"{name} at step {i}")
    sd = pstate.net.state_dict()
    for name, want in ril_state_dict_from_jax(np_tree(jstate.params), ()).items():
        np.testing.assert_allclose(sd[name].numpy(), want.numpy(), atol=5 * 2.5 * LR, rtol=0, err_msg=name)


def test_the_subgoal_target_takes_no_gradient():
    """Only the high level's target embedding is stop-gradient: the goal
    encoder's gradient of the high-level loss is the one taken with the
    target as a constant, and differs from the one taken through it."""
    pmod = RILModule(vector_cfg(), device="cpu")
    net = pmod.init_state(0).net
    t = pmod._transform_batch(vector_batch(), False, None)
    params = list(net.goal_encoder.parameters())
    mods = net.hl_modalities

    def hl_loss(detach):
        target = net.goal_encoder(net._emb(t["high_level_action"], mods))
        x = torch.cat([net._emb(t["obs"], mods), net.goal_encoder(net._emb(t["high_level_goal"], mods))], -1)
        return -net.high_level_policy.log_prob(x, target.detach() if detach else target).mean()

    got = torch.autograd.grad(net.compute_loss(t)[1]["high_level_loss"], params)
    held = torch.autograd.grad(hl_loss(True), params)
    live = torch.autograd.grad(hl_loss(False), params)
    for g, h in zip(got, held):
        torch.testing.assert_close(g, h, rtol=0, atol=0)
    assert any(not torch.allclose(g, h) for g, h in zip(got, live))


@pytest.mark.parametrize("target", [0.9995, -0.99999, 0.999, 1.0, -1.0, 0.3])
def test_log_prob_near_the_tanh_boundary_matches_jax(target):
    """The high level regresses Tanh embeddings near +-1: TanhNormal's
    log-density clips them to +-0.999 in both packages."""
    rs = np.random.RandomState(2)
    x = rs.randn(4, 6).astype(np.float32)
    actions = np.full((4, 5), target, np.float32)
    actions[1] = rs.uniform(-1, 1, 5)
    jactor = JaxActor(policy=JaxMLPPolicy(action_dim=5, num_layers=2, hidden_dim=8), action_dim=5)
    params = jactor.init(jax.random.key(0), x)["params"]
    want = np.asarray(jactor.apply({"params": params}, x, actions, method="log_prob"))
    port = Actor(MLPPolicy(action_dim=5, input_dim=6, num_layers=2, hidden_dim=8), action_dim=5)
    port.policy.load_state_dict(mlp_policy_state_dict(np_tree(params["policy"])))
    got = port.log_prob(torch.from_numpy(x), torch.from_numpy(actions)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# -- the converter -------------------------------------------------------------------------


def test_converted_weights_load_strictly_into_the_reference_layout():
    _, jstate = jax_init(visual_cfg(), visual_batch(), 3)
    sd = ril_state_dict_from_jax(np_tree(jstate.params))
    TRIL().load_state_dict(sd, strict=True)
    net = RILModule(visual_cfg(), device="cpu").net
    net.load_state_dict(sd, strict=True)
    assert isinstance(net, RILNet)
    assert {k.split(".")[0] for k in sd} == {
        "perceptual_encoder", "goal_encoder", "high_level_policy", "low_level_policy"}


def test_a_vector_net_has_no_encoder_keys():
    _, jstate = jax_init(vector_cfg(), vector_batch(), 3)
    sd = ril_state_dict_from_jax(np_tree(jstate.params), ())
    assert not any(k.startswith("perceptual_encoder.") for k in sd)
    assert "low_level_policy.policy.gripper_action.weight" in sd
    RILModule(vector_cfg(), device="cpu").net.load_state_dict(sd, strict=True)


# -- agents ----------------------------------------------------------------------------------

ENV_KW = dict(image_hw=32, task_set="hard", modalities=list(VECTOR_DIMS),
              goal_modalities=list(VECTOR_DIMS), seed=0)
RESETS = ({"task_info": {"task": "open_drawer", "index": 0}},
          {"task_info": {"task": "lift_block", "index": 2}})


@pytest.fixture(scope="module")
def ril_pair():
    """The tiny vector RIL in both packages, the same weights."""
    jmod, jstate = jax_init(vector_cfg(), vector_batch(), 5)
    pmod = RILModule(vector_cfg(), device="cpu")
    pstate = pmod.init_state(0)
    pmod.net.load_state_dict(ril_state_dict_from_jax(np_tree(jstate.params), ()))
    return jmod, jstate, pmod, pstate


def _agents(ril_pair, kind, jenv, penv):
    jmod, jstate, pmod, pstate = ril_pair
    if kind == "learned":
        return jax_agents.RILAgent(jmod, jstate), agents.RILAgent(pmod, pstate)
    return (jax_agents.OracleSubgoalAgent(jmod, jstate, jenv, lookahead=5),
            agents.OracleSubgoalAgent(pmod, pstate, penv, lookahead=5))


def test_make_agent_picks_the_ril_agent_and_manager(ril_pair):
    jmod, jstate, pmod, pstate = ril_pair
    agent, manager_cls = agents.make_agent(pmod, pstate)
    jagent, jmanager_cls = jax_agents.make_agent(jmod, jstate)
    assert type(agent) is agents.RILAgent and manager_cls is rm.RILRollout
    assert type(jagent).__name__ == "RILAgent" and jmanager_cls.__name__ == manager_cls.__name__


class _Recorder:
    """Wraps a JAX RIL agent and records each call and its output."""

    def __init__(self, agent):
        self.agent, self.calls = agent, []

    def reset(self):
        self.agent.reset()

    def propose_plan(self, obs, key):
        out = self.agent.propose_plan(obs, key)
        self.calls.append(("propose", copy.deepcopy(obs), np.array(out)))
        return out

    def decode_step(self, obs, plan, key):
        out = self.agent.decode_step(obs, plan, key)
        self.calls.append(("decode", copy.deepcopy(obs), np.array(out)))
        return out


def test_learned_agent_matches_jax_on_a_shared_observation_stream(ril_pair):
    jagent, pagent = _agents(ril_pair, "learned", None, None)
    recorder = _Recorder(jagent)
    manager = jax_rm.RILRollout(plan_duration=4)
    env = JaxFakeCalvinEnv(max_episode_steps=14, **ENV_KW)
    for reset in RESETS:
        manager.episode_rollout(recorder, env, reset)
    assert [c[0] for c in recorder.calls].count("propose") == 8
    plan = None
    for i, (kind, obs, want) in enumerate(recorder.calls):
        if kind == "propose":
            plan = pagent.propose_plan(obs)
            np.testing.assert_allclose(plan.numpy(), want, atol=1e-5, err_msg=f"subgoal at call {i}")
        else:
            got = pagent.decode_step(obs, plan)
            np.testing.assert_allclose(got[:-1], want[:-1], atol=1e-5, err_msg=f"call {i}")
            assert got[-1] == want[-1], f"gripper differs at call {i}"


@pytest.mark.parametrize("kind", ["learned", "oracle"])
def test_whole_episodes_match_jax(ril_pair, kind):
    """Two episodes through each package's RILRollout on its own env; the
    oracle rolls the scripted expert ahead on a copy of each."""
    jenv = JaxFakeCalvinEnv(max_episode_steps=18, **ENV_KW)
    penv = FakeCalvinEnv(max_episode_steps=18, **ENV_KW)
    jagent, pagent = _agents(ril_pair, kind, jenv, penv)
    jmanager, pmanager = jax_rm.RILRollout(plan_duration=4), rm.RILRollout(plan_duration=4)
    for reset in RESETS:
        want = jmanager.episode_rollout(jagent, jenv, reset)
        got = pmanager.episode_rollout(pagent, penv, reset)
        assert got == want
    np.testing.assert_allclose(penv.robot_obs, jenv.robot_obs, atol=1e-5)
    np.testing.assert_allclose(penv.scene_obs, jenv.scene_obs, atol=1e-5)


def test_oracle_subgoal_matches_jax_and_leaves_the_env_as_it_was(ril_pair):
    jenv = JaxFakeCalvinEnv(max_episode_steps=30, **ENV_KW)
    penv = FakeCalvinEnv(max_episode_steps=30, **ENV_KW)
    twin = FakeCalvinEnv(max_episode_steps=30, **ENV_KW)
    jagent, pagent = _agents(ril_pair, "oracle", jenv, penv)
    obs = [e.reset(**RESETS[0]) for e in (jenv, penv, twin)][1]
    for _ in range(3):
        action = penv.expert_action()
        obs = penv.step(action)[0]
        jenv.step(action)
        twin.step(action)
    rng_before = copy.deepcopy(penv._rng.get_state())
    subgoal = pagent.propose_plan(obs)
    np.testing.assert_allclose(subgoal.numpy(), np.asarray(jagent.propose_plan(obs, None)), atol=1e-5)
    assert subgoal.shape == (1, 8)
    # the copy ran the expert; the live env and its random state did not move
    assert_same(penv._rng.get_state(), rng_before)
    assert_same(penv.get_obs(), twin.get_obs())
    assert penv._steps == twin._steps == 3
    action = np.full(7, 0.3, np.float32)
    assert_same(penv.step(action)[0], twin.step(action)[0])


# -- the entry point ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ril_dirs(ril_pair, tmp_path_factory):
    """A tiny JAX RIL checkpoint, the same weights as a port checkpoint,
    and an expert-play validation set."""
    _, jstate, _, pstate = ril_pair
    cfg = vector_cfg()
    jax_dir = tmp_path_factory.mktemp("jax_ril")
    JaxCheckpointManager(jax_dir, config={"module": dict(cfg)}).save(int(jstate.step), jstate)
    port_dir = tmp_path_factory.mktemp("port_ril")
    CheckpointManager(port_dir, config={"module": cfg}).save(0, pstate)
    data = tmp_path_factory.mktemp("ril_eval_data")
    generate_expert_play(data, n_train_episodes=1, n_val_episodes=2, tasks_per_episode=3,
                         idle_steps=(3, 7), seed=11, distinct_tasks=True)
    return jax_dir, port_dir, data / "validation"


def _oracle_args(data_dir, out, learned):
    args = [
        f"data_dir={data_dir}", f"filename={out}", "min_seq_len=1", "max_seq_len=400",
        "max_rollouts=2", "plan_duration=3", "lookahead=4", "env.max_episode_steps=10",
        "env.task_set=hard", "env.modalities=[robot_obs,scene_obs]",
        "env.goal_modalities=[robot_obs,scene_obs]",
    ]
    return args + (["learned_hl=true"] if learned else [])


@pytest.mark.parametrize("learned", [False, True], ids=["oracle", "learned"])
def test_entry_point_writes_what_the_jax_script_writes(ril_dirs, tmp_path, learned):
    from tacorl_tpu_torch import evaluate_ril_oracle

    jax_dir, port_dir, data_dir = ril_dirs
    port_out, jax_out = tmp_path / "port.json", tmp_path / "jax.json"
    port_args = ["+device=cpu", f"module_path={port_dir}"] + _oracle_args(data_dir, port_out, learned)
    if learned:
        evaluate_ril_oracle.main(port_args)
    else:
        # the command a user runs
        proc = subprocess.run(
            [sys.executable, "-m", "tacorl_tpu_torch.evaluate_ril_oracle"] + port_args,
            cwd=REPO, capture_output=True, text=True, timeout=300,
        )
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert "(oracle high level)" in proc.stdout
    jax_evaluate_ril_oracle([f"module_path={jax_dir}"] + _oracle_args(data_dir, jax_out, learned))
    got, want = json.loads(port_out.read_text()), json.loads(jax_out.read_text())
    assert got == want
    assert got and all(row["num_rollouts"] > 0 for row in got.values())


def test_entry_point_refuses_another_module_family(ril_dirs, tmp_path):
    from tacorl_tpu_torch import evaluate_ril_oracle
    from tacorl_tpu_torch.modules.cql import CQLModule

    cfg = {"_target_": "tacorl_tpu.modules.cql.CQLModule", "state_based": True,
           "state_dim": 6, "goal_dim": 3}
    CheckpointManager(tmp_path, config={"module": cfg}).save(
        0, CQLModule(cfg, device="cpu").init_state(0))
    with pytest.raises(ValueError, match="not 'ril'"):
        evaluate_ril_oracle.main(["+device=cpu", f"module_path={tmp_path}"]
                                 + _oracle_args(ril_dirs[2], tmp_path / "x.json", False))


def test_evaluate_scores_a_ril_run(ril_dirs, tmp_path):
    """``python -m tacorl_tpu_torch.evaluate`` maps a RIL module to its
    agent and manager, as scripts/evaluate.py does."""
    from scripts.evaluate import main as jax_evaluate
    from tacorl_tpu_torch import evaluate

    jax_dir, port_dir, data_dir = ril_dirs
    common = [f"data_dir={data_dir}", "min_seq_len=1", "max_seq_len=400", "max_rollouts=2",
              "plan_duration=3", "env.max_episode_steps=8",
              "env.modalities=[robot_obs,scene_obs]", "env.goal_modalities=[robot_obs,scene_obs]"]
    got = evaluate.main(["+device=cpu", f"module_path={port_dir}", f"filename={tmp_path / 'p.json'}"] + common)
    want = jax_evaluate([f"module_path={jax_dir}", f"filename={tmp_path / 'j.json'}"] + common)
    assert got == want and got
