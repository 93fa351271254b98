"""One whole TACO-RL (stage 2) train step of the PyTorch port held against
the JAX package at a tiny config: a tiny JAX Play-LMP checkpoint
(as tests/test_tacorl.py makes one), converted and saved as a port
checkpoint; both TACO-RL modules graft from their own; the same initial
params (carried across by tacorl_tpu_torch/utils/convert.py), batch and
JAX-drawn randomness (the window's and the goal's DrQ shifts and jitter
factors, the posterior's eps, the CQL draws). The posterior keeps its
default dropout, so the port must run it in eval mode to agree.

The JAX step runs its Pallas jitter tail in interpret mode."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacorl_tpu.core.checkpoint import CheckpointManager as JaxCheckpointManager
from tacorl_tpu.modules.play_lmp import PlayLMPModule as JaxPlayLMPModule
from tacorl_tpu.modules.tacorl import TACORLModule as JaxTACORLModule
from tacorl_tpu.ops import pallas_aug
from tacorl_tpu_torch.core.checkpoint import CheckpointManager
from tacorl_tpu_torch.modules.play_lmp import PlayLMPModule
from tacorl_tpu_torch.modules.tacorl import TACORLModule
from tacorl_tpu_torch.utils.convert import play_lmp_state_dict_from_jax, tacorl_state_dict_from_jax
from tests.test_torch_cql import (
    METRICS as CQL_METRICS,
    assert_params_agree,
    aug_draws,
    cql_draws,
    leaf_key,
    np_tree,
)

B, T, RAW, SIZE, PAD, N_ACT, LR, LATENT = 3, 5, 56, 48, 2, 3, 1e-3, 16


def _lmp_cfg():
    """tests/test_torch_play_lmp.py's config (float32 convolutions) with the
    posterior's default dropout."""
    return {
        "_target_": "tacorl_tpu.modules.play_lmp.PlayLMPModule",
        "lr": 1e-4,
        "kl_beta": 1e-3,
        "latent_plan_dim": LATENT,
        "plan_proposal_obs_modalities": ["rgb_static"],
        "plan_proposal_goal_modalities": ["rgb_static"],
        "plan_recognition_modalities": ["rgb_static"],
        "action_decoder_modalities": ["rgb_static"],
        "perceptual_encoder": {
            "networks": {
                "rgb_static": {
                    "_target_": "tacorl_tpu.networks.encoders.LMPVisionEncoder",
                    "latent_dim": 16, "hidden_dim": 32, "compute_dtype": None,
                }
            }
        },
        "goal_encoder": {"hidden_size": 32},
        "plan_recognition": {
            "num_heads": 4, "num_layers": 1, "encoder_hidden_size": 32,
            "fc_hidden_size": 32, "max_position_embeddings": 8,
        },
        "plan_proposal": {"policy": {"num_layers": 2, "hidden_dim": 32}},
        "action_decoder": {"hidden_size": 32, "num_layers": 1, "n_mixtures": 4},
        "transforms": {"rgb_static": {"kind": "rgb", "size": [SIZE, SIZE], "pad": PAD}},
    }


def _tacorl_cfg(lmp_dir):
    """tests/test_tacorl.py's config."""
    return {
        "_target_": "tacorl_tpu.modules.tacorl.TACORLModule",
        "play_lmp_dir": str(lmp_dir),
        "finetune_action_decoder": True,
        "action_decoder_lr": LR,
        "actor_lr": LR,
        "critic_lr": LR,
        "discount": 0.95,
        "with_lagrange": True,
        "reward_scale": 10.0,
        "n_action_samples": N_ACT,
        "deterministic_backup": True,
        "target_entropy": -7.0,
        "q_network": {"num_layers": 2, "hidden_dim": 16},
        "transforms": {
            "rgb_static": {"kind": "rgb", "size": [SIZE, SIZE], "pad": PAD, "use_pallas": True}
        },
    }


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    return {
        "states": {"rgb_static": rs.randint(0, 256, (B, T, RAW, RAW, 3), dtype=np.uint8)},
        "goal": {"rgb_static": rs.randint(0, 256, (B, RAW, RAW, 3), dtype=np.uint8)},
        "actions": np.clip(rs.randn(B, T, 7), -1, 1).astype(np.float32),
        "disp": np.asarray([1, 2, -1]),
    }


@pytest.fixture(scope="module")
def lmp_dirs(tmp_path_factory):
    """A tiny JAX Play-LMP checkpoint, and the same weights as a port
    checkpoint."""
    cfg = _lmp_cfg()
    jmod = JaxPlayLMPModule(dict(cfg))
    # the init traced once: flax's eager init of the whole net is slow
    jstate = jax.jit(jmod.init_state)(
        jax.random.key(2), {"states": _batch()["states"], "actions": _batch()["actions"]}
    )
    jax_dir = tmp_path_factory.mktemp("jax_lmp")
    JaxCheckpointManager(jax_dir, config={"module": dict(cfg)}).save(int(jstate.step), jstate)

    port_dir = tmp_path_factory.mktemp("port_lmp")
    pmod = PlayLMPModule(dict(cfg), device="cpu")
    pstate = pmod.init_state(0)
    pmod.net.load_state_dict(play_lmp_state_dict_from_jax(np_tree(jstate.params)))
    CheckpointManager(port_dir, config={"module": cfg}).save(0, pstate)
    return jax_dir, port_dir


@pytest.fixture(scope="module")
def step_pair(lmp_dirs):
    jax_dir, port_dir = lmp_dirs
    batch = _batch()
    tail = pallas_aug.pallas_augment_tail
    pallas_aug.pallas_augment_tail = functools.partial(tail, interpret=True)
    try:
        jmod = JaxTACORLModule(_tacorl_cfg(jax_dir))
        jstate = jmod.init_state(jax.random.key(1), batch)
        params0, aux0 = np_tree(jstate.params), np_tree(jstate.aux)
        rng = jax.random.key(0)
        jstate1, jmetrics = jmod.make_train_step()(
            jstate, batch, rng, {"bc_phase": jnp.asarray(0.0)}
        )
    finally:
        pallas_aug.pallas_augment_tail = tail

    # the draws JAX's TACO-RL step makes at step 0
    k_aug, k_plan, k_cql = jax.random.split(jax.random.fold_in(rng, 0), 3)
    draws = cql_draws(k_cql, B, N_ACT, LATENT, discrete_gripper=False)
    draws["aug_states"] = {"rgb_static": aug_draws(leaf_key(k_aug, "rgb_static"), B * T)}
    draws["aug_goal"] = {
        "rgb_static": aug_draws(leaf_key(jax.random.fold_in(k_aug, 1), "rgb_static"), B)
    }
    draws["plan_eps"] = torch.from_numpy(np.array(jax.random.normal(k_plan, (B, LATENT))))

    pmod = TACORLModule(_tacorl_cfg(port_dir), device="cpu")
    pstate = pmod.init_state(0)
    grafted = {k: v.clone() for k, v in pmod.net.state_dict().items()}
    pmod.net.load_state_dict(tacorl_state_dict_from_jax(params0, aux0))
    before = {k: v.clone() for k, v in pmod.net.state_dict().items()}
    pstate, pmetrics = pmod.make_train_step()(pstate, batch, {"bc_phase": 0.0}, draws=draws)
    return {
        "jax_metrics": {k: float(v) for k, v in jmetrics.items()},
        "jax_params0": tacorl_state_dict_from_jax(params0, aux0),
        "jax_params1": tacorl_state_dict_from_jax(np_tree(jstate1.params), np_tree(jstate1.aux)),
        "port_metrics": {k: float(v) for k, v in pmetrics.items()},
        "port_module": pmod,
        "port_state": pstate,
        "port_grafted": grafted,
        "port_before": before,
    }


METRICS = CQL_METRICS + ["action_loss", "rl_batch_success_rate"]
FROZEN = ("perceptual_encoder", "plan_recognition", "goal_encoder")


def test_the_port_reports_the_jax_metrics(step_pair):
    assert set(step_pair["port_metrics"]) == set(step_pair["jax_metrics"]) == set(METRICS)
    assert step_pair["port_metrics"]["rl_batch_success_rate"] == pytest.approx(1 / 3)


@pytest.mark.parametrize("name", METRICS)
def test_train_step_metric_matches_jax(step_pair, name):
    np.testing.assert_allclose(
        step_pair["port_metrics"][name], step_pair["jax_metrics"][name], rtol=1e-5, atol=1e-7
    )


def test_port_grafts_what_jax_grafts(step_pair):
    """init_state alone (before the JAX weights are loaded) already holds
    the LMP checkpoint in the actor, the frozen parts and the decoder."""
    grafted, jax0 = step_pair["port_grafted"], step_pair["jax_params0"]
    lmp_keys = [k for k in jax0 if k.split(".")[0] in FROZEN + ("action_decoder", "actor")]
    assert lmp_keys
    for k in lmp_keys:
        np.testing.assert_allclose(grafted[k].numpy(), jax0[k].numpy(), atol=0, rtol=0, err_msg=k)


@pytest.mark.parametrize(
    "group",
    ["actor", "q1", "q2", "target_q1", "target_q2", "log_alpha", "log_alpha_prime",
     "action_decoder"],
)
def test_post_step_params_match_jax(step_pair, group):
    state = step_pair["port_state"]
    assert state.step == 1
    sd = state.net.state_dict()
    expected = {k: v for k, v in step_pair["jax_params1"].items() if k.split(".")[0] == group}
    assert expected
    for name, want in expected.items():
        np.testing.assert_allclose(sd[name].numpy(), want.numpy(), atol=2.5 * LR, rtol=0, err_msg=name)


def test_post_step_params_agree_far_below_the_step(step_pair):
    assert_params_agree(step_pair["port_state"].net.state_dict(), step_pair["jax_params1"], LR)


@pytest.mark.parametrize("part", FROZEN)
def test_frozen_parts_are_bit_unchanged(step_pair, part):
    net = step_pair["port_state"].net
    assert not any(p.requires_grad for p in getattr(net, part).parameters())
    assert part not in step_pair["port_state"].optimizer.groups
    after = net.state_dict()
    keys = [k for k in after if k.split(".")[0] == part]
    assert keys and all(torch.equal(after[k], step_pair["port_before"][k]) for k in keys)


def test_decoder_is_finetuned(step_pair):
    after = step_pair["port_state"].net.state_dict()
    before = step_pair["port_before"]
    moved = [k for k in before if k.startswith("action_decoder.") and not torch.equal(before[k], after[k])]
    # every trained decoder weight moved; the frozen zero recurrent bias did not
    assert moved and all("bias_hh" not in k for k in moved)


def test_decoder_finetunes_without_dropout(tmp_path):
    """The decoder's RNN takes its backward in train mode (cuDNN's only
    mode for it) with its dropout held at 0, as JAX applies the decoder
    with train=False: a 2-layer decoder with dropout 0.5 gives the same
    step as with dropout 0 (same seeds, so the same weights and draws), and
    gets its dropout and eval mode back."""
    results = {}
    for p in (0.0, 0.5):
        cfg = _lmp_cfg()
        cfg["action_decoder"] = dict(cfg["action_decoder"], num_layers=2, policy_rnn_dropout_p=p)
        lmp = PlayLMPModule(cfg, device="cpu")
        CheckpointManager(tmp_path / str(p), config={"module": cfg}).save(0, lmp.init_state(0))
        module = TACORLModule(_tacorl_cfg(tmp_path / str(p)), device="cpu")
        state = module.init_state(0)
        _, metrics = module.make_train_step()(state, _batch(), {"bc_phase": 0.0})
        rnn = module.net.action_decoder.rnn
        assert rnn.dropout == p and not rnn.training
        results[p] = {k: float(v) for k, v in metrics.items()}
    assert results[0.5] == results[0.0]


def test_chip_smoke_stage2_config_is_the_repo_config():
    """chip_smoke.py carries configs/module/tacorl.yaml (with its Q network
    and the rgb_static transform) as a dict: the chip machine has no YAML
    reader. The copy must stay the file."""
    import yaml
    from pathlib import Path

    import chip_smoke

    configs = Path(__file__).resolve().parent.parent / "configs"
    want = yaml.safe_load((configs / "module" / "tacorl.yaml").read_text())
    for key in ("defaults", "play_lmp_dir", "transforms"):
        want.pop(key)
    want["q_network"] = yaml.safe_load((configs / "networks" / "q_network" / "mlp.yaml").read_text())
    want["transforms"] = {
        "rgb_static": yaml.safe_load((configs / "transforms" / "rl.yaml").read_text())["rgb_static"]
    }
    assert chip_smoke.TACORL_CFG == want


def test_checkpoint_round_trip(step_pair, tmp_path):
    module, state = step_pair["port_module"], step_pair["port_state"]
    cfg = _tacorl_cfg("unused")
    manager = CheckpointManager(tmp_path, config={"module": cfg})
    manager.save(1, state)
    manager.save(3, state)
    assert manager.all_steps() == [1, 3] and manager.latest_step() == 3
    assert CheckpointManager(tmp_path).load_config() == {"module": cfg}
    restored = module.restore_state(manager, step=1)
    assert restored.step == 1
    saved = manager.restore(3)
    assert saved["step"] == 1  # the state's step, saved under the name 3
    for k, v in state.net.state_dict().items():
        assert torch.equal(saved["net"][k], v), k
        assert torch.equal(restored.net.state_dict()[k], v), k
    assert set(saved["optimizer"]) == set(state.optimizer.groups)
