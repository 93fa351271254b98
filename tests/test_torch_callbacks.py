"""The port's training callbacks held against the JAX package's: the KL
schedules' beta per epoch, IncreaseHorizonLinear, and the rollout callbacks
(RolloutCallback with the all_tasks, env_tasks and plain strategies, its
epoch and batch cadences, skip_first_n_epochs and the batch cadence's
state_dict; RolloutLongHorizonCallback) driving a converted tiny visual CQL
module, whose deterministic FlatPolicyAgent draws nothing, against the JAX
callbacks on the fake env: the logged metric dicts must be equal."""

from types import SimpleNamespace

import jax
import pytest
import torch

from tacorl_tpu.callbacks import horizon as jax_horizon
from tacorl_tpu.callbacks import kl_schedule as jax_kl
from tacorl_tpu.callbacks import rollout as jax_rollout
from tacorl_tpu.envs.fake_calvin import FakeCalvinEnv as JaxFakeCalvinEnv
from tacorl_tpu.modules.cql import CQLModule as JaxCQLModule
from tacorl_tpu_torch import callbacks
from tacorl_tpu_torch.callbacks import horizon, horizon_uncertainty, kl_schedule, rollout
from tacorl_tpu_torch.config import get_class
from tacorl_tpu_torch.data.expert_play import generate_expert_play
from tacorl_tpu_torch.envs.fake_calvin import FakeCalvinEnv
from tacorl_tpu_torch.modules.cql import CQLModule
from tacorl_tpu_torch.utils.convert import cql_state_dict_from_jax
from tests.test_torch_cql import _batch as cql_batch, _cfg as cql_cfg, np_tree

# -- schedules ----------------------------------------------------------------------


class _Module:
    def __init__(self):
        self.kl_beta = None

    def set_kl_beta(self, beta):
        self.kl_beta = beta


@pytest.mark.parametrize("name", ["KLLinearSchedule", "KLSigmoidSchedule"])
@pytest.mark.parametrize("span", [(10, 50), (0, 3), (2, 8)])
def test_kl_schedule_betas_match_jax(name, span):
    port = getattr(kl_schedule, name)(*span, max_kl_beta=5e-3)
    ref = getattr(jax_kl, name)(*span, max_kl_beta=5e-3)
    for epoch in range(60):
        pm, jm = _Module(), _Module()
        port.on_epoch_start(None, pm, epoch)
        ref.on_epoch_start(None, jm, epoch)
        assert pm.kl_beta == jm.kl_beta, epoch
    assert pm.kl_beta == 5e-3


def test_kl_constant_schedule_leaves_beta():
    module = _Module()
    kl_schedule.KLConstantSchedule().on_epoch_start(None, module, 3)
    assert module.kl_beta is None


class _Sink:
    def __init__(self):
        self.logged = []

    def log(self, metrics, step, prefix=None):
        self.logged.append((dict(metrics), step, prefix))


class _HorizonDataset:
    def __init__(self, strategies):
        self.goal_strategy_prob = strategies
        self.current_horizon = 8
        self.calls = []

    def increase_horizon(self, epoch):
        self.calls.append(epoch)
        self.current_horizon += 4


@pytest.mark.parametrize("strategies", [{"increasing_horizon": 1.0}, {"geometric": 1.0}])
def test_increase_horizon_linear_matches_jax(strategies):
    runs = []
    for cls in (horizon.IncreaseHorizonLinear, jax_horizon.IncreaseHorizonLinear):
        ds = _HorizonDataset(dict(strategies))
        trainer = SimpleNamespace(datamodule=SimpleNamespace(train_dataset=ds), sink=_Sink(), global_step=0)
        cb = cls()
        for epoch in range(4):
            trainer.global_step = 10 * (epoch + 1)
            cb.on_epoch_end(trainer, None, epoch)
        runs.append((trainer.sink.logged, ds.calls, ds.current_horizon))
    assert runs[0] == runs[1]
    # a dataset without a horizon is left alone
    trainer = SimpleNamespace(datamodule=SimpleNamespace(train_dataset=object()), sink=_Sink())
    horizon.IncreaseHorizonLinear().on_epoch_end(trainer, None, 0)
    assert trainer.sink.logged == []


@pytest.mark.parametrize(
    "target",
    [
        "tacorl_tpu.callbacks.IncreaseHorizonUncertainty",
        "tacorl_tpu.callbacks.rollout.RolloutD4RLCallback",
        "tacorl_tpu.callbacks.tsne_plot.TSNEPlot",
        "tacorl_tpu.callbacks.tsne_plot.TSNEPlotCallback",
    ],
)
def test_callbacks_not_ported_name_the_roadmap(target):
    """A target the port lacks (``TSNEPlot``, a name the JAX package does
    not have either) fails naming ROADMAP; the uncertainty-gated horizon,
    the D4RL rollout callback and the t-SNE plot are ported now, and their
    targets resolve to the port's classes."""
    if target.endswith("TSNEPlotCallback"):
        assert get_class(target) is callbacks.TSNEPlotCallback
        return
    if target.endswith("IncreaseHorizonUncertainty"):
        assert get_class(target) is horizon_uncertainty.IncreaseHorizonUncertainty
        return
    if target.endswith("RolloutD4RLCallback"):
        assert get_class(target) is rollout.RolloutD4RLCallback is callbacks.RolloutD4RLCallback
        return
    with pytest.raises(ImportError, match="ROADMAP"):
        get_class(target)


def test_package_exports_what_is_ported():
    assert get_class("tacorl_tpu.callbacks.KLLinearSchedule") is kl_schedule.KLLinearSchedule
    assert get_class("tacorl_tpu.callbacks.rollout.RolloutCallback") is rollout.RolloutCallback
    assert callbacks.IncreaseHorizonLinear is horizon.IncreaseHorizonLinear


# -- rollout callbacks -------------------------------------------------------------------


@pytest.fixture(scope="module")
def cql_pair():
    """A tiny visual CQL module in both packages on the same weights."""
    jc = JaxCQLModule(cql_cfg())
    jcs = jc.init_state(jax.random.key(1), cql_batch())
    pc = CQLModule(cql_cfg(), device="cpu")
    pcs = pc.init_state(0)
    pc.net.load_state_dict(cql_state_dict_from_jax(np_tree(jcs.params), np_tree(jcs.aux)))
    return (jc, jcs), (pc, pcs)


@pytest.fixture(scope="module")
def play_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("play")
    generate_expert_play(root, n_train_episodes=0, n_val_episodes=3, tasks_per_episode=3,
                         idle_steps=(3, 7), seed=11, distinct_tasks=True)
    return root / "validation"


def _trainer(state, epoch=0):
    return SimpleNamespace(state=state, sink=_Sink(), _last_val_metrics={}, global_step=7, epoch=epoch)


def _pair(cls_name, play_data, steps=12, **kwargs):
    common = dict(data_dir=str(play_data), start_end_tasks=str(play_data / "start_end_tasks.json"),
                  min_seq_len=1, max_seq_len=400, **kwargs)
    port = getattr(rollout, cls_name)(
        env=FakeCalvinEnv(image_hw=64, max_episode_steps=steps, task_set="hard"), **common
    )
    ref = getattr(jax_rollout, cls_name)(
        env=JaxFakeCalvinEnv(image_hw=64, max_episode_steps=steps, task_set="hard"), **common
    )
    return port, ref


def _drive(cb, state, module, hook, epochs=(0, 1, 2), steps=()):
    trainer = _trainer(state)
    for epoch in epochs:
        trainer.epoch = epoch
        if hook == "validation":
            cb.on_validation_end(trainer, module, {}, [], epoch)
        else:
            for step in steps:
                trainer.global_step = step
                cb.on_train_batch_end(trainer, module, {}, step)
    return trainer


STRATEGIES = {
    "all_tasks": dict(eval_strategy="all_tasks", num_rollouts_per_task=2),
    "env_tasks": dict(eval_strategy="env_tasks"),
    "plain": dict(eval_strategy="plain", num_rollouts=2),
}


@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_rollout_callback_logs_what_jax_logs(cql_pair, play_data, strategy):
    (jc, jcs), (pc, pcs) = cql_pair
    port, ref = _pair("RolloutCallback", play_data, steps=4, every_n_epochs=2, skip_first_n_epochs=1,
                      **STRATEGIES[strategy])
    got = _drive(port, pcs, pc, "validation")
    want = _drive(ref, jcs, jc, "validation")
    assert got.sink.logged == want.sink.logged
    assert got._last_val_metrics == want._last_val_metrics
    # cadence: epoch 0 skipped, epoch 1 off the cadence, epoch 2 fires once
    assert "val_accuracy" in got._last_val_metrics
    assert sum("val_accuracy" in m for m, _, _ in got.sink.logged) == 1
    assert port.state_dict() == ref.state_dict() == {}


def test_rollout_callback_batch_cadence_and_state(cql_pair, play_data):
    (jc, jcs), (pc, pcs) = cql_pair
    kw = dict(eval_strategy="plain", num_rollouts=1, every_n_batches=3, skip_first_n_epochs=1)
    port, ref = _pair("RolloutCallback", play_data, steps=4, **kw)
    got = _drive(port, pcs, pc, "batch", epochs=(0, 1), steps=range(1, 8))
    want = _drive(ref, jcs, jc, "batch", epochs=(0, 1), steps=range(1, 8))
    assert got.sink.logged == want.sink.logged
    # epoch 0 is skipped; in epoch 1 the first step crosses boundary 0
    assert [step for _, step, _ in got.sink.logged] == [1, 3, 6]
    assert all("batch_val/accuracy" in m for m, _, _ in got.sink.logged)
    assert port.state_dict() == ref.state_dict() == {"last_batch_fire": 2}
    # a resumed callback keeps the cadence's position
    resumed, _ = _pair("RolloutCallback", play_data, steps=4, **kw)
    resumed.load_state_dict(port.state_dict())
    trainer = _drive(resumed, pcs, pc, "batch", epochs=(1,), steps=range(6, 9))
    assert [step for _, step, _ in trainer.sink.logged] == []
    assert resumed.state_dict() == {"last_batch_fire": 2}


def test_rollout_long_horizon_callback_logs_what_jax_logs(cql_pair, play_data):
    (jc, jcs), (pc, pcs) = cql_pair
    port, ref = _pair("RolloutLongHorizonCallback", play_data, steps=10, tasks_per_rollout=2,
                      num_rollouts=2)
    got = _drive(port, pcs, pc, "validation", epochs=(0,))
    want = _drive(ref, jcs, jc, "validation", epochs=(0,))
    assert got.sink.logged == want.sink.logged
    assert set(got._last_val_metrics) == {"LH_1_accuracy", "LH_2_accuracy"}


def test_rollout_callback_refuses_an_unknown_strategy(play_data):
    with pytest.raises(ValueError, match="unknown eval_strategy"):
        rollout.RolloutCallback(env=FakeCalvinEnv(), eval_strategy="nope")


def test_training_after_a_rollout(cql_pair, play_data):
    """The agent acts under inference mode on the training net: a train
    step after a rollout still runs, and its parameters change."""
    _, (pc, pcs) = cql_pair
    port, _ = _pair("RolloutCallback", play_data, steps=4, eval_strategy="plain", num_rollouts=1)
    module = CQLModule(cql_cfg(), device="cpu")
    state = module.init_state(0)
    state.net.load_state_dict(pcs.net.state_dict())
    _drive(port, state, module, "validation", epochs=(0,))
    assert not state.net.training
    before = {k: v.clone() for k, v in state.net.state_dict().items()}
    state, metrics = module.make_train_step()(state, cql_batch())
    assert all(torch.isfinite(v).all() for v in metrics.values())
    after = state.net.state_dict()
    assert any(not torch.equal(before[k], after[k]) for k in before if k.startswith("actor."))
