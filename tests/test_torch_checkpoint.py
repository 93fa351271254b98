"""The port's CheckpointManager held against the JAX package's: one
sequence of (step, metric) saves fed to both, with ``mode`` min and max,
NaN metrics, no monitor, and the directory reopened midway, must keep the
same steps, give the same ``best_step`` and write the same metrics.json;
``restore("best")``, ``load_module_from_checkpoint(step="best")`` and
``python -m tacorl_tpu_torch.evaluate epoch=best`` reach that step."""

import json

import numpy as np
import pytest
import torch

from tacorl_tpu.core.checkpoint import CheckpointManager as JaxCheckpointManager
from tacorl_tpu_torch import evaluate
from tacorl_tpu_torch.core.checkpoint import CheckpointManager, load_module_from_checkpoint
from tacorl_tpu_torch.core.train_state import TrainState
from tacorl_tpu_torch.modules.play_lmp import PlayLMPModule
from tests.test_torch_evaluate import _common, eval_data  # noqa: F401
from tests.test_torch_play_lmp import _cfg

NAN = float("nan")
SEQUENCES = {
    "min": ("min", [3.0, 1.0, 2.0, NAN, 0.5, 4.0, 0.7]),
    "max": ("max", [0.1, 0.9, NAN, 0.5, 0.95, 0.2, NAN]),
    "all_nan": ("max", [NAN] * 5),
    "ties": ("max", [0.5, 0.5, 0.0, 0.5, 0.0]),
}


class _State:
    """A stand-in TrainState for the port's manager."""

    def __init__(self, step):
        self.step = step

    def state_dict(self):
        return {"step": self.step, "w": torch.full((2,), float(self.step))}


def _save_both(port, ref, step, value, monitor):
    metrics = None if np.isnan(value) and step % 2 else {monitor or "m": value}
    port.save(step, _State(step), metrics=metrics)
    ref.save(step, {"step": np.asarray(step), "w": np.full((2,), float(step))}, metrics=metrics)


@pytest.mark.parametrize("max_to_keep", [1, 2, 3])
@pytest.mark.parametrize("monitor", ["validation/total_loss", None])
@pytest.mark.parametrize("seq", list(SEQUENCES))
def test_retention_matches_jax(tmp_path, seq, monitor, max_to_keep):
    mode, values = SEQUENCES[seq]
    dirs = tmp_path / "port", tmp_path / "jax"

    def open_both():
        kw = dict(max_to_keep=max_to_keep, monitor=monitor, mode=mode)
        return CheckpointManager(dirs[0], **kw), JaxCheckpointManager(dirs[1], **kw)

    port, ref = open_both()
    for i, value in enumerate(values):
        if i == len(values) // 2:
            port, ref = open_both()  # reopened midway: metrics.json carries on
        _save_both(port, ref, (i + 1) * 10, value, monitor)
        assert port.all_steps() == ref.all_steps()
        assert port.best_step() == ref.best_step()
        assert port.latest_step() == ref.latest_step()
    assert (dirs[0] / "ckpts" / "metrics.json").read_text() == (dirs[1] / "ckpts" / "metrics.json").read_text()
    assert len(port.all_steps()) == min(max_to_keep, len(values))
    best = port.best_step()
    assert port.restore("best")["step"] == best
    assert port.restore()["step"] == port.latest_step()


def test_reopening_without_config_keeps_the_metrics(tmp_path):
    manager = CheckpointManager(tmp_path, monitor="m", mode="min", config={"module": {}})
    for step, value in ((1, 0.3), (2, 0.1), (3, 0.2)):
        manager.save(step, _State(step), metrics={"m": value})
    metrics = json.loads((tmp_path / "ckpts" / "metrics.json").read_text())
    reopened = CheckpointManager(tmp_path)  # as load_module_from_checkpoint opens it
    assert json.loads((tmp_path / "ckpts" / "metrics.json").read_text()) == metrics
    assert reopened.load_config() == {"module": {}}
    assert CheckpointManager(tmp_path, mode="min").best_step() == 2


def test_restore_without_checkpoints_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path).restore("best")


@pytest.fixture(scope="module")
def lmp_run(tmp_path_factory):
    """A tiny Play-LMP run with three saves whose monitored loss is best at
    the middle one."""
    run = tmp_path_factory.mktemp("lmp_run")
    cfg = {"_target_": "tacorl_tpu.modules.play_lmp.PlayLMPModule", **_cfg()}
    cfg["transforms"]["rgb_static"]["size"] = [48, 48]
    module = PlayLMPModule(cfg, device="cpu")
    manager = CheckpointManager(run, monitor="validation/total_loss", mode="min",
                                config={"module": cfg})
    for step, loss in ((1, 2.0), (2, 1.0), (3, 1.5)):
        state = module.init_state(step)
        state.step = step
        manager.save(step, state, metrics={"validation/total_loss": loss})
    return run


def test_load_module_from_checkpoint_best(lmp_run):
    module, state = load_module_from_checkpoint(lmp_run, step="best", device="cpu")
    assert isinstance(state, TrainState) and state.step == 2
    want = torch.load(lmp_run / "ckpts" / "2" / "state.pt", weights_only=True)["net"]
    got = state.net.state_dict()
    assert all(torch.equal(got[k], v) for k, v in want.items())


def test_evaluate_epoch_best_scores_the_best_step(lmp_run, eval_data, tmp_path):  # noqa: F811
    args = ["+device=cpu", f"module_path={lmp_run}"]
    best = evaluate.main(args + ["epoch=best"] + _common("short_horizon", eval_data, tmp_path / "best.json"))
    step2 = evaluate.main(args + ["epoch=2"] + _common("short_horizon", eval_data, tmp_path / "two.json"))
    assert best and best == step2
