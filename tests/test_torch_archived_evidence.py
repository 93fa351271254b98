"""Pin the port's archived H100 run of flat goal-conditioned CQL
(``results/torch_r6_cql_state/``, made by its ``run.sh``) to the claims in
PERF.md and ROADMAP.md, in the manner of tests/test_archived_evidence.py:
the run's composed config, its best monitored ``val_accuracy`` and step,
the goal-horizon series, the offline score of the best checkpoint over all
160 validation spans (40 a task), and the card named in its README."""

import json
from pathlib import Path

import pytest

RUN = Path(__file__).resolve().parent.parent / "results" / "torch_r6_cql_state"
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
BEST_STEP, BEST_ACC = 4285, 1.0  # the first of three steps at 1.0
OFFLINE = 0.625  # the archived JAX run: 0.775
PER_TASK = {"turn_on_led": 0.475, "open_drawer": 0.6, "lift_block": 0.725, "move_slider_left": 0.7}
HORIZONS = [16.0 + 8 * i for i in range(15)] + [128.0] * 4  # logged at each epoch end


def _rows():
    with open(RUN / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _series(key):
    return [(r["step"], r[key]) for r in _rows() if key in r]


def test_the_run_is_the_archived_recipe():
    cfg = json.loads((RUN / "config.json").read_text())
    assert cfg["experiment_name"] == "cql_fake_state" and cfg["seed"] == 42
    assert cfg["trainer"]["max_steps"] == 15600 and cfg["datamodule"]["batch_size"] == 32
    module = cfg["module"]
    assert module["bc_epochs"] == 8 and module["policy"]["hidden_dim"] == 512
    assert module["q_network"]["hidden_dim"] == 512 and module["goal_encoder"]["hidden_size"] == 256
    ds = cfg["datamodule"]["dataset"]
    assert ds["goal_strategy_prob"] == {"geometric": 0.7, "increasing_horizon": 0.3, "similar_robot_obs": 0.0}
    assert (ds["initial_horizon"], ds["horizon_step"], ds["max_horizon"]) == (16, 8, 128)
    assert cfg["callbacks"]["rollout"]["every_n_epochs"] == 1
    assert "device" not in cfg  # the card, as every port entry point defaults


def test_best_val_accuracy_and_its_step():
    curve = _series("val_accuracy")
    step, best = max(curve, key=lambda sa: sa[1])
    assert (step, best) == (BEST_STEP, BEST_ACC), curve
    assert best >= 0.8  # tests/test_train_to_success_cql.py's bar


def test_horizon_grows_from_sixteen():
    horizons = [h for _, h in _series("train/goal_horizon")]
    assert horizons == HORIZONS
    assert horizons[0] == 16.0 and horizons[-1] > 16.0
    assert all(b >= a for a, b in zip(horizons, horizons[1:]))


def test_offline_score_over_all_160_spans():
    per_task = json.loads((RUN / "cql_state_eval_best.json").read_text())
    assert {t: v["accuracy"] for t, v in per_task.items()} == PER_TASK
    assert all(v["num_rollouts"] == 40 for v in per_task.values()), per_task
    n = sum(v["num_rollouts"] for v in per_task.values())
    overall = sum(v["accuracy"] * v["num_rollouts"] for v in per_task.values()) / n
    assert overall == pytest.approx(OFFLINE, abs=1e-9) and overall >= 0.5


def test_readme_names_the_card_and_the_walls():
    readme = (RUN / "README.md").read_text()
    assert CARD in readme
    assert (RUN / "card.txt").read_text().strip() == CARD
    walls = dict(line.split() for line in (RUN / "walls.txt").read_text().splitlines())
    assert set(walls) == {"make_flagship_data", "train", "evaluate"}
    assert all(f"{float(v):.1f}" in readme for v in walls.values())
