"""Pin the port's archived H100 run of flat goal-conditioned CQL
(``results/torch_r6_cql_state/``, made by its ``run.sh``) to the claims in
PERF.md and ROADMAP.md, in the manner of tests/test_archived_evidence.py:
the run's composed config, its best monitored ``val_accuracy`` and step,
the goal-horizon series, the offline score of the best checkpoint over all
160 validation spans (40 a task), and the card named in its README. Also
the D4RL hierarchy's H100 run (``results/torch_r7_d4rl/``): its two
recipes, each stage's best ``val_accuracy``, stage 2's last 10
evaluations, the three 100-rollout scores and the walls. And the RIL run
(``results/torch_r8_ril/``): its recipe, the in-training evaluations, the
oracle and learned 48-rollout scores and the walls. And the online runs
(``results/torch_r9_online/``): both recipes, the first and best
evaluations against the JAX package's bars, the conservative penalty's
flushes and the walls. And the visual TACO-RL hierarchy
(``results/torch_r15_visual/``): both recipes key by key against the
archived ones, each stage's best ``val_accuracy``, the step graph's
captures at each epoch end, the six scores against the JAX package's bars
and the walls."""

import json
from pathlib import Path

import pytest
import yaml

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


# -- the D4RL hierarchy (results/torch_r7_d4rl/, made by its run.sh) ----------------------

D4RL = RUN.parent / "torch_r7_d4rl"
D4RL_BEST = {"lmp": (5412, 1.0), "tacorl": (22, 1.0)}  # (step, val_accuracy), the first best
D4RL_TAIL = [1.0] * 10  # stage 2's last 10 evaluations
# 100 rollouts each; the archive: 1.0 each
D4RL_SCORES = {"lmp_eval_best": 0.98, "tacorl_eval_best": 1.0, "tacorl_eval_final": 1.0}
SUCCESS_BAR = 0.8  # tests/test_train_to_success_d4rl.py


def _d4rl_series(stage, key):
    with open(D4RL / f"{stage}_metrics.jsonl") as f:
        return [(r["step"], r[key]) for r in map(json.loads, f) if key in r]


@pytest.mark.parametrize("stage, experiment, max_steps", [
    ("lmp", "play_lmp_d4rl_fake", 8000), ("tacorl", "tacorl_d4rl_fake", 3000),
])
def test_the_d4rl_runs_are_the_archived_recipe(stage, experiment, max_steps):
    cfg = json.loads((D4RL / f"{stage}_config.json").read_text())
    assert cfg["experiment_name"] == experiment and cfg["seed"] == 42
    assert cfg["trainer"]["max_steps"] == max_steps and cfg["datamodule"]["batch_size"] == 64
    assert cfg["ckpt_monitor"] == "val_accuracy" and cfg["ckpt_mode"] == "max"
    rollout = cfg["callbacks"]["rollout"]
    assert rollout["num_rollouts"] == 20 and rollout["plan_duration"] == 8
    assert rollout["every_n_epochs"] == (5 if stage == "lmp" else 1)
    assert "device" not in cfg  # the card, as every port entry point defaults
    if stage == "tacorl":
        assert cfg["module"]["bc_epochs"] == 1 and cfg["module"]["finetune_action_decoder"] is True


@pytest.mark.parametrize("stage", ["lmp", "tacorl"])
def test_d4rl_best_val_accuracy_and_its_step(stage):
    curve = _d4rl_series(stage, "val_accuracy")
    step, best = max(curve, key=lambda sa: sa[1])
    assert (step, best) == D4RL_BEST[stage], curve
    assert best >= SUCCESS_BAR


def test_d4rl_stage_one_scores_above_zero():
    assert max(v for _, v in _d4rl_series("lmp", "val_score")) > 0.0


def test_d4rl_cql_phase_recovers_in_the_tail():
    tail = [v for _, v in _d4rl_series("tacorl", "val_accuracy")][-10:]
    assert tail == D4RL_TAIL
    assert max(tail) >= SUCCESS_BAR


@pytest.mark.parametrize("name", sorted(D4RL_SCORES))
def test_d4rl_scores_over_100_rollouts(name):
    got = json.loads((D4RL / f"d4rl_{name}.json").read_text())
    assert got["num_rollouts"] == 100
    assert got["accuracy"] == D4RL_SCORES[name]


def test_d4rl_readme_names_the_card_and_the_walls():
    readme = (D4RL / "README.md").read_text()
    assert CARD in readme and (D4RL / "card.txt").read_text().strip() == CARD
    walls = dict(line.split() for line in (D4RL / "walls.txt").read_text().splitlines())
    assert set(walls) == {"make_data", "train_lmp", "train_tacorl", "eval_lmp_best", "eval_tacorl_best",
                          "eval_tacorl_final"}
    assert all(f"{float(v):.1f}" in readme for v in walls.values())


# -- Relay Imitation Learning (results/torch_r8_ril/, made by its run.sh) ---------------------

RIL = Path(__file__).resolve().parent.parent / "results" / "torch_r8_ril"
RIL_EVALS = [(857, 0.0), (4285, 0.0), (7713, 0.0), (11141, 1 / 6), (14569, 0.5)]  # every 4 epochs
RIL_SCORES = {  # 12 rollouts a task at step 16,000; the archived JAX run: 0.875 / 0.354
    "ril_oracle": ({"turn_on_led": 8 / 12, "open_drawer": 1.0, "lift_block": 10 / 12,
                    "move_slider_left": 1.0}, 0.875),
    "ril_learned": ({"turn_on_led": 1 / 12, "open_drawer": 3 / 12, "lift_block": 4 / 12,
                     "move_slider_left": 7 / 12}, 0.3125),
}


def test_the_ril_run_is_the_archived_recipe():
    cfg = json.loads((RIL / "config.json").read_text())
    assert cfg["experiment_name"] == "ril_fake_state" and cfg["seed"] == 42
    assert cfg["trainer"]["max_steps"] == 16000 and cfg["trainer"]["steps_per_call"] == 1
    assert cfg["datamodule"]["batch_size"] == 32 and cfg["datamodule"]["val_percentage"] == 1.0
    ds = cfg["datamodule"]["dataset"]
    assert (ds["max_low_level_window"], ds["max_high_level_window"]) == (8, 80)
    low = cfg["module"]["low_level_policy"]
    assert (low["num_layers"], low["hidden_dim"], low["discrete_gripper"]) == (3, 512, True)
    assert cfg["module"]["goal_encoder"] == {"out_features": 64, "hidden_size": 256,
                                             "last_layer_activation": "Tanh"}
    assert cfg["callbacks"]["rollout"]["every_n_epochs"] == 4
    assert "device" not in cfg


def test_ril_in_training_evaluations():
    rows = [json.loads(line) for line in (RIL / "metrics.jsonl").read_text().splitlines()]
    evals = [(r["step"], r["val_accuracy"]) for r in rows if "val_accuracy" in r]
    assert evals == pytest.approx(RIL_EVALS)
    assert max(a for _, a in evals) == 0.5  # the archived run's best: 0.556 at step 14,552
    high = [r["validation/high_level_loss"] for r in rows if "validation/high_level_loss" in r]
    assert len(high) == 19 and max(high) < -100  # 18 epochs of 857 steps and one of 574


@pytest.mark.parametrize("name", list(RIL_SCORES))
def test_ril_scores_over_48_rollouts(name):
    per_task, overall_want = RIL_SCORES[name]
    results = json.loads((RIL / f"{name}.json").read_text())
    assert {t: v["accuracy"] for t, v in results.items()} == pytest.approx(per_task)
    assert all(v["num_rollouts"] == 12 for v in results.values())
    overall = sum(v["accuracy"] * v["num_rollouts"] for v in results.values()) / 48
    assert overall == pytest.approx(overall_want, abs=1e-9)
    # the JAX round's bar: oracle subgoals >= 0.8, the learned hierarchy above 0
    assert overall >= 0.8 if name == "ril_oracle" else overall > 0


def test_ril_readme_names_the_card_and_the_walls():
    readme = (RIL / "README.md").read_text()
    assert CARD in readme and (RIL / "card.txt").read_text().strip() == CARD
    walls = dict(line.split() for line in (RIL / "walls.txt").read_text().splitlines())
    assert set(walls) == {"make_flagship_data", "train", "oracle", "learned"}
    assert all(f"{float(v):.1f}" in readme for v in walls.values())


# -- online CQL and SAC (results/torch_r9_online/, made by its run.sh) ------------------------

ONLINE = Path(__file__).resolve().parent.parent / "results" / "torch_r9_online"
# name -> (max_steps, the first evaluation's return, best return and its step, the step of
# the first val_accuracy of 1.0, tests/test_train_to_success_baselines.py's bars)
ONLINE_RUNS = {
    "cql_online_fake": (20000, -32.15, (11750, -1.73), 7250, 15.0, 0.6),
    "sac_online_fake": (12000, -32.25, (11750, -1.79), 7750, 10.0, 0.5),
}


def _online_rows(name):
    return [json.loads(line) for line in (ONLINE / f"{name}_metrics.jsonl").read_text().splitlines()]


@pytest.mark.parametrize("name", list(ONLINE_RUNS))
def test_the_online_runs_are_the_archived_recipe(name):
    cfg = json.loads((ONLINE / f"{name}_config.json").read_text())
    assert cfg["experiment_name"] == name and cfg["seed"] == 42 and "device" not in cfg
    assert cfg["trainer"]["max_steps"] == ONLINE_RUNS[name][0] and cfg["trainer"]["steps_per_call"] == 1
    assert cfg["datamodule"] == {"_target_": "tacorl_tpu.data.online_datamodule.OnlineRLDataModule",
                                 "batch_size": 128, "steps_per_epoch": 250, "seed": 42}
    module = cfg["module"]
    assert (module["warm_start_steps"], module["discount"], module["actor_lr"]) == (500, 0.9, 1e-3)
    assert module["policy"]["hidden_dim"] == module["q_network"]["hidden_dim"] == 64
    assert cfg["env"]["tcp_shaping_weight"] == 1.0 and cfg["callbacks"]["rollout"]["num_rollouts"] == 10
    online_cql = name == "cql_online_fake"
    assert module["_target_"].endswith("CQLOnlineModule" if online_cql else "SACModule")
    assert module.get("with_lagrange", False) == online_cql
    if online_cql:
        assert (module["conservative_weight"], module["n_action_samples"]) == (0.3, 4)


@pytest.mark.parametrize("name", list(ONLINE_RUNS))
def test_the_online_runs_meet_the_jax_bars(name):
    _, first_want, best_want, first_one, bar_return, bar_acc = ONLINE_RUNS[name]
    rows = _online_rows(name)
    evals = [(r["step"], r["val_episode_return"], r["val_accuracy"]) for r in rows if "val_accuracy" in r]
    assert len(evals) == ONLINE_RUNS[name][0] // 250
    assert evals[0][1] == pytest.approx(first_want, abs=5e-3) and evals[0][2] == 0.0
    step, best, _ = max(evals, key=lambda e: e[1])
    assert (step, round(best, 2)) == best_want
    assert min(s for s, _, a in evals if a == 1.0) == first_one
    assert best >= evals[0][1] + bar_return and max(a for _, _, a in evals) >= bar_acc
    gaps = [r for r in rows if "train/conservative_q1_gap" in r]
    alphas = [r["train/alpha_prime"] for r in rows if "train/alpha_prime" in r]
    if name == "cql_online_fake":  # the penalty was live the whole run
        assert len(gaps) == 400 and len(alphas) == 400 and alphas[-1] < 1e-3 < alphas[0]
        assert [a for _, _, a in evals[-4:]] == [0.7, 0.9, 0.9, 0.9]  # the archive: 1.0 x 4
    else:
        assert not gaps and not alphas


def test_the_online_readme_names_the_card_and_the_walls():
    readme = (ONLINE / "README.md").read_text()
    assert CARD in readme and (ONLINE / "card.txt").read_text().strip() == CARD
    assert (ONLINE / "time" / "card.txt").read_text().strip() == CARD
    walls = dict(line.split() for line in (ONLINE / "walls.txt").read_text().splitlines())
    assert set(walls) == {"cql_online_fake", "sac_online_fake"}
    assert all(f"{float(v):.1f}" in readme for v in walls.values())
    kept = json.loads((ONLINE / "cql_online_fake_kept_checkpoints.json").read_text())
    assert list(kept) == ["11750", "18500", "20000"]


# -- the visual hierarchy (results/torch_r15_visual/, made by its run.sh run) -----------------

VISUAL = RUN.parent / "torch_r15_visual"
ARCHIVED = RUN.parent / "r5_train_to_success"
# where a run's config.json may differ from the archived recipe: where the data and
# the runs lived, and ``platform`` (a JAX backend, which the port ignores)
PATHS = {"data_dir", "run_dir", "datamodule.data_dir", "callbacks.rollout.data_dir",
         "callbacks.rollout.start_end_tasks"}
VISUAL_DIFFERENCES = {
    "lmp": PATHS | {"platform"},
    "tacorl": PATHS | {"platform", "play_lmp_dir", "module.play_lmp_dir", "callbacks.rollout_lh.data_dir",
                       "callbacks.rollout_lh.start_end_tasks"},
}
# (step, val_accuracy): the first best; the archive: 0.944 at 14,456 and at 5,312
VISUAL_BEST = {"lmp": (12464, 1.0), "tacorl": (3320, 1.0)}
VISUAL_LAST = {"lmp": 15008, "tacorl": 6000}  # K = 16 overshoots 15,000 by 8
# the step graph's captures at each epoch end: again after each rollout that moved the weights
VISUAL_CAPTURES = {
    "lmp": [1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12],
    "tacorl": [1, 1, 2, 3, 4, 4, 5, 6, 7, 8],
}
VISUAL_SINGLE = {  # 40 spans a task; the archive: 0.975 / 0.938
    "lmp": ({"turn_on_led": 0.875, "open_drawer": 1.0, "lift_block": 0.825, "move_slider_left": 0.925}, 0.90625),
    "taco": ({"turn_on_led": 0.875, "open_drawer": 0.975, "lift_block": 0.9, "move_slider_left": 0.975}, 0.93125),
}
VISUAL_LH = {  # lh_1, lh_2[, lh_3], avg_len; the archive's lh_2: 0.383 / 0.617, sequential lh_3: 0.838 / 0.613
    "lmp_lh2": (120, [0.9, 0.5833333333333334], 1.4833333333333334),
    "taco_lh2": (120, [0.9833333333333333, 0.875], 1.8583333333333334),
    "lmp_lhseq3": (80, [0.9125, 0.7, 0.35], 1.9625),
    "taco_lhseq3": (80, [0.95, 0.525, 0.1375], 1.6125),
}


def _flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}.{k}" if prefix else k))
    return out


def _visual_rows(stage):
    return [json.loads(line) for line in (VISUAL / f"{stage}_metrics.jsonl").read_text().splitlines()]


@pytest.mark.parametrize("stage", ["lmp", "tacorl"])
def test_the_visual_runs_are_the_archived_recipe(stage):
    want = _flat(yaml.safe_load((ARCHIVED / f"{stage}_config.yaml").read_text()))
    got = _flat(json.loads((VISUAL / f"{stage}_config.json").read_text()))
    assert {k for k in want.keys() | got.keys() if want.get(k) != got.get(k)} == VISUAL_DIFFERENCES[stage]
    assert got["platform"] == "cpu" and "device" not in got  # the card, as every port entry point defaults
    if stage == "tacorl":  # grafted from stage 1's latest step
        assert got["module.play_lmp_dir"] == got["play_lmp_dir"] and got["module.lmp_epoch_to_load"] == -1


@pytest.mark.parametrize("stage", ["lmp", "tacorl"])
def test_visual_best_val_accuracy_and_its_step(stage):
    rows = _visual_rows(stage)
    curve = [(r["step"], r["val_accuracy"]) for r in rows if "val_accuracy" in r]
    step, best = max(curve, key=lambda sa: sa[1])
    assert (step, best) == VISUAL_BEST[stage], curve
    assert best >= 0.8  # tests/test_train_to_success.py:79,117
    assert rows[-1]["step"] == VISUAL_LAST[stage]


@pytest.mark.parametrize("stage", ["lmp", "tacorl"])
def test_the_step_graph_captures_again_after_the_rollouts(stage):
    lines = (VISUAL / f"{stage}_captures.txt").read_text().splitlines()
    captures = [int(line.split("captures ")[1].split()[0]) for line in lines]
    replays = [int(line.split("replays ")[1]) for line in lines]
    assert captures == VISUAL_CAPTURES[stage]
    assert replays[-1] == VISUAL_LAST[stage]


@pytest.mark.parametrize("stage", ["lmp", "taco"])
def test_visual_single_task_scores_over_160_spans(stage):
    per_task_want, overall_want = VISUAL_SINGLE[stage]
    results = json.loads((VISUAL / f"{stage}_eval_best.json").read_text())
    assert {t: v["accuracy"] for t, v in results.items()} == per_task_want
    assert all(v["num_rollouts"] == 40 for v in results.values())
    overall = sum(v["accuracy"] * v["num_rollouts"] for v in results.values()) / 160
    assert overall == pytest.approx(overall_want, abs=1e-9)


@pytest.mark.parametrize("name", list(VISUAL_LH))
def test_visual_long_horizon_scores(name):
    n, accs, avg_len = VISUAL_LH[name]
    got = json.loads((VISUAL / f"{name}.json").read_text())
    assert got["num_rollouts"] == n and got["tasks_per_rollout"] == len(accs)
    assert [got[f"lh_{i + 1}_accuracy"] for i in range(len(accs))] == accs and got["avg_len"] == avg_len


def test_the_visual_hierarchy_meets_the_jax_bars():
    """tests/test_train_to_success.py:171-176 (depth 2) and :191-192
    (sequential depth 3) on the port's runs."""
    lmp, taco = (json.loads((VISUAL / f"{s}_lh2.json").read_text()) for s in ("lmp", "taco"))
    assert taco["lh_1_accuracy"] >= 0.5 and taco["lh_2_accuracy"] >= 0.3
    assert taco["lh_2_accuracy"] >= lmp["lh_2_accuracy"] + 0.1
    seq = json.loads((VISUAL / "taco_lhseq3.json").read_text())
    assert seq["lh_1_accuracy"] >= 0.3 and seq["avg_len"] >= 0.4


def test_the_visual_readme_names_the_card_and_the_walls():
    readme = (VISUAL / "README.md").read_text()
    assert CARD in readme and (VISUAL / "card.txt").read_text().strip() == CARD
    walls = dict(line.rsplit(" ", 1) for line in (VISUAL / "walls.txt").read_text().splitlines())
    assert set(walls) == {"make_flagship_data", "train_lmp", "train_lmp ms_per_step_80_to_400", "train_tacorl",
                          "train_tacorl ms_per_step_80_to_400", "eval_lmp_single", "eval_lmp_lh2",
                          "eval_lmp_lhseq3", "eval_taco_single", "eval_taco_lh2", "eval_taco_lhseq3"}
    assert all(v in readme for v in walls.values())
