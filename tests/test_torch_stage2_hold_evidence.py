"""The evidence of results/torch_r16_stage2_hold/ (made by its run.sh on one
H100): stage 2 of the visual hierarchy held past the decline of
results/torch_r15_visual/. Pinned: the runs repeat r15's rows bit for bit;
the rollout firings that moved the RNN weights and moved them back; the
graphed run equal bit for bit to itself with a capture after every firing
and to the eager run at the same K; stage 2 at other seeds, with cuDNN's
TF32 off, with TF32 matmuls and with bfloat16-input dense layers; stage 1's
kept checkpoints at sequential depth 3."""

import json
from pathlib import Path

import pytest

RESULTS = Path(__file__).resolve().parent.parent / "results"
HOLD = RESULTS / "torch_r16_stage2_hold"
R15 = RESULTS / "torch_r15_visual"
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
CALLS = ("all", "hold")
STEPS = 4648  # the end of epoch 6
NO_MOVE = (0, 4)  # the epochs whose two firings moved the RNN weights and moved them back
GRAPHED_CAPTURES = [1, 1, 2, 3, 4, 4, 5]
# val_accuracy at the firings after step 3,320 (the archive: 0.889, 0.889, 0.944, 0.944, 0.889)
VARIANTS = {
    ("all", "tf32_off"): [0.5, 0.4444, 0.6667, 0.4444, 0.4444],
    ("all", "seed43"): [0.6111, 0.3333, 0.3333, 0.5, 0.8333],
    ("all", "seed44"): [0.5556, 0.4444, 0.6111, 0.5, 0.4444],
    ("precision", "matmul_high"): [0.4444, 0.5, 0.5, 0.6111, 0.5],
    ("bf16", "bf16_seed42"): [0.4444, 0.4444, 0.4444, 0.5556, 0.4444],
    ("bf16", "bf16_seed43"): [0.3889, 0.5, 0.4444, 0.3889, 0.5],
}
LHSEQ3 = {  # lh_1, lh_2, lh_3, avg_len; the archive: 0.975, 0.95, 0.838, 2.763
    9840: [0.8125, 0.45, 0.2625, 1.525],
    12464: [0.9125, 0.7, 0.35, 1.9625],
    15008: [0.9125, 0.8, 0.4625, 2.175],
}


def _rows(path, last=None):
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    return [{k: v for k, v in r.items() if k != "time"} for r in rows if last is None or r["step"] <= last]


def _records(call, name):
    return [json.loads(line) for line in (HOLD / call / f"firings_{name}.jsonl").read_text().splitlines()]


@pytest.mark.parametrize("call", CALLS)
def test_each_call_repeats_r15s_runs_bit_for_bit(call):
    assert _rows(HOLD / call / "lmp_metrics.jsonl") == _rows(R15 / "lmp_metrics.jsonl")
    graphed = _rows(HOLD / call / "tacorl_graphed_metrics.jsonl")
    assert graphed[-1]["step"] == STEPS and graphed == _rows(R15 / "tacorl_metrics.jsonl", STEPS)
    assert (HOLD / call / "card.txt").read_text().strip() == CARD


@pytest.mark.parametrize("call", CALLS)
def test_two_firings_moved_the_weights_and_moved_them_back(call):
    records = _records(call, "graphed")
    firings = [r for r in records if r["kind"] == "firing"]
    assert all(r["moved"] for r in firings)
    back = sorted({r["epoch"] for r in firings if r["at_capture_addresses"]})
    assert back == list(NO_MOVE)
    for epoch in NO_MOVE:
        first, second = [r for r in firings if r["epoch"] == epoch]
        assert (first["callback"], second["callback"]) == ("RolloutCallback", "RolloutLongHorizonCallback")
        assert second["rnn_buffers_after"] == first["rnn_buffers_before"] != first["rnn_buffers_after"]
    captures = [r["captures"] for r in records if r["kind"] == "epoch_end"]
    assert captures == GRAPHED_CAPTURES  # no capture in epochs 1 and 5


@pytest.mark.parametrize("call", CALLS)
def test_a_capture_after_every_firing_trains_what_the_replay_trains(call):
    captures = [r["captures"] for r in _records(call, "capture") if r["kind"] == "epoch_end"]
    assert captures == list(range(1, len(GRAPHED_CAPTURES) + 1))
    assert _rows(HOLD / call / "tacorl_capture_metrics.jsonl") == _rows(HOLD / call / "tacorl_graphed_metrics.jsonl")


def test_the_eager_run_at_the_same_k_equals_the_graphed_run():
    eager = _rows(HOLD / "hold" / "tacorl_eager_metrics.jsonl")
    assert eager == _rows(HOLD / "hold" / "tacorl_graphed_metrics.jsonl") and eager[-1]["step"] == STEPS
    hold = (HOLD / "hold" / "hold.txt").read_text()
    assert "hold: 139 rows held" in hold and "139 equal bit for bit" in hold
    assert "hold: every row within rtol 0.0001" in hold


def test_phase_train_hierarchy_replayed_across_a_firing_that_moved_nothing():
    line = (HOLD / "hold" / "train_hierarchy.txt").read_text()
    assert "captures at the epoch ends [1, 2, 2]" in line and "epoch 2 (CQL) replayed across it" in line
    assert "(largest 0)" in line and CARD in line


@pytest.mark.parametrize("call, name", list(VARIANTS))
def test_stage_two_declines_at_other_seeds_and_precisions(call, name):
    rows = _rows(HOLD / call / f"tacorl_{name}_metrics.jsonl")
    after = [round(r["val_accuracy"], 4) for r in rows if "val_accuracy" in r and r["step"] > 3320]
    assert after == VARIANTS[call, name] and max(after[:-1]) < 0.75
    assert rows[-1]["step"] == 6000


def test_the_precision_runs_ran_at_their_settings():
    log = (HOLD / "all" / "train_tacorl_tf32_off.log").read_text()
    assert "matmul allow_tf32 False cudnn allow_tf32 False" in log
    for name in ("high", "medium"):  # cuBLAS takes TF32 at both: one error, one run
        log = (HOLD / "precision" / f"train_tacorl_matmul_{name}.log").read_text()
        assert f"float32 matmul precision {name}: matmul allow_tf32 True, cudnn allow_tf32 True" in log
        assert "against float64 0.000294" in log
    high, medium = (_rows(HOLD / "precision" / f"tacorl_matmul_{p}_metrics.jsonl") for p in ("high", "medium"))
    assert high == medium
    for seed in (42, 43):
        log = (HOLD / "bf16" / f"train_tacorl_bf16_seed{seed}.log").read_text()
        assert "TorchDense: bfloat16 inputs and weights, float32 sums; matmul allow_tf32 False" in log


@pytest.mark.parametrize("step", list(LHSEQ3))
def test_stage_one_checkpoints_at_sequential_depth_3(step):
    got = json.loads((HOLD / "all" / f"lmp_lhseq3_{step}.json").read_text())
    assert got["num_rollouts"] == 80 and got["tasks_per_rollout"] == 3
    assert [got["lh_1_accuracy"], got["lh_2_accuracy"], got["lh_3_accuracy"], got["avg_len"]] == LHSEQ3[step]
    assert got["lh_3_accuracy"] < 0.838  # below the archive at every kept step
