#!/usr/bin/env bash
# The visual hierarchy's recipes (results/r5_train_to_success/lmp_config.yaml
# and tacorl_config.yaml) data-parallel over NCCL at W = 1, 2 and 4 cards of
# one host, each at the archived K-step dispatch (trainer.steps_per_call 16
# for stage 1, 8 for stage 2: CUDA-graph replays of the train step, the
# gradient all-reduce captured in the graph) and the archived global batch
# (32 and 64 a step, split over the W ranks), on the flagship expert-play set.
#
#   bash results/torch_r12_ddp/run.sh time <out_dir>   # 400 steps of each stage at each W
#   bash results/torch_r12_ddp/run.sh lmp <out_dir>    # stage 1 only, at each W
#   bash results/torch_r12_ddp/run.sh tacorl <out_dir> # stage 1 at W = 1, then stage 2 at each W
#   bash results/torch_r12_ddp/run.sh steps <out_dir>  # play_lmp_fake's first 8 steps at W = 1 and 2,
#                                                      # K = 2 (graphed), every chunk logged
#
# Every rank is a process launched by torch.distributed.run on its own
# card. <out_dir> receives the cards' names and power limits (card.txt), the
# torch versions (torch.txt), each run's log and metrics.jsonl, and
# walls.txt: the wall time of each command, its ms a step between the train
# rows logged at steps 80 and 400 (inside the first epoch), the NCCL kernels
# and kernel-1 launches in the device trace of rank 0's replays of steps
# 33-64 (probe.py; the trace ends before the timed steps begin), and each
# run's train row at step 400 and weights after it against the W = 1 run's.
# Every headline line is also printed, so the command's own output holds
# them if <out_dir> is lost.
set -euo pipefail
mode=$1
out=$(realpath -m "$2")
here=$(dirname "$(realpath "$0")")
export PYTHONPATH="$(realpath "$here/../..")${PYTHONPATH:+:$PYTHONPATH}"  # probe.py imports the port
work=$(mktemp -d)
trap 'rm -rf "$work"' EXIT
mkdir -p "$out"

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/card.txt"
python -c 'import torch; print("torch", torch.__version__, "cuda", torch.version.cuda, "cards", torch.cuda.device_count(),
  "matmul allow_tf32", torch.backends.cuda.matmul.allow_tf32, "cudnn allow_tf32", torch.backends.cudnn.allow_tf32)' \
  | tee "$out/torch.txt"

timed() {  # timed <label> <command...>: runs it with its output in <label>.log,
           # and appends "<label> <seconds>" to walls.txt
  local label=$1; shift
  local t0; t0=$(date +%s.%N)
  "$@" > "$out/$label.log" 2>&1 || { tail -n 60 "$out/$label.log"; exit 1; }
  grep -h '^\[probe\]' "$out/$label.log" | tee -a "$out/walls.txt" || true
  awk -v a="$t0" -v b="$(date +%s.%N)" -v l="$label" 'BEGIN { printf "%s %.1f\n", l, b - a }' \
    | tee -a "$out/walls.txt"
}

ms_per_step() {  # ms a step between the train rows of steps 80 and 400
  python - "$1" "$2" <<'PY' | tee -a "$out/walls.txt"
import json, sys
rows = {r["step"]: r for r in map(json.loads, open(sys.argv[1])) if any(k.startswith("train/") for k in r)}
a, b = rows[80], rows[400]
print(f"{sys.argv[2]} ms_per_step_80_to_400 {(b['time'] - a['time']) * 1e3 / 320:.3f}")
PY
}

against_w1() {  # the train row at step 400 against the W = 1 run's: the largest relative difference
  python - "$1" "$2" "$3" <<'PY' | tee -a "$out/walls.txt"
import json, sys
def row(path):
    return next(r for r in map(json.loads, open(path)) if r["step"] == 400 and any(k.startswith("train/") for k in r))
got, want = row(sys.argv[1]), row(sys.argv[2])
errs = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-6) for k in want if k.startswith("train/")}
worst = max(errs, key=errs.get)
print(f"{sys.argv[3]} step 400 vs W=1: {len(errs)} train metrics, largest relative difference {errs[worst]:.3g} ({worst}); "
      f"total_loss {got.get('train/total_loss', got.get('train/q1_loss'))} vs {want.get('train/total_loss', want.get('train/q1_loss'))}")
PY
}

weights_against_w1() {  # the last checkpoint's weights against the W = 1 run's: atol 2.5 lr a step
  python - "$1" "$2" "$3" <<'PY' | tee -a "$out/walls.txt"
import json, sys
from tacorl_tpu_torch.core.checkpoint import CheckpointManager
got, want = (CheckpointManager(d).restore() for d in sys.argv[1:3])
module = json.loads(open(f"{sys.argv[2]}/config.json").read())["module"]
lr = max(float(v) for k, v in module.items() if k == "lr" or k.endswith("_lr"))
worst = max(float((got["net"][k].float() - w.float()).abs().max()) for k, w in want["net"].items() if w.numel())
print(f"{sys.argv[3]} weights at step {got['step']} vs W=1's at {want['step']}: largest difference {worst:.3g} "
      f"(atol 2.5 lr a step = {2.5 * lr * want['step']:.3g})")
PY
}

train() {  # train <W> <experiment> <run dir> <K> [overrides...]: W ranks over NCCL, rank 0 traced by probe.py
  local w=$1 experiment=$2 run=$3 k=$4; shift 4
  python -m torch.distributed.run --standalone --nproc_per_node="$w" "$here/probe.py" \
    "experiment=$experiment" "data_dir=$work/data" "run_dir=$run" \
    seed=42 trainer.max_steps=400 "trainer.steps_per_call=$k" "$@"
}

lmp_run() {  # lmp_run <W>: stage 1 at W ranks, held against W = 1's
  local w=$1
  # lmp_config.yaml: batch 32, val_percentage 0.2, rollouts every 2 epochs
  timed "play_lmp_fake_w$w" train "$w" play_lmp_fake "$work/lmp_w$w" 16 \
    datamodule.val_percentage=0.2 callbacks.rollout.every_n_epochs=2
  ms_per_step "$work/lmp_w$w/metrics.jsonl" "play_lmp_fake_w$w"
  cp "$work/lmp_w$w/metrics.jsonl" "$out/play_lmp_fake_w$w.metrics.jsonl"
  against_w1 "$work/lmp_w$w/metrics.jsonl" "$work/lmp_w1/metrics.jsonl" "play_lmp_fake_w$w"
  weights_against_w1 "$work/lmp_w$w" "$work/lmp_w1" "play_lmp_fake_w$w"
}

tacorl_run() {  # tacorl_run <W>: stage 2 at W ranks, held against W = 1's
  local w=$1
  # tacorl_config.yaml: grafted from stage 1 (its W = 1 run), rollout_lh every 4 epochs
  timed "tacorl_fake_w$w" train "$w" tacorl_fake "$work/tacorl_w$w" 8 \
    "play_lmp_dir=$work/lmp_w1" callbacks.rollout_lh.every_n_epochs=4
  ms_per_step "$work/tacorl_w$w/metrics.jsonl" "tacorl_fake_w$w"
  cp "$work/tacorl_w$w/metrics.jsonl" "$out/tacorl_fake_w$w.metrics.jsonl"
  against_w1 "$work/tacorl_w$w/metrics.jsonl" "$work/tacorl_w1/metrics.jsonl" "tacorl_fake_w$w"
  weights_against_w1 "$work/tacorl_w$w" "$work/tacorl_w1" "tacorl_fake_w$w"
}

case "$mode" in
  time)
    timed make_flagship_data python -m tacorl_tpu_torch.make_flagship_data "$work/data"
    for w in 1 2 4; do lmp_run "$w"; done
    for w in 1 2 4; do tacorl_run "$w"; done
    ;;
  tacorl)
    timed make_flagship_data python -m tacorl_tpu_torch.make_flagship_data "$work/data"
    lmp_run 1
    for w in 1 2 4; do tacorl_run "$w"; done
    ;;
  lmp)
    timed make_flagship_data python -m tacorl_tpu_torch.make_flagship_data "$work/data"
    for w in 1 2 4; do lmp_run "$w"; done
    ;;
  steps)
    python -c "from tacorl_tpu_torch.data.expert_play import generate_expert_play as g; g('$work/play', 8, 2, seed=3)"
    for w in 1 2; do
      timed "steps_w$w" python -m torch.distributed.run --standalone --nproc_per_node="$w" "$here/probe.py" \
        experiment=play_lmp_fake "data_dir=$work/play" "run_dir=$work/steps_w$w" seed=42 trainer.max_steps=8 \
        trainer.steps_per_call=2 trainer.log_every_n_steps=1 callbacks.rollout.every_n_epochs=100
      cp "$work/steps_w$w/metrics.jsonl" "$out/steps_w$w.metrics.jsonl"
    done
    python - "$work/steps_w2/metrics.jsonl" "$work/steps_w1/metrics.jsonl" <<'PY' | tee -a "$out/walls.txt"
import json, sys
def rows(path):
    return {r["step"]: r for r in map(json.loads, open(path)) if any(k.startswith("train/") for k in r)}
got, want = rows(sys.argv[1]), rows(sys.argv[2])
for step in sorted(want):
    errs = {k: abs(got[step][k] - want[step][k]) / max(abs(want[step][k]), 1e-6) for k in want[step] if k.startswith("train/")}
    worst = max(errs, key=errs.get)
    print(f"steps W=2 vs W=1 at step {step}: largest relative difference {errs[worst]:.3g} ({worst})")
PY
    ;;
  *)
    echo "unknown mode $mode" >&2
    exit 2
    ;;
esac
