#!/usr/bin/env bash
# The D4RL branch's two-stage hierarchy (experiment=play_lmp_d4rl_fake, then
# experiment=tacorl_d4rl_fake grafted from it) trained to task success with
# the PyTorch port on one GPU, on the fake point-mass expert set, then three
# 100-rollout scores with python -m tacorl_tpu_torch.evaluate_d4rl.
#
#   bash results/torch_r7_d4rl/run.sh time <out_dir>          # data + 300 timed steps a stage + rollout rates
#   bash results/torch_r7_d4rl/run.sh run <out_dir> [seed]    # data + 8,000 + 3,000 steps + 3 scores
#
# <out_dir> receives the card's name and power limit, the torch versions and
# TF32 settings, the wall time of each command (walls.txt), and for `run`
# each stage's metrics.jsonl and composed config.json and the eval JSONs.
set -euo pipefail
mode=$1
out=$(realpath -m "$2")
seed=${3:-42}
work=${TMPDIR:-/tmp}/torch_r7_d4rl
rm -rf "$work"
mkdir -p "$out" "$work"

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/card.txt"
python -c 'import torch; print("torch", torch.__version__, "cuda", torch.version.cuda,
  "matmul allow_tf32", torch.backends.cuda.matmul.allow_tf32, "cudnn allow_tf32", torch.backends.cudnn.allow_tf32)' \
  | tee "$out/torch.txt"

timed() {  # timed <label> <command...>: runs it with its output in <label>.log,
           # and appends "<label> <seconds>" to walls.txt
  local label=$1; shift
  local t0; t0=$(date +%s.%N)
  "$@" > "$out/$label.log" 2>&1 || { tail -n 40 "$out/$label.log"; exit 1; }
  tail -n 2 "$out/$label.log"
  awk -v a="$t0" -v b="$(date +%s.%N)" -v l="$label" 'BEGIN { printf "%s %.1f\n", l, b - a }' \
    | tee -a "$out/walls.txt"
}

data=$work/expert.npz
timed make_data python -c "from tacorl_tpu_torch.data.d4rl_dataset import generate_expert_d4rl as g; \
g('$data', n_episodes=40, legs_per_episode=4, seed=0)"

lmp=(experiment=play_lmp_d4rl_fake "dataset_path=$data" "run_dir=$work/lmp" "seed=$seed")
rl=(experiment=tacorl_d4rl_fake "dataset_path=$data" "play_lmp_dir=$work/lmp" "run_dir=$work/rl" "seed=$seed")

ms_per_step() {  # ms_per_step <label> <metrics.jsonl>: the host clock between the first and last train rows
  python - "$1" "$2" <<'EOF' | tee -a "$out/walls.txt"
import json, sys
rows = [json.loads(line) for line in open(sys.argv[2]) if '"train/' in line]
a, b = rows[0], rows[-1]
print(f"{sys.argv[1]}_ms_per_step_{a['step']}_to_{b['step']} {(b['time'] - a['time']) * 1e3 / (b['step'] - a['step']):.3f}")
EOF
}

if [ "$mode" = time ]; then
  # steps alone: the rollout monitor fires at epoch 0 only
  timed lmp_300_steps python -m tacorl_tpu_torch.train "${lmp[@]}" trainer.max_steps=300 \
    callbacks.rollout.every_n_epochs=100000
  ms_per_step lmp "$work/lmp/metrics.jsonl"
  timed rl_300_steps python -m tacorl_tpu_torch.train "${rl[@]}" trainer.max_steps=300 \
    callbacks.rollout.every_n_epochs=100000
  ms_per_step rl "$work/rl/metrics.jsonl"
  # rollout rates: 20 episodes of 60 steps at most, as one in-training evaluation
  timed lmp_20_rollouts python -m tacorl_tpu_torch.evaluate_d4rl "module_path=$work/lmp" \
    num_rollouts=20 plan_duration=8 "filename=$out/lmp_20.json"
  timed rl_20_rollouts python -m tacorl_tpu_torch.evaluate_d4rl "module_path=$work/rl" \
    num_rollouts=20 plan_duration=8 "filename=$out/rl_20.json"
  exit 0
fi

# stage 1: tests/test_train_to_success_d4rl.py:47-58 with single-step dispatch
timed train_lmp python -m tacorl_tpu_torch.train "${lmp[@]}" trainer.max_steps=8000 \
  callbacks.rollout.every_n_epochs=5
cp "$work/lmp/metrics.jsonl" "$out/lmp_metrics.jsonl"
cp "$work/lmp/config.json" "$out/lmp_config.json"
# stage 2 grafts from stage 1's latest step (lmp_epoch_to_load: -1)
timed train_tacorl python -m tacorl_tpu_torch.train "${rl[@]}" trainer.max_steps=3000
cp "$work/rl/metrics.jsonl" "$out/tacorl_metrics.jsonl"
cp "$work/rl/config.json" "$out/tacorl_config.json"
# plan_duration: the configs/evaluate_d4rl.yaml default, 15
timed eval_lmp_best python -m tacorl_tpu_torch.evaluate_d4rl "module_path=$work/lmp" epoch=best \
  num_rollouts=100 "filename=$out/d4rl_lmp_eval_best.json"
timed eval_tacorl_best python -m tacorl_tpu_torch.evaluate_d4rl "module_path=$work/rl" epoch=best \
  num_rollouts=100 "filename=$out/d4rl_tacorl_eval_best.json"
timed eval_tacorl_final python -m tacorl_tpu_torch.evaluate_d4rl "module_path=$work/rl" epoch=3000 \
  num_rollouts=100 "filename=$out/d4rl_tacorl_eval_final.json"
python - "$work/lmp" "$work/rl" <<'EOF' | tee "$out/best_steps.txt"
import json, sys
for run in sys.argv[1:]:
    cfg = json.loads(open(f"{run}/config.json").read())
    metrics = json.loads(open(f"{run}/ckpts/metrics.json").read())
    print(cfg["experiment_name"], "kept", sorted(int(s) for s in metrics), "monitored", metrics)
EOF
