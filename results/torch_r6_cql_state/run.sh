#!/usr/bin/env bash
# Flat goal-conditioned CQL (experiment=cql_fake_state) trained to task
# success with the PyTorch port on one GPU, on the flagship expert-play set,
# then the best checkpoint scored over all 160 validation spans.
#
#   bash results/torch_r6_cql_state/run.sh time <out_dir>          # data + 300 timed steps
#   bash results/torch_r6_cql_state/run.sh run <out_dir> [seed]    # data + 15,600 steps + evaluate
#
# <out_dir> receives the card's name and power limit, the torch versions and
# TF32 settings, the wall time of each command (walls.txt), and for `run`
# the run's metrics.jsonl, its composed config.json and the eval JSON.
set -euo pipefail
mode=$1
out=$(realpath -m "$2")
seed=${3:-42}
work=${TMPDIR:-/tmp}/torch_r6_cql_state
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
  tail -n 3 "$out/$label.log"
  awk -v a="$t0" -v b="$(date +%s.%N)" -v l="$label" 'BEGIN { printf "%s %.1f\n", l, b - a }' \
    | tee -a "$out/walls.txt"
}

timed make_flagship_data python -m tacorl_tpu_torch.make_flagship_data "$work/data"

train_args=(experiment=cql_fake_state "data_dir=$work/data" "run_dir=$work/run" "seed=$seed")
if [ "$mode" = time ]; then
  timed train_300_steps python -m tacorl_tpu_torch.train "${train_args[@]}" trainer.max_steps=300
  python - "$work/run/metrics.jsonl" <<'EOF' | tee -a "$out/walls.txt"
import json, sys
rows = [json.loads(line) for line in open(sys.argv[1]) if "train/q1_loss" in line]
(a, b) = rows[0], rows[-1]
print(f"ms_per_step_{a['step']}_to_{b['step']} {(b['time'] - a['time']) * 1e3 / (b['step'] - a['step']):.3f}")
EOF
  exit 0
fi

timed train python -m tacorl_tpu_torch.train "${train_args[@]}" trainer.max_steps=15600
cp "$work/run/metrics.jsonl" "$work/run/config.json" "$out/"
timed evaluate python -m tacorl_tpu_torch.evaluate "module_path=$work/run" epoch=best \
  eval_type=short_horizon "data_dir=$work/data/validation" env.image_hw=64 \
  env.max_episode_steps=56 env.task_set=hard "env.modalities=[robot_obs,scene_obs]" \
  "env.goal_modalities=[robot_obs,scene_obs]" min_seq_len=1 max_seq_len=64 max_rollouts=40 \
  "filename=$out/cql_state_eval_best.json"
