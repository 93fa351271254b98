#!/usr/bin/env bash
# Relay Imitation Learning on robot_obs/scene_obs vectors
# (experiment=ril_fake_state) trained with the PyTorch port on one GPU on the
# flagship expert-play set, with results/r5_train_to_success/ril2_config.yaml's
# values, then scored by python -m tacorl_tpu_torch.evaluate_ril_oracle with
# the oracle high level and with the learned one (lookahead 8, plan_duration
# 8, 12 rollouts a task).
#
#   bash results/torch_r8_ril/run.sh time <out_dir>          # data + 300 timed steps + rollout rates
#   bash results/torch_r8_ril/run.sh run <out_dir> [seed]    # data + 16,000 steps + both scores
#
# <out_dir> receives the card's name and power limit, the torch versions and
# TF32 settings, the wall time of each command (walls.txt), and for `run`
# the run's metrics.jsonl, its composed config.json, the kept checkpoints'
# monitored values and both eval JSONs.
set -euo pipefail
mode=$1
out=$(realpath -m "$2")
seed=${3:-42}
work=${TMPDIR:-/tmp}/torch_r8_ril
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

timed make_flagship_data python -m tacorl_tpu_torch.make_flagship_data "$work/data"

# ril2_config.yaml: batch 32, val_percentage 1.0, windows 8 / 80 and the
# 3 x 512 / 64-d recipe are experiment=ril_fake_state's own; steps_per_call
# stays 1 (the port runs single steps)
train_args=(experiment=ril_fake_state "data_dir=$work/data" "run_dir=$work/run" "seed=$seed"
            callbacks.rollout.every_n_epochs=4)
score_args=("module_path=$work/run" "data_dir=$work/data/validation" env.image_hw=64
            env.max_episode_steps=56 env.task_set=hard "env.modalities=[robot_obs,scene_obs]"
            "env.goal_modalities=[robot_obs,scene_obs]" min_seq_len=1 max_seq_len=64
            lookahead=8 plan_duration=8)

if [ "$mode" = time ]; then
  # 300 steps, then the validation pass and one in-training evaluation
  # (3 rollouts a task) of the partial epoch 0
  timed train_300_steps python -m tacorl_tpu_torch.train "${train_args[@]}" trainer.max_steps=300
  python - "$work/run/metrics.jsonl" <<'EOF' | tee -a "$out/walls.txt"
import json, sys
rows = [json.loads(line) for line in open(sys.argv[1]) if '"train/' in line]
a, b = rows[0], rows[-1]
print(f"ms_per_step_{a['step']}_to_{b['step']} {(b['time'] - a['time']) * 1e3 / (b['step'] - a['step']):.3f}")
EOF
  timed oracle_3_rollouts python -m tacorl_tpu_torch.evaluate_ril_oracle "${score_args[@]}" \
    max_rollouts=3 "filename=$out/oracle_3.json"
  timed learned_3_rollouts python -m tacorl_tpu_torch.evaluate_ril_oracle "${score_args[@]}" \
    max_rollouts=3 learned_hl=true "filename=$out/learned_3.json"
  exit 0
fi

timed train python -m tacorl_tpu_torch.train "${train_args[@]}" trainer.max_steps=16000
cp "$work/run/metrics.jsonl" "$work/run/config.json" "$out/"
cp "$work/run/ckpts/metrics.json" "$out/kept_checkpoints.json"
# the latest step (16,000), as scripts/evaluate_ril_oracle.py scores by default
timed oracle python -m tacorl_tpu_torch.evaluate_ril_oracle "${score_args[@]}" max_rollouts=12 \
  "filename=$out/ril_oracle.json"
timed learned python -m tacorl_tpu_torch.evaluate_ril_oracle "${score_args[@]}" max_rollouts=12 \
  learned_hl=true "filename=$out/ril_learned.json"
