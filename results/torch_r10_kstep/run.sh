#!/usr/bin/env bash
# The visual hierarchy's recipes (results/r5_train_to_success/lmp_config.yaml
# and tacorl_config.yaml) timed on one GPU with the PyTorch port, at the
# archived K-step dispatch (trainer.steps_per_call 16 for stage 1, 8 for
# stage 2: CUDA-graph replays of the train step) beside K = 1, on the
# flagship expert-play set.
#
#   bash results/torch_r10_kstep/run.sh time <out_dir>   # 400 steps of each stage at each K
#
# <out_dir> receives the card's name and power limit (card.txt), the torch
# versions and TF32 settings (torch.txt), and walls.txt: the wall time of
# each command and its ms a step between the train rows logged at steps 80
# and 400 (both inside the first epoch: no validation, rollout or save in
# between; the K-step runs' first chunk, with the graph's capture, before).
set -euo pipefail
mode=$1
out=$(realpath -m "$2")
work=${TMPDIR:-/tmp}/torch_r10_kstep
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

ms_per_step() {  # ms a step between the train rows of steps 80 and 400
  python - "$1" "$2" <<'PY' | tee -a "$out/walls.txt"
import json, sys
rows = {r["step"]: r for r in map(json.loads, open(sys.argv[1])) if any(k.startswith("train/") for k in r)}
a, b = rows[80], rows[400]
print(f"{sys.argv[2]} ms_per_step_80_to_400 {(b['time'] - a['time']) * 1e3 / 320:.3f}")
PY
}

train() {  # train <experiment> <run dir> <K> [overrides...]
  local experiment=$1 run=$2 k=$3; shift 3
  python -m tacorl_tpu_torch.train "experiment=$experiment" "data_dir=$work/data" "run_dir=$run" \
    seed=42 trainer.max_steps=400 "trainer.steps_per_call=$k" "$@"
}

case "$mode" in
  time)
    timed make_flagship_data python -m tacorl_tpu_torch.make_flagship_data "$work/data"
    # lmp_config.yaml: batch 32, val_percentage 0.2, rollouts every 2 epochs
    for k in 1 16; do
      timed "play_lmp_fake_k$k" train play_lmp_fake "$work/lmp_k$k" "$k" \
        datamodule.val_percentage=0.2 callbacks.rollout.every_n_epochs=2
      ms_per_step "$work/lmp_k$k/metrics.jsonl" "play_lmp_fake_k$k"
    done
    # tacorl_config.yaml: grafted from stage 1 (here its 400-step run), rollout_lh every 4 epochs
    for k in 1 8; do
      timed "tacorl_fake_k$k" train tacorl_fake "$work/tacorl_k$k" "$k" \
        "play_lmp_dir=$work/lmp_k1" callbacks.rollout_lh.every_n_epochs=4
      ms_per_step "$work/tacorl_k$k/metrics.jsonl" "tacorl_fake_k$k"
    done
    ;;
  *)
    echo "unknown mode $mode" >&2
    exit 2
    ;;
esac
