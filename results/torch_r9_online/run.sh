#!/usr/bin/env bash
# Online CQL (experiment=cql_online_fake) and online SAC (sac_online_fake)
# on the dense-reward fake play table, trained with the PyTorch port on one
# GPU: the env stepped inside every train step, the replay buffer, the
# 500-step warm start and the plain-strategy rollout monitor, with the
# values of results/r5_train_to_success/cql_online_config.yaml and
# results/r4_train_to_success/sac_config.yaml (the experiments' own).
#
#   bash results/torch_r9_online/run.sh time <out_dir>            # 300 timed steps of each
#   bash results/torch_r9_online/run.sh run <out_dir> [seed]      # cql_online_fake, 20,000 steps
#   bash results/torch_r9_online/run.sh run_sac <out_dir> [seed]  # sac_online_fake, 12,000 steps
#
# <out_dir> receives the card's name and power limit, the torch versions and
# TF32 settings, the wall time of each command (walls.txt), and for the runs
# the run's metrics.jsonl, its composed config.json and the kept checkpoints'
# monitored values.
set -euo pipefail
mode=$1
out=$(realpath -m "$2")
seed=${3:-42}
work=${TMPDIR:-/tmp}/torch_r9_online
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

ms_per_step() {  # ms a step between the first and the last logged train rows
  python - "$1" "$2" <<'PY' | tee -a "$out/walls.txt"
import json, sys
rows = [json.loads(line) for line in open(sys.argv[1]) if '"train/' in line]
a, b = rows[0], rows[-1]
print(f"{sys.argv[2]} ms_per_step_{a['step']}_to_{b['step']} {(b['time'] - a['time']) * 1e3 / (b['step'] - a['step']):.3f}")
PY
}

train() {  # train <experiment> <steps> <run dir>
  python -m tacorl_tpu_torch.train "experiment=$1" "run_dir=$3" "seed=$seed" "trainer.max_steps=$2"
}

keep() {  # keep <run dir> <prefix>: the run's metrics, config and kept checkpoints
  cp "$1/metrics.jsonl" "$out/$2_metrics.jsonl"
  cp "$1/config.json" "$out/$2_config.json"
  cp "$1/ckpts/metrics.json" "$out/$2_kept_checkpoints.json"
}

case "$mode" in
  time)
    # 300 steps: the warm start, 250 steps, the rollout monitor, 50 more
    for experiment in cql_online_fake sac_online_fake; do
      timed "${experiment}_300_steps" train "$experiment" 300 "$work/$experiment"
      ms_per_step "$work/$experiment/metrics.jsonl" "$experiment"
    done
    ;;
  run)
    timed cql_online_fake train cql_online_fake 20000 "$work/cql"
    keep "$work/cql" cql_online_fake
    ;;
  run_sac)
    timed sac_online_fake train sac_online_fake 12000 "$work/sac"
    keep "$work/sac" sac_online_fake
    ;;
  *)
    echo "unknown mode $mode" >&2
    exit 2
    ;;
esac
