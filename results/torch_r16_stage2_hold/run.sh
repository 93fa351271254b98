#!/usr/bin/env bash
# Stage 2 of the visual TACO-RL hierarchy held past its decline: the
# recipes and modes of results/torch_r15_visual/run.sh (the flagship set,
# play_lmp_fake at K = 16 for 15,000 steps, tacorl_fake grafted from its
# latest step at K = 8), with what that run left open measured.
#
#   bash results/torch_r16_stage2_hold/run.sh hold <out> [steps]       # data + stage 1 + stage 2 graphed with every
#                                                                       # firing recorded (firings.py), then eager at the
#                                                                       # same K with capturable Adam (hold.py) beside the
#                                                                       # graphed run with a capture after every firing,
#                                                                       # to [4648] steps
#   bash results/torch_r16_stage2_hold/run.sh variants <out> <stage-1 run>  # data + stage 2 for 6,000 steps with
#                                                                       # cuDNN's TF32 off, and at seeds 43 and 44
#   bash results/torch_r16_stage2_hold/run.sh precision <out>          # data + stage 1 + stage 2 for 6,000 steps with
#                                                                       # float32 matmuls at precision high and medium
#                                                                       # (matmul_precision.py), side by side
#   bash results/torch_r16_stage2_hold/run.sh bf16 <out>               # data + stage 1 + stage 2 for 6,000 steps with
#                                                                       # bfloat16-input dense layers (bf16_dense.py) at
#                                                                       # seeds 42 and 43, side by side
#   bash results/torch_r16_stage2_hold/run.sh lhseq3 <out> <stage-1 run>    # data + long_horizon_sequential depth 3
#                                                                       # on each kept stage-1 checkpoint
#   bash results/torch_r16_stage2_hold/run.sh all <out> [steps]        # hold, its eager run beside the other graphed
#                                                                       # run, the variants and the depth-3 scores
#   bash results/torch_r16_stage2_hold/run.sh run <out>                # = results/torch_r15_visual/run.sh run
#
# <out> receives card.txt and torch.txt (as r15's), walls.txt, each
# command's log, each run's metrics.jsonl (tacorl_<name>_metrics.jsonl),
# the graphed runs' firing records (firings_<name>.jsonl), the holds
# (hold.txt) and the scores (lmp_lhseq3_<step>.json). The eager run shares
# the card and the host's cores with what runs beside it, so the walls of
# that part are not the runs' own.
set -euo pipefail
mode=$1
out=$(realpath -m "$2")
here=$(dirname "$(realpath "$0")")
r15=$(realpath "$here/../torch_r15_visual")
if [ "$mode" = run ]; then
  exec bash "$r15/run.sh" run "$out"
fi
export PYTHONPATH="$(realpath "$here/../..")${PYTHONPATH:+:$PYTHONPATH}"  # the scripts import the port
work=${TMPDIR:-/tmp}/torch_r16_stage2_hold
rm -rf "$work"
mkdir -p "$out" "$work"
data=$work/data

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/card.txt"
python -c 'import torch; print("torch", torch.__version__, "cuda", torch.version.cuda,
  "matmul allow_tf32", torch.backends.cuda.matmul.allow_tf32, "cudnn allow_tf32", torch.backends.cudnn.allow_tf32)' \
  | tee "$out/torch.txt"

timed() {  # timed <label> <command...>: as r15's run.sh
  local label=$1; shift
  local t0; t0=$(date +%s.%N)
  "$@" > "$out/$label.log" 2>&1 || { tail -n 40 "$out/$label.log"; exit 1; }
  tail -n 2 "$out/$label.log"
  awk -v a="$t0" -v b="$(date +%s.%N)" -v l="$label" 'BEGIN { printf "%s %.1f\n", l, b - a }' \
    | tee -a "$out/walls.txt"
}

# results/torch_r15_visual/run.sh's recipes, unchanged
lmp_args=(experiment=play_lmp_fake "data_dir=$data" seed=42 datamodule.batch_size=32
  datamodule.val_percentage=0.2 callbacks.rollout.every_n_epochs=2 trainer.steps_per_call=16)
rl_args=(experiment=tacorl_fake "data_dir=$data" callbacks.rollout_lh.every_n_epochs=4
  trainer.steps_per_call=8 datamodule.dataset.goal_sampling_prob=0.4
  datamodule.dataset.goal_strategy_prob.geometric=0.7 datamodule.dataset.goal_strategy_prob.similar_robot_obs=0.3)

keep() {  # keep <name> <run dir> <log>: its metrics, captures and rollouts in <out>
  cp "$2/metrics.jsonl" "$out/tacorl_$1_metrics.jsonl"
  grep -o 'epoch [0-9]*: [0-9]* steps in .*' "$3" > "$out/tacorl_$1_captures.txt" || true
  python - "$1" "$2/metrics.jsonl" <<'PY' | tee -a "$out/rollouts.txt"
import json, sys
rows = [json.loads(line) for line in open(sys.argv[2])]
acc = [(r["step"], round(r["val_accuracy"], 4)) for r in rows if "val_accuracy" in r]
print(f"{sys.argv[1]}: val_accuracy {acc}")
for key in ("q1_loss", "bellman_q1_loss", "conservative_q1_gap"):
    by_epoch = {}
    for r in rows:
        if f"train/{key}" in r:
            by_epoch.setdefault((r["step"] - 1) // 664, []).append(r[f"train/{key}"])
    print(f"{sys.argv[1]}: per-epoch mean train/{key} {[round(sum(v) / len(v), 3) for _, v in sorted(by_epoch.items())]}")
PY
}

hold() {  # hold <steps>
  local steps=$1
  timed train_lmp python -m tacorl_tpu_torch.train "${lmp_args[@]}" "run_dir=$work/lmp" trainer.max_steps=15000
  ls "$work/lmp/ckpts" | grep -E '^[0-9]+$' | sort -n | tr '\n' ' ' | sed 's/^/kept checkpoint steps: /' \
    | tee "$out/lmp_kept.txt"; echo
  cp "$work/lmp/metrics.jsonl" "$out/lmp_metrics.jsonl"
  timed train_tacorl python "$here/firings.py" "$out/firings_graphed.jsonl" "${rl_args[@]}" seed=42 \
    "play_lmp_dir=$work/lmp" "run_dir=$work/rl" "trainer.max_steps=$steps"
  keep graphed "$work/rl" "$out/train_tacorl.log"
}

hold_rest() {  # hold_rest <steps>: the graphed run with a capture after every firing
  local steps=$1
  timed train_tacorl_capture python "$here/firings.py" "$out/firings_capture.jsonl" --capture-after-firings \
    "${rl_args[@]}" seed=42 "play_lmp_dir=$work/lmp" "run_dir=$work/rl_capture" "trainer.max_steps=$steps"
  keep capture "$work/rl_capture" "$out/train_tacorl_capture.log"
  python "$here/compare.py" "graphed vs graphed with a capture after every firing" "$work/rl" "$work/rl_capture" \
    | tee -a "$out/hold.txt"
}

eager() {  # eager <steps>: every step eager at the graphed run's K (hold.py)
  local steps=$1
  timed hold_eager python "$here/hold.py" "$work/rl" "$work/rl_eager" "${rl_args[@]}" seed=42 \
    "play_lmp_dir=$work/lmp" "trainer.max_steps=$steps"
  keep eager "$work/rl_eager" "$out/hold_eager.log"
  grep -h '^hold: ' "$out/hold_eager.log" | tee -a "$out/hold.txt"
}

variants() {  # variants <stage-1 run>: stage 2 for 6,000 steps, cuDNN's TF32 off, then seeds 43 and 44
  local lmp=$1
  timed train_tacorl_tf32_off python "$here/tf32_off.py" "${rl_args[@]}" seed=42 "play_lmp_dir=$lmp" \
    "run_dir=$work/rl_tf32_off" trainer.max_steps=6000
  keep tf32_off "$work/rl_tf32_off" "$out/train_tacorl_tf32_off.log"
  for seed in 43 44; do
    timed "train_tacorl_seed$seed" python -m tacorl_tpu_torch.train "${rl_args[@]}" "seed=$seed" \
      "play_lmp_dir=$lmp" "run_dir=$work/rl_seed$seed" trainer.max_steps=6000
    keep "seed$seed" "$work/rl_seed$seed" "$out/train_tacorl_seed$seed.log"
  done
}

precision() {  # precision <stage-1 run>: stage 2 for 6,000 steps at matmul precision high and medium, side by side
  local lmp=$1 p pids=()
  for p in high medium; do
    ( timed "train_tacorl_matmul_$p" python "$here/matmul_precision.py" "$p" "${rl_args[@]}" seed=42 \
        "play_lmp_dir=$lmp" "run_dir=$work/rl_matmul_$p" trainer.max_steps=6000
      head -n 1 "$out/train_tacorl_matmul_$p.log"
      keep "matmul_$p" "$work/rl_matmul_$p" "$out/train_tacorl_matmul_$p.log" ) &
    pids+=($!)
  done
  for p in "${pids[@]}"; do wait "$p"; done
}

bf16() {  # bf16 <stage-1 run>: stage 2 for 6,000 steps with bfloat16-input dense layers, seeds 42 and 43 side by side
  local lmp=$1 seed pids=()
  for seed in 42 43; do
    ( timed "train_tacorl_bf16_seed$seed" python "$here/bf16_dense.py" "${rl_args[@]}" "seed=$seed" \
        "play_lmp_dir=$lmp" "run_dir=$work/rl_bf16_seed$seed" trainer.max_steps=6000
      head -n 1 "$out/train_tacorl_bf16_seed$seed.log"
      keep "bf16_seed$seed" "$work/rl_bf16_seed$seed" "$out/train_tacorl_bf16_seed$seed.log" ) &
    pids+=($!)
  done
  for seed in "${pids[@]}"; do wait "$seed"; done
}

lhseq3() {  # lhseq3 <stage-1 run>: r15's sequential depth-3 protocol on every kept checkpoint
  local lmp=$1 step
  for step in $(ls "$lmp/ckpts" | grep -E '^[0-9]+$' | sort -n); do
    timed "eval_lmp_lhseq3_$step" python -m tacorl_tpu_torch.evaluate "module_path=$lmp" "epoch=$step" \
      "data_dir=$data/validation" env=fake_calvin env.image_hw=64 env.max_episode_steps=112 env.task_set=hard \
      min_seq_len=1 max_seq_len=400 plan_duration=4 eval_type=long_horizon_sequential \
      lh_seq_tasks_per_rollout=3 max_rollouts=1000 "filename=$out/lmp_lhseq3_$step.json"
    python -c 'import json, sys; d = json.load(open(sys.argv[1])); print(sys.argv[2], json.dumps({k: v for k, v in d.items() if not isinstance(v, (dict, list))}))' \
      "$out/lmp_lhseq3_$step.json" "lmp lhseq3 at step $step:" | tee -a "$out/scores.txt"
  done
}

timed make_flagship_data python -m tacorl_tpu_torch.make_flagship_data "$data"

case "$mode" in
  hold)
    steps=${3:-4648}
    hold "$steps"
    eager "$steps" > "$out/eager.out" 2>&1 &
    pid=$!
    hold_rest "$steps"
    wait "$pid" || { cat "$out/eager.out"; exit 1; }
    cat "$out/eager.out"
    ;;
  variants)
    variants "$(realpath "$3")"
    ;;
  lhseq3)
    lhseq3 "$(realpath "$3")"
    ;;
  bf16)
    timed train_lmp python -m tacorl_tpu_torch.train "${lmp_args[@]}" "run_dir=$work/lmp" trainer.max_steps=15000
    bf16 "$work/lmp"
    ;;
  precision)
    timed train_lmp python -m tacorl_tpu_torch.train "${lmp_args[@]}" "run_dir=$work/lmp" trainer.max_steps=15000
    precision "$work/lmp"
    ;;
  all)
    steps=${3:-4648}
    hold "$steps"
    eager "$steps" > "$out/eager.out" 2>&1 &
    pid=$!
    hold_rest "$steps"
    variants "$work/lmp"
    lhseq3 "$work/lmp"
    wait "$pid" || { cat "$out/eager.out"; exit 1; }
    cat "$out/eager.out"
    ;;
  *)
    echo "unknown mode $mode" >&2
    exit 2
    ;;
esac
