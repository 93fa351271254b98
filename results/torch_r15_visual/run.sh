#!/usr/bin/env bash
# The visual TACO-RL hierarchy trained to task success with the PyTorch port
# on one GPU, on the flagship expert-play set: experiment=play_lmp_fake
# (stage 1), then experiment=tacorl_fake grafted from stage 1's latest step
# (stage 2), each at the values of its archived recipe
# (results/r5_train_to_success/lmp_config.yaml, tacorl_config.yaml) and at
# the archived K-step dispatch (16 and 8 CUDA-graph replays a call), then
# each stage's best checkpoint scored with the three goal-image protocols
# of tests/test_train_to_success.py:_lh_eval (single-task over all 160
# validation spans, long_horizon depth 2 over 120 chains,
# long_horizon_sequential depth 3 over 80 chains).
#
#   bash results/torch_r15_visual/run.sh time <out>                          # data + 400 timed steps of each stage
#   bash results/torch_r15_visual/run.sh stage1 <out>                        # data + stage 1 (15,000 steps)
#   bash results/torch_r15_visual/run.sh stage2 <out> <stage-1 run>          # data + stage 2 (6,000 steps)
#   bash results/torch_r15_visual/run.sh score <out> <stage-1 run> <stage-2 run>  # data + the six scores
#   bash results/torch_r15_visual/run.sh run <out>                           # all three in one call
#   bash results/torch_r15_visual/run.sh hold <out> [steps]                  # data + stage 1 + stage 2 graphed
#                                                                            # and eager for [6000] steps,
#                                                                            # row by row (hold.py)
#
# <out> receives the card's name and power limit (card.txt), the torch
# versions and TF32 settings (torch.txt: torch's defaults, as
# python -m tacorl_tpu_torch.train leaves them), each command's wall time
# and ms a step (walls.txt), each command's log, and per stage its
# metrics.jsonl and composed config.json (lmp_*, tacorl_*), the step
# graph's captures at each epoch end (<stage>_captures.txt) and its kept
# checkpoint steps (in modes stage1 and stage2 also a copy of its run
# directory, <stage>_run: the checkpoints a later call's stage2 or score
# reads), and the eval JSONs
# (lmp_* and taco_*, named as the archive names them). Every headline line
# goes to the output too.
set -euo pipefail
mode=$1
out=$(realpath -m "$2")
here=$(dirname "$(realpath "$0")")
export PYTHONPATH="$(realpath "$here/../..")${PYTHONPATH:+:$PYTHONPATH}"  # hold.py imports the port
work=${TMPDIR:-/tmp}/torch_r15_visual
rm -rf "$work"
mkdir -p "$out" "$work"
data=$work/data

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

# stage 1: lmp_config.yaml's values; the composed play_lmp_fake config
# differs from it in no other key (tests/test_torch_archived_evidence.py)
lmp_args=(experiment=play_lmp_fake "data_dir=$data" seed=42 datamodule.batch_size=32
  datamodule.val_percentage=0.2 callbacks.rollout.every_n_epochs=2 trainer.steps_per_call=16)
# stage 2: tacorl_config.yaml's values, the relabelling probabilities of
# the archived run among them (configs/datamodule/tacorl.yaml has 0.3,
# 0.5 / 0.5); it grafts stage 1's latest step (lmp_epoch_to_load: -1)
rl_args=(experiment=tacorl_fake "data_dir=$data" seed=42 callbacks.rollout_lh.every_n_epochs=4
  trainer.steps_per_call=8 datamodule.dataset.goal_sampling_prob=0.4
  datamodule.dataset.goal_strategy_prob.geometric=0.7 datamodule.dataset.goal_strategy_prob.similar_robot_obs=0.3)

ms_per_step() {  # ms_per_step <label> <run dir> <from> <to>: ms a step between two train rows
  python - "$1" "$2/metrics.jsonl" "$3" "$4" <<'PY' | tee -a "$out/walls.txt"
import json, sys
label, path, a, b = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
rows = {r["step"]: r for r in map(json.loads, open(path)) if any(k.startswith("train/") for k in r)}
print(f"{label} ms_per_step_{a}_to_{b} {(rows[b]['time'] - rows[a]['time']) * 1e3 / (b - a):.3f}")
PY
}

summary() {  # summary <stage> <run dir> <log>: keeps the run's files in <out>, prints its headline
  local stage=$1 run=$2 log=$3
  cp "$run/metrics.jsonl" "$out/${stage}_metrics.jsonl"
  cp "$run/config.json" "$out/${stage}_config.json"
  grep -o 'epoch [0-9]*: [0-9]* steps in .*' "$log" | tee "$out/${stage}_captures.txt"
  ls "$run/ckpts" | grep -E '^[0-9]+$' | sort -n | tr '\n' ' ' | sed 's/^/kept checkpoint steps: /' | tee "$out/${stage}_kept.txt"
  echo
  python - "$stage" "$run/metrics.jsonl" <<'PY'
import json, sys
rows = [json.loads(line) for line in open(sys.argv[2])]
acc = [(r["step"], r["val_accuracy"]) for r in rows if "val_accuracy" in r]
step, best = max(acc, key=lambda sa: sa[1])
print(f"{sys.argv[1]}: best val_accuracy {best:.4f} at step {step} (first of its value); "
      f"every evaluation: {[(s, round(a, 4)) for s, a in acc]}")
lh = [(r["step"], r["LH_1_accuracy"], r["LH_2_accuracy"]) for r in rows if "LH_2_accuracy" in r]
if lh:
    print(f"{sys.argv[1]}: rollout_lh (step, LH_1, LH_2): {lh}")
PY
  if [ "$mode" = stage1 ] || [ "$mode" = stage2 ]; then  # the checkpoints a later call reads
    rm -rf "$out/${stage}_run"
    cp -r "$run" "$out/${stage}_run"
  fi
}

score() {  # score <stage> <run dir> <plan_duration>: the three protocols on the best checkpoint
  local stage=$1 run=$2 plan=$3
  local common=("module_path=$run" epoch=best "data_dir=$data/validation" env=fake_calvin env.image_hw=64
    env.max_episode_steps=112 env.task_set=hard min_seq_len=1 max_seq_len=400 "plan_duration=$plan")
  timed "eval_${stage}_single" python -m tacorl_tpu_torch.evaluate "${common[@]}" eval_type=short_horizon \
    "filename=$out/${stage}_eval_best.json"
  timed "eval_${stage}_lh2" python -m tacorl_tpu_torch.evaluate "${common[@]}" eval_type=long_horizon \
    lh_tasks_per_rollout=2 max_rollouts=1000 "filename=$out/${stage}_lh2.json"
  timed "eval_${stage}_lhseq3" python -m tacorl_tpu_torch.evaluate "${common[@]}" \
    eval_type=long_horizon_sequential lh_seq_tasks_per_rollout=3 max_rollouts=1000 "filename=$out/${stage}_lhseq3.json"
  python - "$stage" "$out" <<'PY'
import json, sys
stage, out = sys.argv[1], sys.argv[2]
single = json.load(open(f"{out}/{stage}_eval_best.json"))
n = sum(v["num_rollouts"] for v in single.values())
overall = sum(v["accuracy"] * v["num_rollouts"] for v in single.values()) / n
print(f"{stage} single-task over {n} spans: {overall:.4f} ({ {t: v['accuracy'] for t, v in single.items()} })")
for name in ("lh2", "lhseq3"):
    d = json.load(open(f"{out}/{stage}_{name}.json"))
    print(f"{stage} {name}: {json.dumps({k: v for k, v in d.items() if not isinstance(v, (dict, list))})}")
PY
}

stage1() {  # stage1 <run dir> [max_steps]
  timed train_lmp python -m tacorl_tpu_torch.train "${lmp_args[@]}" "run_dir=$1" "trainer.max_steps=${2:-15000}"
}

stage2() {  # stage2 <stage-1 run> <run dir> [max_steps]
  timed train_tacorl python -m tacorl_tpu_torch.train "${rl_args[@]}" "play_lmp_dir=$1" "run_dir=$2" \
    "trainer.max_steps=${3:-6000}"
}

timed make_flagship_data python -m tacorl_tpu_torch.make_flagship_data "$data"

case "$mode" in
  time)
    stage1 "$work/lmp" 400
    ms_per_step train_lmp "$work/lmp" 80 400
    stage2 "$work/lmp" "$work/rl" 400
    ms_per_step train_tacorl "$work/rl" 80 400
    ;;
  stage1)
    stage1 "$work/lmp"
    ms_per_step train_lmp "$work/lmp" 80 400
    summary lmp "$work/lmp" "$out/train_lmp.log"
    ;;
  stage2)
    lmp=$(realpath "$3")
    stage2 "$lmp" "$work/rl"
    ms_per_step train_tacorl "$work/rl" 80 400
    summary tacorl "$work/rl" "$out/train_tacorl.log"
    ;;
  score)
    score lmp "$(realpath "$3")" 4
    score taco "$(realpath "$4")" 8
    ;;
  run)
    stage1 "$work/lmp"
    ms_per_step train_lmp "$work/lmp" 80 400
    summary lmp "$work/lmp" "$out/train_lmp.log"
    stage2 "$work/lmp" "$work/rl"
    ms_per_step train_tacorl "$work/rl" 80 400
    summary tacorl "$work/rl" "$out/train_tacorl.log"
    score lmp "$work/lmp" 4
    score taco "$work/rl" 8
    ;;
  hold)
    steps=${3:-6000}
    stage1 "$work/lmp"
    summary lmp "$work/lmp" "$out/train_lmp.log"
    stage2 "$work/lmp" "$work/rl" "$steps"
    summary tacorl "$work/rl" "$out/train_tacorl.log"
    timed hold_eager python "$here/hold.py" "$work/rl" "$work/rl_eager" "${rl_args[@]}" "play_lmp_dir=$work/lmp" \
      "trainer.max_steps=$steps"
    grep -h '^hold: ' "$out/hold_eager.log" | tee -a "$out/walls.txt"
    cp "$work/rl_eager/metrics.jsonl" "$out/tacorl_eager_metrics.jsonl"
    ;;
  *)
    echo "unknown mode $mode" >&2
    exit 2
    ;;
esac
