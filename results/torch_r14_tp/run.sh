#!/usr/bin/env bash
# Tensor parallelism over NCCL on the cards of one host (four):
#
#   bash results/torch_r14_tp/run.sh time <out_dir>
#
# 1. python -m tacorl_tpu_torch.dryrun --n-devices 4: the tiny Play-LMP at
#    (dp, mp) = (2, 2), one NCCL rank a card, then CQL, RIL, SAC and
#    TACO-RL replicated over mp;
# 2. the production Play-LMP step (tp_steps.py) at (dp, mp) = (1, 1) on one
#    card, then (4, 1), (2, 2) and (1, 4) on four, graphed at K = 16 (the
#    mp collectives captured in the step graph): ms/step, the NCCL kernels
#    in a replay's trace, and the gathered weights after step 50 against
#    (1, 1)'s (atol 2.5 lr a step).
#
# <out_dir> receives the cards' names and power limits (card.txt), the
# torch versions (torch.txt), each command's log, and walls.txt: every
# command's wall time and every headline line, which are also printed, so
# the command's own output holds them if <out_dir> is lost.
set -euo pipefail
mode=$1
out=$(realpath -m "$2")
here=$(dirname "$(realpath "$0")")
repo=$(realpath "$here/../..")
export PYTHONPATH="$repo${PYTHONPATH:+:$PYTHONPATH}"
work=$(mktemp -d)  # the gathered weights (50 MB a run) stay out of <out_dir>
trap 'rm -rf "$work"' EXIT
mkdir -p "$out"

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/card.txt"
python -c 'import torch; print("torch", torch.__version__, "cuda", torch.version.cuda, "cards", torch.cuda.device_count())' \
  | tee "$out/torch.txt"

timed() {  # timed <label> <command...>: its output in <label>.log, its headline lines and wall in walls.txt
  local label=$1; shift
  local t0; t0=$(date +%s.%N)
  "$@" > "$out/$label.log" 2>&1 || { tail -n 60 "$out/$label.log"; exit 1; }
  grep -h '^\[tp\]\|^dryrun_multichip' "$out/$label.log" | tee -a "$out/walls.txt" || true
  awk -v a="$t0" -v b="$(date +%s.%N)" -v l="$label" 'BEGIN { printf "%s %.1f s\n", l, b - a }' \
    | tee -a "$out/walls.txt"
}

steps() {  # steps <W> <mp>
  python -m torch.distributed.run --standalone --nproc_per_node="$1" "$here/tp_steps.py" --mp "$2" --out "$work"
}

case "$mode" in
  time)
    timed dryrun_4 python -m tacorl_tpu_torch.dryrun --n-devices 4
    timed steps_dp1_mp1 steps 1 1
    timed steps_dp4_mp1 steps 4 1
    timed steps_dp2_mp2 steps 4 2
    timed steps_dp1_mp4 steps 4 4
    python - "$work" <<'PY' | tee -a "$out/walls.txt"
import sys
from pathlib import Path
import torch
out = Path(sys.argv[1])
want = torch.load(out / "params_dp1_mp1.pt", weights_only=True)
atol = 2.5 * 1e-4 * 50
for name in ("dp4_mp1", "dp2_mp2", "dp1_mp4"):
    got = torch.load(out / f"params_{name}.pt", weights_only=True)
    if {k: v.shape for k, v in got.items()} != {k: v.shape for k, v in want.items()}:
        print(f"[tp] {name}: the gathered weights are not the unsharded layout")
        continue
    worst = max(float((got[k].float() - w.float()).abs().max()) for k, w in want.items() if w.numel())
    print(f"[tp] {name} weights after step 50 vs (1, 1)'s: largest difference {worst:.3g} (atol 2.5 lr a step = "
          f"{atol:.3g}) {'within' if worst <= atol else 'OUTSIDE'}")
PY
    ;;
  *)
    echo "unknown mode $mode" >&2
    exit 2
    ;;
esac
