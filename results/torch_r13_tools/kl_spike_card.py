"""The kl_loss spike of results/torch_r12_ddp/ run J, on the card:
`experiment=play_lmp_fake`'s first 8 steps on the 8-episode expert-play set
of `results/torch_r12_ddp/run.sh steps` (`generate_expert_play(<dir>, 8,
2, seed=3)`), seed 42, every step logged, the rollout monitor every 100
epochs (it fires at epoch 0 all the same, after step 6), at K = 1 (eager)
and K = 2 (CUDA-graph replays, as `run.sh steps` ran it), each with
torch's TF32 defaults (cuDNN convolutions in TF32, as in run J) and with
TF32 off.

    python results/torch_r13_tools/kl_spike_card.py <out_dir>

Prints the card and, for each run, each step's unweighted kl_loss,
action_loss and grad_norm; writes the same into <out_dir>/kl_spike_card.txt.
"""

import json
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from tacorl_tpu_torch import train  # noqa: E402
from tacorl_tpu_torch.data.expert_play import generate_expert_play  # noqa: E402

STEPS = 8


def main(out_dir):
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    work = Path(tempfile.mkdtemp())
    generate_expert_play(work / "play", 8, 2, seed=3)
    lines = [f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}"]
    for k in (1, 2):
        for tf32 in (True, False):
            torch.backends.cudnn.allow_tf32 = tf32
            torch.backends.cuda.matmul.allow_tf32 = tf32 and torch.backends.cuda.matmul.allow_tf32
            run = work / f"k{k}_tf32_{tf32}"
            train.main(["experiment=play_lmp_fake", f"data_dir={work / 'play'}", f"run_dir={run}", "seed=42",
                        f"trainer.max_steps={STEPS}", f"trainer.steps_per_call={k}",
                        "trainer.log_every_n_steps=1", "callbacks.rollout.every_n_epochs=100"])
            rows = [r for r in map(json.loads, (run / "metrics.jsonl").read_text().splitlines())
                    if "train/kl_loss" in r]
            lines.append(f"K={k} cudnn_tf32={tf32}: " + "; ".join(
                f"step {r['step']} kl {r['train/kl_loss']:.6g} action {r['train/action_loss']:.6g} "
                f"grad_norm {r['train/grad_norm']:.6g}" for r in rows))
            print(lines[-1], flush=True)
    (out / "kl_spike_card.txt").write_text("\n".join(lines) + "\n")
    print(lines[0])


if __name__ == "__main__":
    main(sys.argv[1])
