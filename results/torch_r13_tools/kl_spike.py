"""Does the JAX package's Play-LMP spike where the port's did?

`results/torch_r12_ddp/run.sh steps` (its README, run J) saw the
unweighted `kl_loss` of `experiment=play_lmp_fake` jump to 1.56e+32 at
step 8 on the H100. This script runs both packages on the CPU through the
commands a user runs (`scripts/train.py` and `python -m
tacorl_tpu_torch.train`) on the same 8-episode expert-play set
(`generate_expert_play(<dir>, 8, 2, seed=3)`, as `run.sh steps` makes it),
at `play_lmp_fake`'s widths, from one step-0 checkpoint (JAX's init,
converted for the port), with the same batches (the same loader seed) and
the port given JAX's posterior draw at every step, float32 convolutions,
K = 1, 8 steps, every step logged. The recipe augments nothing
(`transforms/fake.yaml`: pad 0, no jitter) and has no dropout.

    python results/torch_r13_tools/kl_spike.py <out_dir>

Writes <out_dir>/jax.metrics.jsonl, port.metrics.jsonl and kl_spike.txt
(each step's kl_loss, action_loss and grad_norm in both, side by side).
"""

import json
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from tacorl_tpu_torch.data.expert_play import generate_expert_play  # noqa: E402
from tacorl_tpu_torch.utils.convert import play_lmp_state_dict_from_jax  # noqa: E402
from tests.test_torch_cql import np_tree  # noqa: E402
from tests.test_torch_trainer_k_step import run_pair  # noqa: E402

SEED, B, LATENT, STEPS = 42, 32, 8, 8
METRICS = ("train/kl_loss", "train/action_loss", "train/total_loss", "train/grad_norm")


def posterior_draw(split, step):
    """The posterior's standard normal that JAX's train step draws at
    ``step`` (its k_plan); nothing else of the recipe is random."""
    if split != "train":
        return None
    _, _, k_loss = jax.random.split(jax.random.fold_in(jax.random.key(SEED), step), 3)
    eps = jax.random.normal(jax.random.split(k_loss, 6)[0], (B, LATENT))
    return {"eps": torch.from_numpy(np.array(eps))}


def main(out_dir):
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp())
    generate_expert_play(work / "play", 8, 2, seed=3)
    overrides = [
        "experiment=play_lmp_fake", f"data_dir={work / 'play'}", f"seed={SEED}",
        f"trainer.max_steps={STEPS}", "trainer.log_every_n_steps=1", "trainer.val_every_n_epochs=100",
        "callbacks.rollout.every_n_epochs=100",
        "+module.perceptual_encoder.networks.rgb_static.compute_dtype=null",
    ]
    convert = lambda s: play_lmp_state_dict_from_jax(np_tree(s.params))  # noqa: E731
    jax_dir, trainer, _, _ = run_pair(work / "runs", overrides, convert, posterior_draw)
    rows = {}
    for name, run in (("jax", jax_dir), ("port", trainer.ckpt.dir)):
        text = (run / "metrics.jsonl").read_text()
        (out / f"{name}.metrics.jsonl").write_text(text)
        rows[name] = {r["step"]: r for r in map(json.loads, text.splitlines()) if "train/kl_loss" in r}
    lines = ["step " + " ".join(f"{p}:{m.split('/')[1]}" for m in METRICS for p in ("jax", "port"))]
    for step in sorted(rows["jax"]):
        lines.append(f"{step} " + " ".join(f"{rows[p][step][m]:.6g}" for m in METRICS for p in ("jax", "port")))
    peak = {p: max(r["train/kl_loss"] for r in rows[p].values()) for p in rows}
    lines.append(f"largest kl_loss over the {STEPS} steps: jax {peak['jax']:.6g}, port {peak['port']:.6g}")
    for keys, what in ((["train/kl_loss"], "kl_loss"), ([k for k in rows["jax"][1] if k.startswith("train/")],
                                                        "any train metric")):
        worst = max((abs(rows["port"][s][k] - rows["jax"][s][k]) / max(abs(rows["jax"][s][k]), 1e-6), s, k)
                    for s in rows["jax"] for k in keys)
        lines.append(f"largest relative difference, {what}: {worst[0]:.3g} ({worst[2]} at step {worst[1]})")
    (out / "kl_spike.txt").write_text("\n".join(lines) + "\n")
    print("\n".join(lines))


if __name__ == "__main__":
    main(sys.argv[1])
