"""Planted faults against the check of ``chip_smoke.py``'s phase
``train_ddp`` (b): two gloo ranks sharing one card, eager, held to one rank
of the same global batch. On one card:

    python results/torch_r12_ddp/faults.py <work_dir>

Runs (b) three times, each in a process of its own: from this checkout
(``sound``), then from two copies of it under ``<work_dir>``, each with one
fault planted in the port:

  * ``rows``: after the first global batch, every rank reads rank 0's rows
    (``data/loader.py``);
  * ``reduce``: each gradient group's all-reduce runs at its first step
    only (``core/optimizers.py``).

For each run it prints whether the phase passed, and for each stage the
largest relative difference of each step's row from one rank's and how far
apart the two ranks' weights ended. Exits 0 when the sound run passed and
both planted runs failed."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
PLANTS = {
    "rows": [("tacorl_tpu_torch/data/loader.py", "            rows = shard.rows(len(indices))\n",
              "            rows = shard.rows(len(indices)) if batch_idx == 0 else "
              "slice(0, len(indices) // shard.count)\n")],
    "reduce": [
        ("tacorl_tpu_torch/core/optimizers.py", "        grads = all_reduce_mean(grads)\n",
         "        grads = all_reduce_mean(grads) if name not in _SEEN else list(grads)\n"
         "        _SEEN.add(name)\n"),
        ("tacorl_tpu_torch/core/optimizers.py",
         "    return all_reduce_mean([p.grad for p in params if p.grad is not None])\n",
         "    grads = [p.grad for p in params if p.grad is not None]\n    if _SEEN:\n        return grads\n"
         "    _SEEN.add(None)\n    return all_reduce_mean(grads)\n"),
        ("tacorl_tpu_torch/core/optimizers.py", "def global_norm(", "_SEEN = set()\n\n\ndef global_norm("),
    ],
}


def plant(mode: str, code: Path) -> None:
    for rel, old, new in PLANTS[mode]:
        path = code / rel
        text = path.read_text()
        assert text.count(old) == 1, (rel, old)
        path.write_text(text.replace(old, new))


def check(mode: str, code: Path, work: Path) -> None:
    """(b) from the checkout ``code``, on the packed set and stage-1 run
    kept in ``work`` (made by the first run)."""
    sys.path.insert(0, str(code))
    import chip_smoke as cs
    import torch
    from tacorl_tpu_torch import train

    card = cs.phase_env()
    cs.phase_build()
    data, lmp = work / "packed", work / "lmp"
    stage1 = [a for a in cs._train_args("play_lmp_for_rl", str(data), "", cs.TRAIN_STEPS, "ckpt_max_to_keep=2",
                                        *cs.LMP_KL) if not a.startswith("run_dir=")]
    if not lmp.exists():  # the stage-1 run that stage 2 grafts from
        cs._train_data(str(work))
        train.main(stage1 + [f"run_dir={lmp}"])
    scan = {"play_lmp_for_rl": {"args": stage1},
            "tacorl": {"args": cs._train_args("tacorl", str(data), "", cs.TRAIN_STEPS, f"play_lmp_dir={lmp}")}}
    root, t0 = work / mode, time.perf_counter()
    try:
        cs._ddp_two_ranks(card, str(root), scan)
        verdict = "passed"
    except RuntimeError as exc:
        verdict = f"failed: {str(exc)[:600]}"
    print(f"[faults] {mode}: phase train_ddp (b) {verdict} ({time.perf_counter() - t0:.1f} s)", flush=True)
    drop = ("run_dir=", "trainer.steps_per_call=", "trainer.max_steps=")
    for e in cs.DDP_STAGES:
        one = root / f"w2one_{e}"
        if not (one / "metrics.jsonl").exists():  # (b) stopped before this stage's one-rank run
            train.main([a for a in scan[e]["args"] if not a.startswith(drop)]
                       + ["trainer.steps_per_call=1", f"trainer.max_steps={cs.DDP_STEPS}",
                          "trainer.log_every_n_steps=1", f"run_dir={one}"]
                       + (["module.plan_recognition.dropout_p=0"] if e == "play_lmp_for_rl" else []))

        def kind(row):
            return tuple(sorted(k for k in row if k not in ("step", "time")))

        want = {(r["step"], kind(r)): r for r in cs._metrics_rows(one)}
        steps = {}
        for row in cs._metrics_rows(root / f"w2_{e}"):
            if any(k.startswith(("train/", "validation/")) for k in row):
                ref = want[(row["step"], kind(row))]
                steps[row["step"]] = max(steps.get(row["step"], (0.0, "")),
                                         max((abs(row[k] - ref[k]) / max(abs(ref[k]), 1e-6), k) for k in kind(row)))
        a, b = (torch.load(root / "w2" / f"{e}_params_rank{r}.pt", weights_only=True) for r in range(2))
        apart = max(float((a[k].float() - b[k].float()).abs().max()) for k in a if a[k].numel())
        print(f"[faults] {mode} {e}: each step's row against one rank's, largest relative difference "
              + ", ".join(f"{s}: {v[0]:.3g} ({v[1]})" for s, v in sorted(steps.items()))
              + f"; the later rows' largest {max(v[0] for s, v in steps.items() if s > 1):.3g}; the ranks' "
              f"weights apart by {apart:.3g} | {card}", flush=True)
    (work / f"{mode}.json").write_text(json.dumps({"passed": verdict == "passed"}))


def main(work: Path) -> int:
    work.mkdir(parents=True, exist_ok=True)
    passed = {}
    for mode in ("sound", *PLANTS):
        code = CHECKOUT
        if mode in PLANTS:
            code = work / f"{mode}_checkout"
            shutil.rmtree(code, ignore_errors=True)
            shutil.copytree(CHECKOUT, code, ignore=shutil.ignore_patterns(".git", "build", "chiprun_out", "runs"))
            plant(mode, code)
        subprocess.run([sys.executable, __file__, "--check", mode, str(code), str(work)], cwd=code, check=True)
        passed[mode] = json.loads((work / f"{mode}.json").read_text())["passed"]
    ok = passed["sound"] and not any(passed[m] for m in PLANTS)
    print(f"[faults] {'ok' if ok else 'NOT OK'}: " + ", ".join(f"{m} {'passed' if p else 'failed'}"
                                                             for m, p in passed.items()), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--check"]:
        check(sys.argv[2], Path(sys.argv[3]), Path(sys.argv[4]))
    else:
        sys.exit(main(Path(sys.argv[1])))
