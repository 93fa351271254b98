"""Stage 2 of run.sh once more, eager (``trainer.steps_per_call=1``) with
Adam in the step graph's mode (``capturable=True``: bias corrections on the
device), held row by row against the graphed run of the same arguments
(K = 8 CUDA-graph replays a call). The two compute one function on one
card, so every logged row should agree within rtol 1e-4 across all of the
run's rollouts, and a replay that trained memory the net no longer reads
would show from the first epoch after it.

    python results/torch_r15_visual/hold.py <graphed run> <eager run> <train overrides...>

Prints, per epoch, the largest relative difference over its train,
validation and rollout rows, the first row outside rtol 1e-4, both runs'
val_accuracy, and whether every row was within rtol 1e-4.
"""

import bisect
import json
import logging
import sys

from tacorl_tpu_torch import train
from tacorl_tpu_torch.callbacks.base import Callback
from tacorl_tpu_torch.core.optimizers import set_capturable

RTOL = 1e-4


class Capturable(Callback):
    def on_fit_start(self, trainer, module):
        set_capturable(trainer.state.optimizer, True)


def _rows(run):
    """(step, sorted keys) -> row, every row but the time."""
    with open(f"{run}/metrics.jsonl") as f:
        rows = [{k: v for k, v in json.loads(line).items() if k != "time"} for line in f]
    return {(r["step"], tuple(sorted(r))): r for r in rows}


def main(graphed: str, eager: str, overrides: list) -> int:
    trainer = train.main([*overrides, f"run_dir={eager}", "trainer.steps_per_call=1"], callbacks=[Capturable()])
    got, want = _rows(graphed), _rows(eager)
    ends = sorted({s for s, keys in want if any(k.startswith("validation/") for k in keys)})  # epoch ends
    worst, first, held = {}, None, 0
    for key, row in sorted(got.items()):
        ref = want.get(key)
        if ref is None:
            continue  # the eager run logs train rows at steps the graphed run's chunks skip
        held += 1
        epoch = bisect.bisect_left(ends, row["step"])
        for k, v in row.items():
            err = abs(v - ref[k]) / max(abs(ref[k]), 1e-6)
            if err > worst.get(epoch, (0.0, ""))[0]:
                worst[epoch] = (err, f"{k} at step {row['step']}")
            if err > RTOL and first is None:
                first = f"{k} at step {row['step']}: graphed {v} vs eager {ref[k]}"
    print(f"hold: {held} rows of the graphed run held against the eager run with capturable Adam "
          f"({trainer.global_step} steps, epochs ending at {ends})")
    for epoch, (err, where) in sorted(worst.items()):
        print(f"hold: epoch {epoch} largest relative difference {err:.3g} ({where})")
    print(f"hold: first row outside rtol {RTOL:g}: {first}")
    for name, rows in (("graphed", got), ("eager", want)):
        print(f"hold: {name} val_accuracy {[(s, round(r['val_accuracy'], 4)) for (s, _), r in sorted(rows.items()) if 'val_accuracy' in r]}")
    print(f"hold: {'every row within' if first is None else 'NOT within'} rtol {RTOL:g}")
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    sys.exit(main(sys.argv[1], sys.argv[2], sys.argv[3:]))
