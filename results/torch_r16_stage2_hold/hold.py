"""Stage 2 once more with every step eager, held row by row against the
graphed run of the same arguments. The eager run keeps the graphed run's
``trainer.steps_per_call`` K, so the trainer cuts each epoch into the same
K-step chunks (the same batches, the same trailing partial chunk dropped,
the same logging steps), and each step of a chunk runs eagerly: the
module's step graph is off, its generators seeded from (seed, step) before
each step as before each replay, and Adam in the graph's mode
(``capturable=True``: bias corrections on the device). The two compute one
function on one card, so every row should agree within rtol 1e-4.

results/torch_r15_visual/hold.py ran its eager run at K = 1, which trains
on other batches once an epoch's batch count is not a multiple of K (the
flagship set's 669 batches an epoch at K = 8), so its rows are not the
graphed run's after the first epoch.

    python results/torch_r16_stage2_hold/hold.py <graphed run> <eager run> <train overrides...>

Prints compare.py's per-epoch largest relative difference, the first row
outside rtol 1e-4, and both runs' val_accuracy.
"""

import json
import logging
import sys
from pathlib import Path

from tacorl_tpu_torch import train
from tacorl_tpu_torch.callbacks.base import Callback
from tacorl_tpu_torch.core.optimizers import set_capturable
from tacorl_tpu_torch.modules import base

sys.path.insert(0, str(Path(__file__).resolve().parent))
import compare  # noqa: E402


class Capturable(Callback):
    def on_fit_start(self, trainer, module):
        set_capturable(trainer.state.optimizer, True)


def main(graphed: str, eager: str, overrides: list) -> int:
    base.StepGraph = lambda module, step: None  # make_scanned_train_step runs each step eagerly
    trainer = train.main([*overrides, f"run_dir={eager}"], callbacks=[Capturable()])
    print(f"hold: the eager run took {trainer.global_step} steps at K = {trainer.steps_per_call}, "
          f"step graph {trainer.step_graph}")
    compare.main("hold", graphed, eager)
    for name, run in (("graphed", graphed), ("eager", eager)):
        with open(f"{run}/metrics.jsonl") as f:
            acc = [(r["step"], round(r["val_accuracy"], 4)) for r in map(json.loads, f) if "val_accuracy" in r]
        print(f"hold: {name} val_accuracy {acc}")
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    sys.exit(main(sys.argv[1], sys.argv[2], sys.argv[3:]))
