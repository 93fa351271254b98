"""Which tensors a validation pass moves under a graphed run, on the card.

`experiment=play_lmp_fake` (biRNN posterior) at K = 2 as CUDA-graph replays
for 10 steps on the 8-episode expert-play set of `kl_spike_card.py` (one
validation pass after step 6, whose rollout callback builds its agent);
after each pass it prints the net's tensors whose storage moved and those
whose values changed since the last chunk. Four runs: as it is, with the
step graph released after each pass (so captured again), with cuDNN off in
the pass, and with the pass in train mode.

    python results/torch_r13_tools/moved_weights.py
"""

import contextlib
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402
import torch.nn as nn  # noqa: E402

from tacorl_tpu_torch import train  # noqa: E402
from tacorl_tpu_torch.callbacks.base import Callback  # noqa: E402
from tacorl_tpu_torch.core import trainer as trainer_mod  # noqa: E402
from tacorl_tpu_torch.data.expert_play import generate_expert_play  # noqa: E402


class Probe(Callback):
    def __init__(self, release=False):
        self.release = release

    def on_train_batch_end(self, trainer, module, metrics, step):
        sd = trainer.state.net.state_dict()
        self.ptrs = {k: v.data_ptr() for k, v in sd.items()}
        self.vals = {k: v.detach().clone() for k, v in sd.items()}
        print(f"  step {step} kl {float(metrics['kl_loss']):.6g}", flush=True)

    def on_validation_end(self, trainer, module, metrics, outputs, epoch):
        sd = trainer.state.net.state_dict()
        moved = [k for k, v in sd.items() if v.data_ptr() != self.ptrs[k]]
        changed = [k for k, v in sd.items() if not torch.equal(v, self.vals[k])]
        print(f"  after validation: {len(moved)} tensors moved {moved[:6]}, {len(changed)} changed "
              f"{changed[:6]}; training={trainer.state.net.training}", flush=True)
        if self.release and trainer.step_graph is not None:
            trainer.step_graph.release()


@contextlib.contextmanager
def val_without_cudnn():
    validate = trainer_mod.Trainer.validate

    def without(self, *args, **kwargs):
        with torch.backends.cudnn.flags(enabled=False):
            return validate(self, *args, **kwargs)

    trainer_mod.Trainer.validate = without
    try:
        yield
    finally:
        trainer_mod.Trainer.validate = validate


@contextlib.contextmanager
def val_in_train_mode():
    eval_ = nn.Module.eval
    nn.Module.eval = lambda self: self
    try:
        yield
    finally:
        nn.Module.eval = eval_


def main():
    work = Path(tempfile.mkdtemp())
    generate_expert_play(work / "play", 8, 2, seed=3)
    base = ["experiment=play_lmp_fake", f"data_dir={work / 'play'}", "seed=42", "trainer.max_steps=10",
            "trainer.log_every_n_steps=1", "callbacks.rollout.every_n_epochs=100", "trainer.steps_per_call=2"]
    for name, probe, patch in (("plain", Probe(), None), ("release_after_val", Probe(release=True), None),
                               ("val_without_cudnn", Probe(), val_without_cudnn),
                               ("val_in_train_mode", Probe(), val_in_train_mode)):
        print(name, flush=True)
        with patch() if patch else contextlib.nullcontext():
            trainer = train.main(base + [f"run_dir={work / name}"], callbacks=[probe])
        graph = trainer.step_graph
        print(f"  graph captures {graph.captures} replays {graph.replays}", flush=True)


if __name__ == "__main__":
    main()
