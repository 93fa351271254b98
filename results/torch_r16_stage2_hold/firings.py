"""Stage 2 through ``train.main`` with a record of every rollout firing:
whether it moved the net's parameters or buffers, whether they stand at the
addresses the step graph was captured with once it is over, where each
RNN's flat weight buffer was before and after it, and whether the epoch
after it captured the step graph again.

    python results/torch_r16_stage2_hold/firings.py <record.jsonl> [--capture-after-firings] <train overrides...>

``--capture-after-firings`` frees the step graph after each epoch's
firings (``StepGraph.release``), so every epoch after a firing captures
again, whether the firing moved the weights or not: held against the run
without it, this says whether a replay across a firing that moved nothing
trains what a new capture trains. The probe reads pointers only and
allocates nothing on the card, so the run's allocator history is the
plain run's.

Writes one JSON line per firing and one per epoch end to <record.jsonl>
and prints them as ``firing: ...`` and ``epoch: ...`` lines.
"""

import json
import logging
import sys

import torch.nn as nn

from tacorl_tpu_torch import train
from tacorl_tpu_torch.callbacks.base import Callback
from tacorl_tpu_torch.callbacks.rollout import RolloutCallback, RolloutLongHorizonCallback
from tacorl_tpu_torch.core.graphs import _addresses

RECORDS = []


def _rnn_buffers(net):
    """The address of each RNN's first weight (its flat buffer's start)."""
    return [m._flat_weights[0].data_ptr() for m in net.modules() if isinstance(m, nn.RNNBase)]


def _probe(cls):
    run = cls._run

    def probed(self, trainer, module, epoch, prefix):
        state, graph = trainer.state, trainer.step_graph
        before, rnn_before = _addresses(state), _rnn_buffers(state.net)
        run(self, trainer, module, epoch, prefix)
        after = _addresses(state)
        RECORDS.append({
            "kind": "firing", "step": trainer.global_step, "epoch": epoch, "callback": cls.__name__,
            "moved": after != before,
            "at_capture_addresses": graph is not None and graph.addresses is not None and after == graph.addresses,
            "rnn_buffers_before": rnn_before, "rnn_buffers_after": _rnn_buffers(state.net),
        })
        print("firing: " + json.dumps(RECORDS[-1]), flush=True)

    cls._run = probed


class Firings(Callback):
    """Per epoch: the step graph's captures at its end and after the next
    epoch's first chunk; optionally frees the graph after the firings."""

    def __init__(self, path: str, capture_after_firings: bool):
        self.path, self.capture_after_firings = path, capture_after_firings
        self.first_chunk_of = None

    def on_epoch_start(self, trainer, module, epoch):
        self.first_chunk_of = epoch

    def on_train_batch_end(self, trainer, module, metrics, step):
        graph = trainer.step_graph
        if self.first_chunk_of is not None and graph is not None:
            RECORDS.append({"kind": "first_chunk", "epoch": self.first_chunk_of, "step": step,
                            "captures": graph.captures})
            self.first_chunk_of = None

    def on_validation_end(self, trainer, module, metrics, outputs, epoch):
        graph = trainer.step_graph
        fired = any(r["kind"] == "firing" and r["epoch"] == epoch for r in RECORDS)
        if self.capture_after_firings and fired and graph is not None:
            graph.release()

    def on_epoch_end(self, trainer, module, epoch):
        graph = trainer.step_graph
        RECORDS.append({"kind": "epoch_end", "epoch": epoch, "step": trainer.global_step,
                        "captures": None if graph is None else graph.captures,
                        "replays": None if graph is None else graph.replays})
        print("epoch: " + json.dumps(RECORDS[-1]), flush=True)

    def on_fit_end(self, trainer, module):
        with open(self.path, "w") as f:
            for r in RECORDS:
                f.write(json.dumps(r) + "\n")


def main(argv) -> int:
    path, rest = argv[0], argv[1:]
    again = "--capture-after-firings" in rest
    rest = [a for a in rest if a != "--capture-after-firings"]
    for cls in (RolloutCallback, RolloutLongHorizonCallback):
        _probe(cls)
    train.main(rest, callbacks=[Firings(path, again)])
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    sys.exit(main(sys.argv[1:]))
