"""``python -m tacorl_tpu_torch.train`` with a probe on rank 0, for one rank
of a launcher (``python -m torch.distributed.run --nproc_per_node=W
results/torch_r12_ddp/probe.py <train overrides>``).

The probe traces rank 0's steps 33-64 with torch.profiler (whole chunks
at K = 8 and 16, inside the first epoch of the recipes, and over before
run.sh's timed steps 80-400 begin) and prints one line: the NCCL kernels and jitter_normalize launches in the device trace
of those steps, and the all-reduces that Python issued over them (a
graphed step's are replayed from the graph, so none)."""

import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from tacorl_tpu_torch import train
from tacorl_tpu_torch.callbacks.base import Callback
from tacorl_tpu_torch.parallel import mesh

TRACED = (32, 64)


class TraceProbe(Callback):
    def __init__(self):
        self.prof = None

    def on_train_batch_end(self, trainer, module, metrics, step):
        if mesh.rank() != 0:
            return
        if step == TRACED[0]:
            torch.cuda.synchronize()
            self.calls = mesh.all_reduce_mean.calls
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
        elif step == TRACED[1] and self.prof is not None:
            torch.cuda.synchronize()
            self.prof.__exit__(None, None, None)
            events = self.prof.key_averages()
            ranges = {e.key for e in events if e.device_type == DeviceType.CPU}
            device = [e for e in events if e.device_type == DeviceType.CUDA and e.key not in ranges]
            nccl = sum(e.count for e in device if "nccl" in e.key.lower())
            jitter = sum(e.count for e in device if "jitter_normalize_kernel" in e.key and "shift_" not in e.key)
            steps = TRACED[1] - TRACED[0]
            graph = trainer.step_graph
            print(f"[probe] {trainer.ckpt.dir.name} W={mesh.world()} K={trainer.steps_per_call}: in the device "
                  f"trace of rank 0's steps {TRACED[0] + 1}-{TRACED[1]}, {nccl} NCCL kernels ({nccl / steps:g} a "
                  f"step) and {jitter} jitter_normalize launches; {mesh.all_reduce_mean.calls - self.calls} "
                  f"all-reduces issued from Python over them; step graph: "
                  f"{(graph.captures, graph.replays) if graph else None}", flush=True)


if __name__ == "__main__":
    train.main(sys.argv[1:], callbacks=[TraceProbe()])
