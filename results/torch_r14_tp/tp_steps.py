"""The production Play-LMP step on a ``(dp, mp)`` mesh of NCCL ranks, one
a card, as CUDA-graph replays (``make_scanned_train_step``, K steps a
call): the mp ranks' column-parallel all-gathers and input-gradient
all-reduces, the dp gradient all-reduce and the global norm's mp sum are
captured in the step graph. Launch one process a rank:

    python -m torch.distributed.run --standalone --nproc_per_node=W \\
        results/torch_r14_tp/tp_steps.py --mp M --out <dir>

Global batch 64 (window 16, raw 200x200 frames drawn on the card from a
seed per step, the same on every rank), dp = W / M ranks taking its rows,
the JAX dry run's four rules sharding the posterior's fc and linear1 and
the decoder's heads over mp (none at M = 1), the posterior's dropout off
(the dp rows of a mesh draw their own masks: ROADMAP Queue 3). 50 steps at K = 16 (chunks
of 16, 16, 16 and 2); TF32 off. Rank 0 prints one ``[tp]`` line: ms/step
over chunk 2 (steps 17-32, a sync at both ends), the NCCL kernels and
jitter_normalize launches in the device trace of chunk 3's replays (steps
33-48), the step graph's captures and replays, chunk 3's last metrics;
and writes the gathered weights after step 50 (the unsharded layout) to
``<out>/params_dp<dp>_mp<M>.pt``."""

import argparse
import json
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from tacorl_tpu_torch.dryrun import _module  # noqa: E402
from tacorl_tpu_torch.parallel import mesh  # noqa: E402
from tacorl_tpu_torch.parallel.tensor_parallel import PLAY_LMP_RULES, shard_params_by_rule  # noqa: E402

B, T, HW, K, STEPS = 64, 16, 200, 16, 50


def batch(g: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(1000 + g)
    frames = torch.randint(0, 255, (B, T, HW, HW, 3), generator=gen, device=device, dtype=torch.uint8)
    actions = torch.randn((B, T, 7), generator=gen, device=device).clamp(-1, 1)
    return {"states": {"rgb_static": frames}, "actions": actions}


def stacked(start: int, k: int, m, device) -> dict:
    """Steps ``start`` .. ``start + k - 1``'s batches, this rank's dp rows,
    stacked to (k, B / dp, ...) leaves."""
    rows = [mesh.shard_batch(batch(g, device), m) for g in range(start, start + k)]
    return {"states": {"rgb_static": torch.stack([r["states"]["rgb_static"] for r in rows])},
            "actions": torch.stack([r["actions"] for r in rows])}


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--mp", type=int, required=True)
    parser.add_argument("--out", required=True)
    args = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh.init_distributed("cuda")
    m = mesh.create_mesh(mp=args.mp)
    module = _module("cuda", tiny=False)
    for layer in module.net.modules():  # the posterior's dropout off: every mesh computes one function
        if isinstance(layer, torch.nn.Dropout):
            layer.p = 0.0
        elif isinstance(layer, torch.nn.MultiheadAttention):
            layer.dropout = 0.0
    state = module.init_state(0)
    if m.mp > 1:
        shard_params_by_rule(state.net, m, PLAY_LMP_RULES, optimizer=state.optimizer)
    mesh.replicate(state)
    scanned = module.make_scanned_train_step()
    device, chunks, ms, traced, metrics = module.device, [K, K, K, STEPS - 3 * K], None, None, {}
    with mesh.sharded_draws(mesh.batch_sharding(m)):
        for i, k in enumerate(chunks):
            chunk = stacked(int(state.step), k, m, device)
            torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if i == 2 else None
            if prof is not None:
                prof.__enter__()
            t0 = time.perf_counter()
            state, metrics = scanned(state, chunk, module.step_scalars(), seed=0)
            torch.cuda.synchronize()
            if i == 1:
                ms = (time.perf_counter() - t0) * 1e3 / k
            if prof is not None:
                prof.__exit__(None, None, None)
                events = prof.key_averages()
                ranges = {e.key for e in events if e.device_type == DeviceType.CPU}
                kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.key not in ranges]
                traced = {"nccl": sum(e.count for e in kernels if "nccl" in e.key.lower()),
                          "jitter": sum(e.count for e in kernels
                                        if "jitter_normalize_kernel" in e.key and "shift_" not in e.key),
                          "steps": k}
                last = {name: float(v) for name, v in mesh.sync_metrics(metrics).items()}
    full = state.state_dict()["net"]  # every rank: the mp gather is a collective
    graph = scanned.graph
    if mesh.rank() == 0:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        torch.save({k: v.cpu() for k, v in full.items()}, out / f"params_dp{m.dp}_mp{m.mp}.pt")
        print(f"[tp] (dp, mp) = ({m.dp}, {m.mp}), {B // m.dp} rows a rank, K={K}: {ms:.3f} ms/step over steps "
              f"{K + 1}-{2 * K}; in the device trace of rank 0's replays of steps {2 * K + 1}-{3 * K}: "
              f"{traced['nccl']} NCCL kernels ({traced['nccl'] / traced['steps']:g} a step), {traced['jitter']} "
              f"jitter_normalize launches; step graph captures/replays {graph.captures}/{graph.replays}; "
              f"step {3 * K} total_loss {last['total_loss']:.6f} grad_norm {last['grad_norm']:.6f} | "
              + json.dumps({"dp": m.dp, "mp": m.mp, "ms": ms, **traced, "last": last}), flush=True)
    graph.release()  # NCCL keeps its communicator while a graph that captured it lives
    mesh.destroy_distributed()


if __name__ == "__main__":
    main()
