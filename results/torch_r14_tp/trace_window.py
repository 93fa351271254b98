"""Whether torch.profiler keeps every device event of a traced span: four
production stage-1 steps traced 12 times as the profiler starts (settle
0) and 12 times 50 ms after it (settle 0.05), on the card; one line a
trace (kernel-1 events against its launches, the first kernel and the
first runtime call after the span opened). Run from the repo root:

    python3 results/torch_r14_tp/trace_window.py

writes chiprun_out/probe_trace.txt (copied here as trace_window.txt)."""
import contextlib, json, sys, tempfile, time
from pathlib import Path
import torch
sys.path.insert(0, ".")
import chip_smoke as c
from tacorl_tpu_torch.ops.jitter_aug import jitter_normalize

out = open("chiprun_out/probe_trace.txt", "w")
def log(msg):
    print(msg, flush=True); out.write(msg + "\n"); out.flush()

@contextlib.contextmanager
def trace(log_dir, settle):
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts, on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir))) as prof:
        if settle:
            torch.cuda.synchronize(); time.sleep(settle)
        with torch.profiler.record_function("stage1_steps"):
            yield prof
        torch.cuda.synchronize()

card = c.phase_env(); c.phase_build()
log(card)
module, state, step, batch = c._production_step()
state, _ = step(state, batch)
torch.cuda.synchronize()
for settle in (0.0, 0.05):
    for i in range(12):
        root = tempfile.mkdtemp()
        jitter_normalize.launches = 0
        with trace(f"{root}/profile", settle):
            for _ in range(4):
                state, metrics = step(state, batch)
        events = json.loads(next(Path(f"{root}/profile").glob("*.pt.trace.json")).read_text())["traceEvents"]
        span = [e for e in events if e.get("name") == "stage1_steps"]
        kern = [e for e in events if e.get("cat") == "kernel"]
        jit = sorted(e["ts"] for e in kern if "jitter_normalize" in e.get("name", "") and "shift_" not in e["name"])
        rt = [e for e in events if e.get("cat") == "cuda_runtime"]
        t0 = span[0]["ts"]
        first_rt = min((e["ts"] for e in rt if e["ts"] >= t0), default=t0)
        log(f"[probe] settle {settle} run {i}: jitter kernels {len(jit)} (launches {jitter_normalize.launches}); "
            f"{len(kern)} kernels; first kernel {round(min(e['ts'] for e in kern) - t0)} us after the span start, "
            f"first runtime call in the span {round(first_rt - t0)} us; jitter at {[round(t - t0) for t in jit]}; "
            f"kernels before the span {sum(1 for e in kern if e['ts'] < t0)}")
