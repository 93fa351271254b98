"""Run one cell of the benchmark once and print its result as the last line
of standard output:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` measures the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled window. The run needs as many CUDA
cards as the cell asks for; without them it exits with status 2 and
prints no result. A cell on more than one chip runs one process a card
under ``torchrun`` (``launch.py``); where a rank fails, the others are
stopped and the run exits with status 1 and prints no result. The last lines of standard
error are the numbers that decided ``correct``, each beside its limit.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import signal  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from perfbench import compare, harness

    workload, _ = harness.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(workload["chips"]):
        print(f"{args.workload} needs {workload['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    harness.set_cache_dirs()
    chips = int(workload["chips"])
    if chips == 1:
        result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), T0)
    else:
        from perfbench import launch

        # a launcher that is ended stops its ranks first
        signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
        done = launch.launch(args.workload, [args.seed], args.seconds, bool(args.trace), T0, chips)
        if done["runs"] is None:
            print(f"{args.workload}: the launch exited with status {done['rc']}; no result", file=sys.stderr)
            return 1
        result = launch.merge(done["runs"][0])
        found = harness.forbidden_modules()
        if found:
            raise SystemExit(f"loaded modules of JAX or the JAX package: {found}")
    compare.report(result["checks"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
