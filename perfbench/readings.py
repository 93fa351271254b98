"""The readings that the limits of ``correct`` are set from, on the chip at
the cell's own sizes, all in one process:

    python3 perfbench/readings.py --workload <cell> --seeds 1 2 ... [--control 1 2 3] [--fault half_batch]
        [--planted no_exchange 4 5 6] [--set bc_epochs=0 module.bc_epochs=0] [--detail]

For each of ``--seeds`` the program runs its first steps under the
cell's trainer settings (a window of one chunk) and the reference follows
them (the lower readings). For each of ``--control`` the reference put in
the program's place, one step lower in precision (``reference/common.py``),
is compared with the reference in float32 (the upper readings); no program
runs. With ``--fault`` the program runs with that fault planted
(``faults.py``). ``--planted <fault> <seeds>`` reads a fault planted in
the reference put in the program's place (``half_batch``: each rank's
rows repeat their first half in their second; ``no_exchange``: rank 0
steps on its own share; ``altered``: as in the program), in float32
against the reference; no program runs. ``--set`` changes the cell for these readings only: a
``key=value`` whose key is one of the configuration's sizes sets that size
(for the reference), any other is one more override of the program's
configuration. ``--detail`` adds each step's losses on both sides and the
leaves with the widest gaps. Each reading is printed as one JSON line.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def control_run(workload: dict, config: dict, seed: int, device, planted: Optional[str] = None) -> dict:
    """The control for one seed: the reference in ``control`` mode against
    the reference in float32, from the seed's weights and batches; its
    numbers and what they were taken from. With ``planted``, the
    reference in float32 with that fault planted takes the control's
    place."""
    from perfbench import compare, data, faults, harness
    from perfbench.reference.common import rows_of

    reference = importlib.import_module(f"perfbench.reference.{config['reference']}")
    sizes = config["sizes"]
    store = data.ensure_store(config["dataset"])
    weights = reference.weights(sizes, seed, device)["full"]
    chips = int(workload["chips"])
    ref = harness.reference_steps(reference, store, workload, sizes, seed, weights, "f32", chips)
    if planted is None:
        low = harness.reference_steps(reference, store, workload, sizes, seed, weights, "control", chips)
    elif planted == "altered":
        # the fault patches torch's Adam, which the reference steps with too
        with faults.planted(planted):
            low = harness.reference_steps(reference, store, workload, sizes, seed, weights, "f32", chips)
    elif planted in ("half_batch", "no_exchange"):
        batches = reference.batches(store, dict(sizes, batch_size=int(workload["batch_size"])), seed,
                                    harness.SNAP_STEPS, device)
        if planted == "half_batch":
            for batch in batches:
                for r in range(chips):
                    faults.half(rows_of(batch, r, chips))
        low = reference.train_steps(weights, batches, sizes, seed, 0, "f32", ranks=chips,
                                    exchange=planted != "no_exchange")
    else:
        raise ValueError(f"no fault {planted!r} to plant in the reference")
    program = compare.as_program(low)
    return {"numbers": compare.numbers(program, ref, weights),
            "evidence": {"program": program, "reference": ref, "start": weights}}


def control_numbers(workload: dict, config: dict, seed: int, device) -> dict:
    """The control's numbers for one seed (``control_run``)."""
    return control_run(workload, config, seed, device)["numbers"]


def changed(config: dict, settings) -> dict:
    """The configuration with ``--set``'s ``key=value`` settings."""
    config = json.loads(json.dumps(config))
    for item in settings:
        key, _, value = item.partition("=")
        if key in config["sizes"]:
            config["sizes"][key] = json.loads(value)
        else:
            config["overrides"] = list(config["overrides"]) + [item]
    return config


def detail(evidence: dict, n: int = 6) -> dict:
    """Each step's losses on both sides, the ``n`` leaves with the widest
    gaps of first gradient and of change (program, reference), and for
    every leaf the norms of the first gradient's difference and of the
    reference's first gradient (``diffs``)."""
    from perfbench import compare

    program, ref, start = evidence["program"], evidence["reference"], evidence["start"]
    losses = {k: [[float(program["losses"][i + 1][k]), float(r)] for i, r in enumerate(v)]
              for k, v in ref["losses"].items()}
    scale = 1.0 - program["beta1"]
    moments = program["moments"] or {}
    grads = sorted(((compare.norm(moments[k]) / scale if k in moments else 0.0, compare.norm(g), k)
                    for k, g in ref["grads"].items()), key=lambda x: -abs(x[0] - x[1]))
    changes = sorted(((compare.norm(program["params"][k] - start[k]), compare.norm(ref["params"][k] - start[k]), k)
                      for k in ref["params"]), key=lambda x: -abs(x[0] - x[1]))
    diffs = [[k, compare.norm(moments[k] / scale - g) if k in moments else compare.norm(g), compare.norm(g)]
             for k, g in ref["grads"].items()]
    return {"losses": losses, "grads": [[k, a, b] for a, b, k in grads[:n]],
            "changes": [[k, a, b] for a, b, k in changes[:n]], "diffs": diffs}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control", type=int, nargs="*", default=[])
    parser.add_argument("--fault", default=None)
    parser.add_argument("--planted", nargs="*", default=[])
    parser.add_argument("--set", nargs="*", default=[], dest="settings")
    parser.add_argument("--detail", action="store_true")
    args = parser.parse_args(argv)

    import torch

    from perfbench import harness

    harness.set_cache_dirs()
    workload, config = harness.cell(args.workload)
    config = changed(config, args.settings)
    device = torch.device("cuda")
    first = dict(workload, warm_chunks=1)
    extra = {"set": args.settings} if args.settings else {}
    chips = int(workload["chips"])
    if chips > 1 and args.seeds:
        from perfbench import launch

        # one launch for every seed: the ranks keep one process group
        t = time.perf_counter()
        done = launch.launch(args.workload, args.seeds, 0.0, False, t, chips, fault=args.fault,
                             overrides={"workload": first, "config": config, "metrics": []}, evidence=args.detail)
        if done["runs"] is None:
            print(json.dumps({"kind": args.fault or "program", "seeds": args.seeds, "rc": done["rc"]}), flush=True)
        for seed, ranks in zip(args.seeds, done["runs"] or []):
            r = launch.merge(list(ranks))
            more = {"detail": r["detail"]} if args.detail else {}
            print(json.dumps({"kind": args.fault or "program", "seed": seed, **extra, **r["numbers"],
                              "seconds": (time.perf_counter() - t) / len(args.seeds), **more}), flush=True)
    for seed in args.seeds if chips == 1 else []:
        t = time.perf_counter()
        r = harness.run(args.workload, seed, 0.0, False, t, workload=first, config=config, metrics=[],
                        fault=args.fault, evidence=args.detail)
        more = {"detail": detail(r["evidence"])} if args.detail else {}
        print(json.dumps({"kind": args.fault or "program", "seed": seed, **extra, **r["numbers"],
                          "seconds": time.perf_counter() - t, **more}), flush=True)
    runs = [(None, seed) for seed in args.control] + [(args.planted[0], int(s)) for s in args.planted[1:]]
    for planted, seed in runs:
        t = time.perf_counter()
        c = control_run(workload, config, seed, device, planted)
        more = {"detail": detail(c["evidence"])} if args.detail else {}
        kind = f"{planted} (reference)" if planted else "control"
        print(json.dumps({"kind": kind, "seed": seed, **extra, **c["numbers"],
                          "seconds": time.perf_counter() - t, **more}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
