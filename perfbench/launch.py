"""The ranks of a cell on more than one chip, one process a card, started by
PyTorch's own launcher as a user's data-parallel run is started:

    python3 -m torch.distributed.run --standalone --nproc_per_node=W perfbench/launch.py <dir>

``torchrun`` gives each rank ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``MASTER_ADDR`` (127.0.0.1 here) and a free ``MASTER_PORT``; where a rank
dies or exits with another status than 0 it ends the others (SIGTERM,
SIGKILL 30 s later) and exits with another status than 0. Each rank runs
``harness.run`` with the arguments in ``<dir>/spec.json``, once for each
of its seeds, writes its process id to ``<dir>/pid<RANK>`` as it starts
and what each ``run`` returned to ``<dir>/rank<RANK>.json``. With more
than one seed (the readings of ``readings.py``) the rank joins the process
group itself, so that each seed's ``train.main`` keeps it, and leaves it
after the last. ``launch`` writes and warms the data set
first, so that the ranks do not race to write it; ``merge`` makes the
result line from rank 0's return, with the peak memory of the fullest
card.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import List, Optional

HERE = Path(__file__).resolve().parent
# a launch still running this long after it started is stopped: the first
# run of a cell in a checkout builds and compiles within 1,200 s
LIMIT_S = 1140.0


def launch(cell_name: str, seeds: List[int], seconds: float, traced: bool, t0: float, world: int, *,
           device: str = "cuda", fault: Optional[str] = None, overrides: Optional[dict] = None,
           evidence: bool = False, workdir: Optional[Path] = None) -> dict:
    """Run ``world`` ranks of a cell under ``torchrun``, a run for each of
    ``seeds``, and wait for them: ``{"rc": torchrun's exit status, "runs":
    for each seed what each rank returned, in rank order, or None where
    the launch failed}``. ``overrides`` (``workload``, ``config``,
    ``data_cache``, ``metrics``) go to each rank's ``harness.run``;
    ``evidence`` adds rank 0's ``readings.detail`` under ``detail``;
    ``workdir`` (kept) is the launch's directory, else a temporary one
    that is removed."""
    from perfbench import data, harness

    overrides = dict(overrides or {})
    config = overrides.get("config") or harness.cell(cell_name)[1]
    cache = overrides.get("data_cache")
    data.warm(data.ensure_store(config["dataset"], **({"cache": Path(cache)} if cache else {})))
    tmp = Path(workdir) if workdir else Path(tempfile.mkdtemp(prefix="perfbench_launch_"))
    tmp.mkdir(parents=True, exist_ok=True)
    spec = {"cell": cell_name, "seeds": list(seeds), "seconds": seconds, "traced": traced, "t0": t0,
            "device": device, "fault": fault, "evidence": evidence, "scratch": str(tmp / "scratch"), **overrides}
    (tmp / "spec.json").write_text(json.dumps(spec, default=str))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={world}",
           "--local-addr=127.0.0.1", str(HERE / "launch.py"), str(tmp)]
    # torchrun's and the ranks' output goes to standard error: the launcher
    # alone prints the result line
    proc = subprocess.Popen(cmd, stdout=sys.stderr)
    try:
        rc = proc.wait(timeout=LIMIT_S)
    except subprocess.TimeoutExpired:
        print("perfbench: the launch ran out of time; stopping it", file=sys.stderr)
        rc = None
    finally:
        # torchrun ends its ranks when it is ended
        if proc.poll() is None:
            proc.terminate()
            proc.wait()
    try:
        runs = None
        if rc == 0:
            runs = list(zip(*(json.loads((tmp / f"rank{r}.json").read_text()) for r in range(world))))
        return {"rc": proc.returncode, "runs": runs}
    finally:
        if not workdir:
            shutil.rmtree(tmp, ignore_errors=True)


def merge(ranks: List[dict]) -> dict:
    """The result line from the ranks' returns: rank 0's, with the peak of
    the fullest card; the ranks have to have closed their windows at one
    step."""
    steps = [r["closed_at"] for r in ranks]
    if len(set(steps)) != 1:
        raise RuntimeError(f"the ranks closed their windows at different steps: {steps}")
    result = dict(ranks[0])
    result.pop("closed_at")
    peak = max(r["device"]["memory_peak_bytes"] if "device" in r else r["memory_peak_bytes"] for r in ranks)
    result["device"] = dict(result["device"], memory_peak_bytes=peak)
    return result


def rank_main(workdir: str) -> int:
    """One rank: ``harness.run`` with the spec's arguments for each of its
    seeds, the returns written to ``rank<RANK>.json`` in ``workdir``."""
    # a rank's standard output goes to standard error: only the launcher
    # prints the result line
    os.dup2(2, 1)
    tmp, rank = Path(workdir), os.environ["RANK"]
    (tmp / f"pid{rank}").write_text(str(os.getpid()))
    spec = json.loads((tmp / "spec.json").read_text())
    from perfbench import harness, readings

    harness.set_cache_dirs()
    seeds = spec["seeds"]
    if len(seeds) > 1:
        from tacorl_tpu_torch.parallel import mesh

        mesh.init_distributed(spec["device"].split(":")[0])
    returns = []
    for seed in seeds:
        r = harness.run(spec["cell"], seed, spec["seconds"], spec["traced"], spec["t0"], device=spec["device"],
                        workload=spec.get("workload"), config=spec.get("config"), data_cache=spec.get("data_cache"),
                        metrics=spec.get("metrics"), fault=spec.get("fault"), evidence=spec["evidence"],
                        scratch=Path(spec["scratch"]) / str(seed))
        if "evidence" in r:
            r["detail"] = readings.detail(r.pop("evidence"))
        returns.append(r)
    (tmp / f"rank{rank}.json").write_text(json.dumps(returns))
    if len(seeds) > 1:
        mesh.destroy_distributed()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(HERE.parent))
    sys.exit(rank_main(sys.argv[1]))
