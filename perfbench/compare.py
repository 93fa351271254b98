"""The numbers that decide ``correct``, and their limits.

For the first three train steps, program against reference from the same
weights and batches:

* ``loss_gap``: the largest gap of a step's loss (each loss the step
  reports), relative to the largest magnitude the reference's loss takes
  over the steps;
* ``grad_gap``: the worst leaf's gap between the norms of the first
  step's gradient, the program's worked out from its Adam state after one
  step (the first moment is (1 - beta1) times the gradient), relative to
  the larger of the reference leaf's norm and the median leaf's;
* ``change_gap``: the worst leaf's gap between the norms of the parameters'
  change over the three steps, relative to the larger of the reference
  leaf's and the median leaf's, over the leaves whose reference gradient
  is at least a thousandth of the median leaf's (a leaf with a gradient
  nought to rounding moves under Adam by round-off alone);
* ``follow_gap``, where the reference moves leaves it takes no gradient
  of (Polyak targets): the worst such leaf's gap between the norms of
  their change, relative to the larger of its reference change and the
  median of theirs;
* ``first_loss_gap``: ``loss_gap`` at the first step alone, before any
  update, so that it reads the forward pass's rounding and not Adam's
  first steps, whose signs round-off decides where a gradient is tiny;
* ``grad_diff``: the worst leaf's norm of the difference between the
  program's first-step gradient (from its Adam state, as ``grad_gap``
  takes it) and the reference's, relative to the larger of the reference
  leaf's norm and the median leaf's, over the leaves ``change_gap``
  holds; ``grad_diff.median``: the median leaf's. Round-off moves a
  gradient's direction at first order and its norm only at second, so a
  lower precision shows here where the gaps of norms hide it;
* ``rank_gap``, where the program ran on more than one rank: the worst
  leaf's norm of a rank's parameters less rank 0's after step 3, over
  every rank, relative to the larger of the reference leaf's change and
  the median leaf's (the leaves ``change_gap`` holds). Every rank applies
  the same averaged gradients to the same state, so sound ranks agree.

``loss_gap.<loss>`` and ``first_loss_gap.<loss>`` give each loss's gap.

A leaf the reference trains and the program does not reads 1.
"""

from __future__ import annotations

import math
import statistics
import sys
from typing import Dict

import torch

NEGLIGIBLE = 1e-3


def norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _rel(a: float, r: float, scale: float) -> float:
    gap = abs(a - r) / max(abs(r), scale, 1e-30)
    return gap if math.isfinite(gap) else math.inf


def numbers(program: dict, ref: dict, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    per_loss, first = {}, {}
    for k, values in ref["losses"].items():
        values = [float(v) for v in values]
        scale = max(abs(v) for v in values)
        gaps = [_rel(float(got) if got is not None else math.inf, r, scale)
                for r, got in ((r, program["losses"].get(i + 1, {}).get(k)) for i, r in enumerate(values))]
        per_loss[k], first[k] = max(gaps), gaps[0]
    loss_gap = max(per_loss.values())

    rg = {n: norm(g) for n, g in ref["grads"].items()}
    med = statistics.median(rg.values())
    scale = 1.0 - program["beta1"]
    moments = program["moments"] or {}
    grad_gap = max(_rel(norm(moments[n]) / scale if n in moments else 0.0, r, med) for n, r in rg.items())

    moved = [n for n, r in rg.items() if r >= NEGLIGIBLE * med]
    params = program["params"] or {}
    rc = {n: norm(ref["params"][n] - start[n]) for n in moved}
    medc = statistics.median(rc.values())
    change_gap = max(_rel(norm(params[n] - start[n]) if n in params else 0.0, rc[n], medc) for n in moved)
    diffs = sorted(_rel(norm(moments[n] / scale - ref["grads"][n]) if n in moments else rg[n], 0.0, max(rg[n], med))
                   for n in moved)
    out = {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
           "first_loss_gap": max(first.values()), "grad_diff": diffs[-1],
           "grad_diff.median": statistics.median(diffs)}
    out.update({f"loss_gap.{k}": v for k, v in per_loss.items()})
    out.update({f"first_loss_gap.{k}": v for k, v in first.items()})

    if program.get("rank_norms"):
        out["rank_gap"] = max(_rel(norms[n], 0.0, max(rc[n], medc)) for norms in program["rank_norms"] for n in moved)

    follow = {n: norm(ref["params"][n] - start[n]) for n in ref["params"] if n not in rg}
    follow = {n: c for n, c in follow.items() if c > 0.0}
    if follow:
        medf = statistics.median(follow.values())
        out["follow_gap"] = max(_rel(norm(params[n] - start[n]) if n in params else 0.0, c, medf)
                                for n, c in follow.items())
    return out


def judge(values: Dict[str, float], limits: Dict[str, float]) -> dict:
    """Each number beside its limit; correct when none is over it. The
    numbers and limits go to standard error as the run's last lines."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return {"correct": correct, "checks": checks}


def report(checks: dict) -> None:
    for k, c in checks.items():
        print(f"{k} {c['value']:.6g} limit {c['limit']:.6g}", file=sys.stderr)


def as_program(out: dict, beta1: float = 0.9) -> dict:
    """A reference run's outputs in the shape of what the probe copies from
    the program: per-step losses, the first moments after step 1 (Adam's
    first moment after one step is (1 - beta1) times the gradient) and the
    parameters after the last step."""
    n = len(next(iter(out["losses"].values())))
    return {
        "losses": {i + 1: {k: v[i] for k, v in out["losses"].items()} for i in range(n)},
        "moments": {k: g * (1.0 - beta1) for k, g in out["grads"].items()},
        "beta1": beta1,
        "params": out["params"],
    }
