"""Two runs of one recipe held row by row: per epoch the largest relative
difference over their train, validation and rollout rows (the time column
aside), the first row outside rtol 1e-4, and how many rows are equal bit
for bit.

    python results/torch_r16_stage2_hold/compare.py <label> <run a> <run b> [last step]
"""

import bisect
import json
import sys

RTOL = 1e-4


def rows(run, last=None):
    """(step, sorted keys) -> row, every row but the time, up to ``last``."""
    with open(f"{run}/metrics.jsonl") as f:
        out = [{k: v for k, v in json.loads(line).items() if k != "time"} for line in f]
    return {(r["step"], tuple(sorted(r))): r for r in out if last is None or r["step"] <= last}


def main(label: str, a: str, b: str, last=None) -> int:
    got, want = rows(a, last), rows(b, last)
    ends = sorted({s for s, keys in want if any(k.startswith("validation/") for k in keys)})
    worst, first, held, equal = {}, None, 0, 0
    for key, row in sorted(got.items()):
        ref = want.get(key)
        if ref is None:
            continue
        held += 1
        equal += row == ref
        epoch = bisect.bisect_left(ends, row["step"])
        for k, v in row.items():
            err = abs(v - ref[k]) / max(abs(ref[k]), 1e-6)
            if err >= worst.get(epoch, (0.0, ""))[0]:
                worst[epoch] = (err, f"{k} at step {row['step']}")
            if err > RTOL and first is None:
                first = f"{k} at step {row['step']}: {v} vs {ref[k]}"
    print(f"{label}: {held} rows held ({len(got)} and {len(want)} rows up to step {last}), {equal} equal bit for bit, "
          f"epochs ending at {ends}")
    for epoch, (err, where) in sorted(worst.items()):
        print(f"{label}: epoch {epoch} largest relative difference {err:.3g} ({where})")
    print(f"{label}: first row outside rtol {RTOL:g}: {first}")
    print(f"{label}: {'every row within' if first is None else 'NOT within'} rtol {RTOL:g}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4]) if len(sys.argv) > 4 else None))
