#!/usr/bin/env python3
"""The spread of each metric over sets of runs, as the bounds are set:

    python3 bench/tools/spread.py SET_A.jsonl SET_B.jsonl ...

Each file holds the last lines of one set's runs (one JSON object a
line).  For each metric and set: the median, and the distance between the
first and the third quartile (``statistics.quantiles(values, n=4)``) as a
share of the median; then the wider of the sets' spreads, and five times
it, the bound that spread suggests (never under 1 %)."""
from __future__ import annotations

import json
import statistics
import sys


def _spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return med, (q3 - q1) / med if med else float("nan")


def main(paths) -> int:
    sets = []
    for p in paths:
        with open(p) as f:
            sets.append([json.loads(line) for line in f if line.strip()])
    names = sorted({m for s in sets for r in s for m in r["metrics"]})
    for name in names:
        spreads = []
        for p, s in zip(paths, sets):
            vals = [r["metrics"][name]["value"] for r in s
                    if name in r["metrics"]]
            if len(vals) < 2:
                continue
            med, sp = _spread(vals)
            spreads.append(sp)
            print(f"{name:32s} {p}: n={len(vals)} median={med:.6g} "
                  f"spread={sp:.4f} values={[round(v, 4) for v in vals]}")
        if spreads:
            wide = max(spreads)
            print(f"{name:32s} widest spread {wide:.4f} -> bound "
                  f"{max(0.01, 5 * wide):.4f}")
    for p, s in zip(paths, sets):
        print(p, "correct:", [r["correct"] for r in s],
              "checks:", [{k: round(v["value"], 5) for k, v in
                           r["checks"].items()} for r in s])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
