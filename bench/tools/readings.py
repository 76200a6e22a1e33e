#!/usr/bin/env python3
"""The comparison's numbers over many seeds in one process, for the
program and for its control (the reference in float8 in the program's
place), at the cell's own size and load:

    python3 bench/tools/readings.py --workload <cell> --seeds 1,2,3 \\
        --seconds 51 [--control] [--out readings.jsonl]

Each seed is one run of the cell as the benchmark makes it
(``runner.run_cell``: weights from the seed, a fresh engine, lead-in,
window, drain, the sample and the fp32 reference), with the control's
numbers on the same sample where asked.  One JSON line a seed: the run's
end-to-end metrics (``setup_s`` left out: only the first seed pays the
process's start), every number of the comparison, and the control's.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import _common
import torch

from bench.harness.registry import load_cell
from bench.harness.runner import run_cell


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    cell = load_cell(args.workload, _common.ROOT)
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        log = []
        res = run_cell(cell, seed, args.seconds, False, args.device,
                       log=log.append, control=args.control)
        res["metrics"].pop("setup_s", None)
        line = {"workload": cell.name, "seed": seed,
                "seconds": args.seconds, **res, "log": log,
                "wall_s": time.monotonic() - t0}
        if torch.cuda.is_available():
            line["device"] = torch.cuda.get_device_name(0)
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
