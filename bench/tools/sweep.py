#!/usr/bin/env python3
"""The rate sweep that finds a cell's knee, in one process:

    python3 bench/tools/sweep.py --workload <cell> --rates 2,3,4,5 \\
        --seconds 20 [--seed 1] [--out sweep.jsonl]

Each rate gets a fresh engine, a lead-in, a window and a drain of the
cell's traffic at that rate.  One JSON line a rate: the cell's end-to-end
metrics and the TTFT tails of the mix and of its interactive class, read
by the benchmark's own readers (``bench/metrics``), the requests still waiting when the window
closed, and the failed ones.  The knee is the highest rate whose backlog
does not grow through the window; the cell runs at about four fifths of
it.
"""
from __future__ import annotations

import argparse
import json
import sys

import _common
import torch

from bench.harness.registry import load_cell, load_reader
from bench.harness.runner import release, serve, setup


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20)
    ap.add_argument("--lead", type=float, default=5)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    base = load_cell(args.workload, _common.ROOT)
    tails = {name: load_reader(name)
             for name in ("ttft_p95_ms", "sched_interactive_ttft_p95_ms")}
    model, weights, sizes = setup(base, args.seed, args.device)
    out = open(args.out, "a") if args.out else None
    for rate in (float(r) for r in args.rates.split(",")):
        cell = _common.with_rate(base, rate)
        rec, eng = serve(cell, model, weights, sizes, args.seed,
                         args.seconds, False, args.lead,
                         float(cell.workload["drain_cap_s"]))
        win = rec.window_requests()
        line = {"workload": cell.name, "rate": rate, "attempted": len(win),
                "failed": sum(1 for r in win if not r.done),
                "no_first_token_at_close": sum(
                    1 for r in win
                    if r.first is None or r.first > rec.window_close),
                **{m.name: m.read(rec) for m in cell.end_to_end
                   if m.name != "setup_s"},
                **{name: read(rec) for name, read in tails.items()},
                "waiting_at_close": rec.waiting_at_close,
                "steps": len(rec.steps)}
        if torch.cuda.is_available():
            line["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
            line["device"] = torch.cuda.get_device_name(0)
        del eng
        release()
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
