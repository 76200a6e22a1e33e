#!/usr/bin/env python3
"""Run one cell of the benchmark of the port ``repro_torch`` on the card(s)
of this machine, from the root of a checkout:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (spans, counters and a profiled slice of the window).
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit);
the last lines of standard error repeat the checks.  Exits non-zero, and
prints no result, without enough CUDA devices for the cell, without the
port's sources beside the benchmark, or when JAX or the JAX package was
loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _paths() -> None:
    """The checkout's root (for ``bench``) and ``src`` (for the port) on
    the import path; every build and kernel cache inside the checkout."""
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("the port's sources (src/repro_torch) are not in this "
              "checkout", file=sys.stderr)
        return 2
    from bench.harness.runner import process_start
    t_start = process_start()
    import torch
    from bench.harness.registry import load_cell
    from bench.harness.runner import run_cell
    cell = load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   "cuda", t_start=t_start,
                   log=lambda s: print(s, file=sys.stderr))
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
