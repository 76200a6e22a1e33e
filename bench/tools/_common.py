"""What the tools share: the import path, and a cell with its rate
replaced."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def with_rate(cell, rate: float):
    out = copy.copy(cell)
    out.workload = dict(cell.workload, rate_per_s=float(rate))
    return out
