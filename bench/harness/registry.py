"""Find every piece of a cell by name, so that a configuration, a traffic
mix, a cell or a metric is added as new files and never by an edit here.

Layout, from the root of a checkout:

* ``BENCHMARK.json``: the cells, which configuration and traffic mix each
  names, and the metrics each reports (an entry's ``workloads`` key, or
  every cell);
* ``bench/configs/<config>.json``: the sizes as run, with ``family``,
  ``source``, ``reduced``, ``assumed`` and ``deployment``;
* ``bench/families/<family>.py``: the architecture: the port's fields and
  the sizes read from the configuration file, the weight tree, the plain
  reference, the model FLOPs and the attention-layer count
  (``bench/families/__init__.py``);
* ``bench/workloads/<cell>.json``: the rate, the engine's settings, the
  phases of a run and the limits of the comparison;
* ``bench/traffic/<traffic>.json``: the classes of the mix, read by the one
  generator in ``harness/traffic.py``;
* ``bench/metrics/<metric>.py``: one reader a metric, ``read(run)``.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Callable, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Metric:
    name: str
    unit: str
    read: Callable


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    workload: dict
    traffic: dict
    family: ModuleType
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(kind: str, name: str, bench_dir: Path) -> ModuleType:
    """``bench/<kind>/<name>.py``, loaded by path."""
    path = bench_dir / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str, bench_dir: Path = BENCH_DIR) -> Callable:
    """``read`` of ``bench/metrics/<name>.py``."""
    return _module("metrics", name, bench_dir).read


def load_family(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The architecture family ``bench/families/<name>.py``."""
    return _module("families", name, bench_dir)


def _metrics(entries: List[dict], cell: str, bench_dir: Path
             ) -> List[Metric]:
    out = []
    for m in entries:
        if "workloads" in m and cell not in m["workloads"]:
            continue
        out.append(Metric(m["name"], m["unit"],
                          load_reader(m["name"], bench_dir)))
    return out


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its configuration,
    workload and traffic files, its configuration's family and the readers
    of its metrics."""
    bench_dir = root / "bench"
    spec = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: "
                       f"{', '.join(sorted(cells))})")
    entry = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _json(root / configs[entry["config"]]["file"])
    workload = _json(bench_dir / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise ValueError(f"{name}: BENCHMARK.json names {key} "
                             f"{entry[key]!r}, the cell's file "
                             f"{workload[key]!r}")
    traffic = _json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    return Cell(name, int(entry["chips"]), config, workload, traffic,
                load_family(config["family"], bench_dir),
                _metrics(spec["end_to_end"], name, bench_dir),
                _metrics(spec["per_layer"], name, bench_dir))
