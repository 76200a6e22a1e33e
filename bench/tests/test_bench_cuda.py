"""On the card (``-m cuda``; skipped elsewhere): every cell at its own size
for a short window comes out correct, and the control (the reference in
float8 in the program's place) fails the cell's limits on the same
sample.  Run from the root of a checkout on an H100:

    python3 -m pytest -q -m cuda bench/tests/test_bench_cuda.py
"""
import json
import subprocess
import sys

import pytest
import torch

from bench.harness import compare
from bench.harness.registry import load_cell
from bench.harness.runner import run_cell
from bench.tests._tiny import ROOT

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run on the H100")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", cell,
                          "--seed", str(2**31 + 77), "--seconds", "10",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(card, cell):
    out = run_cell(load_cell(cell, ROOT), 78, 10.0, False, "cuda",
                   log=lambda s: None, control=True)
    assert out["correct"], out["checks"]
    limits = load_cell(cell, ROOT).workload["compare"]["limits"]
    assert not compare.judge(out["control"], limits)[0], out["control"]
