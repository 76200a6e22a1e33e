"""A run end to end on the CPU at a tiny size (the harness's look for a
card skipped): the last line's format, the exits without a card or without
the port, a configuration, a cell and a metric added as new files and
found without an edit, and the guard against JAX."""
import ast
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from bench.harness import runner
from bench.harness.registry import load_cell
from bench.tests._tiny import (ROOT, TINY_DENSE, add_cell, add_config,
                               tiny_cell, tiny_tree)

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("bench") / "checkout")


def _run(tree, cell, trace=False, seed=3, seconds=2.0):
    return runner.run_cell(load_cell(cell, tree), seed, seconds, trace,
                           "cpu", log=lambda s: None)


def _valid_line(out, names):
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool)
    assert line["attempted"] > 0 and 0 <= line["failed"] <= line["attempted"]
    assert set(line["metrics"]) == set(names)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert {"platform", "kind", "count", "memory_peak_bytes"} \
        <= set(line["device"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    return line


def test_last_line(tree):
    out = _run(tree, "tiny-dense.chat")
    line = _valid_line(out, ["tpot_p95_ms", "output_tokens_per_s",
                             "setup_s"])
    assert line["correct"]
    assert line["device"]["platform"] == "cpu"


def test_traced_line_has_host_metrics_and_no_device_metric(tree):
    out = _run(tree, "tiny-moe.chat", trace=True, seconds=4.0)
    # on the CPU no device trace: those metrics are left out, not zero
    _valid_line(out, ["engine_host_ms_per_step", "model_decode_step_ms",
                      "model_prefill_ms_per_ktok", "step_mfu"])
    assert "breakdown" not in out


def test_run_py_exits_without_a_card(tree):
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "tiny-dense.chat", "--seed", str(2**31 + 5),
                          "--seconds", "1", "--trace", "0"], cwd=tree,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_run_py_exits_without_the_port(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "mixtral-8x22b-l8.chat", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_new_config_cell_and_metric_need_no_edit(tree, tmp_path):
    root = tmp_path / "copy"
    shutil.copytree(tree, root, symlinks=True)
    add_config(root, dict(TINY_DENSE, name="tiny-other",
                          num_hidden_layers=3))
    add_cell(root, tiny_cell("tiny-other.chat", "tiny-other"))
    (root / "bench" / "metrics" / "requests_done.py").write_text(
        'UNIT = "requests"\n\n\ndef read(rec):\n'
        '    return float(sum(r.done for r in rec.window_requests()))\n')
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["end_to_end"].append({"name": "requests_done", "unit": "requests",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["tiny-other.chat"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = load_cell("tiny-other.chat", root)
    assert cell.config["num_hidden_layers"] == 3
    out = runner.run_cell(cell, 4, 2.0, False, "cpu", log=lambda s: None)
    assert out["metrics"]["requests_done"]["value"] == out["attempted"] \
        - out["failed"]
    assert "requests_done" not in {
        m.name for m in load_cell("tiny-dense.chat", root).end_to_end}


def test_units_match_the_readers():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        src = (ROOT / "bench" / "metrics" / f"{m['name']}.py").read_text()
        assert f'UNIT = "{m["unit"]}"' in src, m["name"]


def test_cells_match_their_files():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        cell = load_cell(w["name"], ROOT)
        assert cell.workload["config"] == w["config"]
        assert cell.config["name"] == w["config"]
        for key in spec["configs"]:
            if key["name"] == w["config"]:
                for k in key["reduced"]:
                    assert k in cell.config["reduced"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in (ROOT / "bench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        names = set(_imports(path))
        assert not names & set(runner.FORBIDDEN), path
        if "reference" in path.parts:
            assert names <= {"__future__", "math", "typing", "torch"}, path
        if "families" in path.parts:
            # a family's reference is under bench/reference; nothing of a
            # family comes from the program it judges
            assert "repro_torch" not in names, path


def test_a_run_loads_no_jax_module(tree):
    code = f"""
import sys
sys.path[:0] = [{str(tree / 'src')!r}, {str(tree)!r}]
from bench.harness import runner
from bench.harness.registry import load_cell
runner.run_cell(load_cell("tiny-moe.chat"), 1, 1.0, False, "cpu",
                log=lambda s: None)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=tree,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]
                            .replace("'", '"')))
    assert "repro_torch" in loaded and "torch" in loaded
    assert not loaded & set(runner.FORBIDDEN)


def test_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert runner.foreign_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy_fake", object())
    assert runner.foreign_modules() == ["jax"]


def test_traced_slices_run_in_the_drain(tree):
    cell = load_cell("tiny-moe.chat", tree)
    w = cell.workload
    model, weights, sizes = runner.setup(cell, 5, "cpu")
    rec, _ = runner.serve(cell, model, weights, sizes, 5, 3.0, True,
                          float(w["lead_in_s"]), float(w["drain_cap_s"]))
    # the window ran untraced: the slices began after it closed, once its
    # requests had their first tokens, and no call in it synchronised
    assert rec.traced_from is not None and rec.traced_from >= rec.window_close
    window = rec.window_requests()
    assert window and all(r.first is not None and r.first <= rec.traced_from
                          for r in window)
    assert rec.untraced_requests() == window
    synced = [c for c in rec.calls if c["synced"]]
    assert synced and all(c["start"] >= rec.traced_from for c in synced)
    assert all(r.done for r in window)


PROGRAM_METRICS = ("decode_issue_ms", "host_syncs_per_step",
                   "kv_gather_live_share")


def test_program_slice_alone_turns_the_tracer_on(tree, monkeypatch):
    from repro_torch import trace
    from bench.harness.registry import load_reader
    switched = []
    for name in ("enable", "disable"):
        orig = getattr(trace, name)
        monkeypatch.setattr(trace, name, lambda orig=orig, name=name: (
            switched.append((name, time.monotonic())), orig())[1])
    cell = load_cell("tiny-moe.chat", tree)
    w = cell.workload
    model, weights, sizes = runner.setup(cell, 6, "cpu")
    rec, _ = runner.serve(cell, model, weights, sizes, 6, 3.0, True,
                          float(w["lead_in_s"]), float(w["drain_cap_s"]))
    assert not trace._state.on
    # once on, once off: after the window and after the span slice's
    # synchronised calls, around the counters' two snapshots
    assert [n for n, _ in switched] == ["enable", "disable"]
    on, off = switched[0][1], switched[1][1]
    assert rec.window_close <= rec.traced_from <= on
    assert all(c["end"] <= on for c in rec.calls if c["synced"])
    assert rec.io_open["t"] <= on <= off <= rec.io_close["t"]
    assert off - on >= float(w["program_span_s"])
    assert rec.spans and all(on <= s.start and s.end <= off
                             for s in rec.spans)
    assert {"engine.step", "model.decode", "engine.upload",
            "engine.read"} <= {s.name for s in rec.spans}
    assert rec.io_close["steps"] > rec.io_open["steps"]
    got = {m: load_reader(m)(rec) for m in PROGRAM_METRICS}
    assert all(isinstance(v, float) and v > 0 for v in got.values()), got
    assert got["kv_gather_live_share"] <= 100.0
    # at least the decode's two uploads and its read, each step that decodes
    assert got["host_syncs_per_step"] >= 1.0


def test_program_readers_read_nothing_untraced(tree):
    from bench.harness.registry import load_reader
    cell = load_cell("tiny-dense.chat", tree)
    w = cell.workload
    model, weights, sizes = runner.setup(cell, 7, "cpu")
    rec, _ = runner.serve(cell, model, weights, sizes, 7, 1.0, False,
                          float(w["lead_in_s"]), float(w["drain_cap_s"]))
    assert rec.spans == [] and rec.io_open is None and rec.io_close is None
    for m in PROGRAM_METRICS:
        assert load_reader(m)(rec) is None, m
