"""The port's examples (``examples_torch/``) against the reference's
(``examples/``).  Each reference script runs unedited through ``runpy`` as
``__main__``, its models in fp32 on the CPU (``scale_down`` patched to add
fp32), and its globals are read back; its weights cross to the port
through numpy, and the port's example functions run on them.  The same
greedy tokens, batcher metrics, allocator state, steal counts, prefix
sums, UTS node counts, pop order and speculative stream come out.  Each
model-building script fails loudly without a CUDA device unless asked for
the CPU."""
import importlib.util
import os
import pathlib
import runpy
import subprocess
import sys

import jax
import numpy as np
import pytest

import repro.configs as jax_configs
from repro_torch.configs import get_config, scale_down
from repro_torch.core import StrategyScheduler, WorkStealingScheduler
from repro_torch.models import build_model
from repro_torch.params import from_numpy_params

from _torch_parity import assert_same_config

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "examples"
PORT = ROOT / "examples_torch"
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
FP32 = dict(dtype="float32", param_dtype="float32")
#: the serving examples' model, as the reference scripts scale it
SERVE_SCALE = dict(layers=4, d_model=128, d_ff=512, vocab=4096)


def _port(name: str):
    """The port's example ``name`` as a module (not run as a script)."""
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", PORT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference(name: str, *argv) -> dict:
    """Run ``examples/<name>.py`` as ``__main__`` with ``argv`` and its
    configs in fp32; returns the script's globals."""
    scale = jax_configs.scale_down
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_configs, "scale_down",
                   lambda *a, **k: scale(*a, **k).replace(**FP32))
        mp.setattr(sys, "argv", [str(REF / f"{name}.py"), *argv])
        return runpy.run_path(str(REF / f"{name}.py"), run_name="__main__")


def _bridge(ref: dict, **scale):
    """The port's model on the CPU with the reference run's weights."""
    cfg = scale_down(get_config("qwen2-1.5b"), **scale).replace(**FP32)
    assert_same_config(ref["cfg"], cfg)
    model = build_model(cfg, "cpu")
    tree = jax.tree.map(np.asarray, ref["params"])
    return model, from_numpy_params(tree, cfg, "cpu")


def _tokens(outs) -> list:
    return [int(t) for t in outs]


# -- quickstart ---------------------------------------------------------------

@pytest.mark.parametrize("sched_cls, use_strategy, label", [
    (WorkStealingScheduler, False, "standard work-stealing"),
    (StrategyScheduler, False, "strategy sched (LIFO/FIFO)"),
    (StrategyScheduler, True, "strategy sched (best-first)")],
    ids=["work-stealing", "lifo-fifo", "best-first"])
def test_quickstart_one_place_matches_reference(capsys, sched_cls,
                                                use_strategy, label):
    """At one place the scheduler is deterministic: the same optimum and
    the same metrics line as the reference's ``run``."""
    ref = _reference("quickstart")
    capsys.readouterr()
    want_best = ref["run"](ref[sched_cls.__name__](num_places=1),
                           use_strategy, label)
    want = capsys.readouterr().out
    got_best = _port("quickstart").run(sched_cls(num_places=1),
                                       use_strategy, label)
    got = capsys.readouterr().out
    assert got_best == want_best
    assert got == want
    assert got.startswith(label) and "best=" in got


def test_quickstart_four_places_exits_0():
    out = subprocess.run([sys.executable, str(PORT / "quickstart.py")],
                         env=ENV, cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.count("best=") == 3


# -- serve_requests -----------------------------------------------------------

@pytest.fixture(scope="module")
def serve_requests():
    ref = _reference("serve_requests")
    model, params = _bridge(ref, **SERVE_SCALE)
    return ref, _port("serve_requests").serve(model, params)


def test_serve_requests_tokens_match_reference(serve_requests):
    ref, got = serve_requests
    order = ref["interactive"] + ref["batchy"]
    want = [_tokens(ref["outs"][r.rid]) for r in order]
    have = [_tokens(got["outs"][r.rid])
            for r in got["interactive"] + got["batchy"]]
    assert have == want
    assert [len(t) for t in have] == [8] * 6 + [16] * 10
    assert not got["outs"].get(got["cancelled"].rid)


def test_serve_requests_metrics_match_reference(serve_requests):
    ref, got = serve_requests
    keys = ("merged_prefills", "evicted_dead", "steps")
    want, have = ref["eng"].batcher.metrics, got["eng"].batcher.metrics
    assert {k: have[k] for k in keys} == {k: want[k] for k in keys}
    assert got["eng"].paged and ref["eng"].paged
    assert got["eng"].alloc.free_tokens == ref["eng"].alloc.free_tokens
    assert got["eng"].alloc.total_blocks == ref["eng"].alloc.total_blocks
    assert got["tel"].class_percentiles(0.0)["count"] == 6
    assert got["tel"].class_percentiles(1.0)["count"] == 10


# -- serve_cluster ------------------------------------------------------------

@pytest.fixture(scope="module")
def serve_cluster():
    ref = _reference("serve_cluster")
    model, params = _bridge(ref, **SERVE_SCALE)
    return ref, _port("serve_cluster").serve(model, params)


def _cluster_tokens(replicas, reqs) -> list:
    out = []
    for r in reqs:
        owners = [_tokens(rep.engine.outputs[r.rid]) for rep in replicas
                  if r.rid in rep.engine.outputs]
        assert len(owners) == 1
        out.append(owners[0])
    return out


def test_serve_cluster_tokens_match_reference(serve_cluster):
    ref, got = serve_cluster
    want = _cluster_tokens(ref["replicas"], ref["reqs"])
    have = _cluster_tokens(got["replicas"], got["reqs"])
    assert have == want
    assert [len(t) for t in have] == [6] * 6 + [12, 4] * 4
    assert got["dead"].generated == 0


def test_serve_cluster_steals_match_reference(serve_cluster):
    ref, got = serve_cluster
    want, have = ref["tel"].summary(), got["router"].telemetry.summary()
    assert have["steal_events"] == want["steal_events"] > 0
    assert have["requests_migrated"] == want["requests_migrated"]
    assert [r["finished"] for r in have["per_replica"]] == \
        [r["finished"] for r in want["per_replica"]]
    for rep in got["replicas"]:
        rep.engine.alloc.check()


# -- compose_workloads --------------------------------------------------------

@pytest.fixture(scope="module")
def compose():
    """The reference's run without and with ``--spec`` (whose demo rebinds
    the global ``s``), and the port's acts and demo."""
    ref = _reference("compose_workloads")
    spec = _reference("compose_workloads", "--spec")
    mod = _port("compose_workloads")
    model, params = _bridge(spec)
    return ({**spec, "s": ref["s"]}, mod.compose(), mod.pop_order(),
            mod.spec_demo(model, params))


def test_compose_sums_and_nodes_match_reference(compose):
    ref, got, _, _ = compose
    assert got["state"].out.dtype == ref["s"].out.dtype == np.int64
    assert np.array_equal(got["x"], ref["x"])
    assert np.array_equal(got["state"].out, ref["s"].out)
    assert got["uts"]["nodes"] == ref["r_uts"]["nodes"] \
        == int(got["counts"].sum()) == int(ref["counts"].sum())


def test_compose_pop_order_matches_reference(compose):
    ref, _, order, _ = compose
    assert order == ref["order"] == ["VerifyStrategy", "RequestStrategy",
                                     "DraftStrategy"]


def test_compose_spec_matches_reference(compose):
    ref, _, _, got = compose
    want = [_tokens(ref["outs"][r.rid]) for r in ref["reqs"]]
    assert [_tokens(got["outs"][r.rid]) for r in got["reqs"]] == want
    assert [_tokens(got["base"][r.rid]) for r in got["base_reqs"]] == want
    assert got["eng"].spec_stats == ref["eng"].spec_stats
    assert got["eng"].spec_stats["rounds"] > 0


# -- train_lm -----------------------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["--hundred-m", "--steps", "7"]],
                         ids=["default", "hundred-m"])
def test_train_lm_command_matches_reference(monkeypatch, flags):
    """The port starts the reference's command, its launcher renamed and
    ``--device`` added."""
    calls = []
    monkeypatch.setattr(subprocess, "call",
                        lambda cmd, **kw: calls.append(cmd) or 0)
    with pytest.raises(SystemExit) as ref_exit:
        _reference("train_lm", *flags, "--ckpt-dir", "ck")
    with pytest.raises(SystemExit) as port_exit:
        _port("train_lm").main([*flags, "--ckpt-dir", "ck",
                                "--device", "cpu"])
    assert ref_exit.value.code == port_exit.value.code == 0
    want, got = calls
    assert want[1:3] == ["-m", "repro.launch.train"]
    assert got == [*want[:2], "repro_torch.launch.train", *want[3:],
                   "--device", "cpu"]


def test_train_lm_resumes_on_cpu(tmp_path):
    cmd = [sys.executable, str(PORT / "train_lm.py"), "--device", "cpu",
           "--ckpt-dir", str(tmp_path / "ckpt")]
    first = subprocess.run(cmd + ["--steps", "2"], env=ENV, cwd=tmp_path,
                           capture_output=True, text=True, timeout=300)
    assert first.returncode == 0, first.stdout + first.stderr
    assert "resumed" not in first.stdout and "step     1" in first.stdout
    second = subprocess.run(cmd + ["--steps", "3"], env=ENV, cwd=tmp_path,
                            capture_output=True, text=True, timeout=300)
    assert second.returncode == 0, second.stdout + second.stderr
    assert "resumed from step 2" in second.stdout
    assert "step     2" in second.stdout


# -- the device ---------------------------------------------------------------

#: each model-building script, as a user starts it on the card
NO_DEVICE = {"serve_requests": [], "serve_cluster": [],
             "compose_workloads": ["--spec"], "train_lm": ["--steps", "1"]}


@pytest.fixture(scope="module")
def without_cuda(tmp_path_factory):
    """Every script of NO_DEVICE run at once with no CUDA device visible
    and no ``--device cpu``; name -> (exit code, stdout, stderr)."""
    cwd = tmp_path_factory.mktemp("no_cuda")
    procs = {name: subprocess.Popen(
        [sys.executable, str(PORT / f"{name}.py"), *argv],
        env=dict(ENV, CUDA_VISIBLE_DEVICES=""), cwd=cwd,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, argv in NO_DEVICE.items()}
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=120)
        out[name] = (proc.returncode, stdout, stderr)
    return out


@pytest.mark.parametrize("name", sorted(NO_DEVICE))
def test_example_without_cuda_fails_loudly(without_cuda, name):
    """Exit 1 with "no CUDA device", never a quiet run on the CPU."""
    rc, stdout, stderr = without_cuda[name]
    assert rc == 1, stdout + stderr
    assert "no CUDA device" in stderr
    assert "tok/s" not in stdout and "loss=" not in stdout
