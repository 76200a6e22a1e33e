"""The port's dry run: the reference's pure functions (skip records, input
and cache layouts, ``model_flops``) against the port's; a scaled cell of
every family traced on a fake 16-rank world; ``analyze_cell``'s
extrapolation against a direct count; ``collective_bytes`` on known
collectives; the CLI's file names and keys.

The reference's dry run fixes its 512 host devices when it is imported
(``XLA_FLAGS``), so its side runs in a subprocess."""
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro.configs import get_config as jax_get_config
from repro.launch import analyze as ref_analyze
from repro.launch.input_specs import SHAPES as REF_SHAPES
from repro_torch.configs import get_config, list_configs, scale_down
from repro_torch.launch import dryrun
from repro_torch.launch.analyze import analyze_cell, model_flops
from repro_torch.launch.hlo_stats import (DTYPE_BYTES, TraceCounter,
                                          collective_bytes)
from repro_torch.launch.input_specs import (SHAPES, ShapeCell,
                                            cell_is_applicable, input_specs)
from repro_torch.launch.mesh import fake_world, make_host_mesh
from repro_torch.models import build_model
from repro_torch.tree import tree_leaves, tree_leaves_with_path

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")

#: the reference's side: skip records, input specs and decode-cache shapes
#: and specs for every config, cell and mesh
_REF = r'''
import json
from repro.launch import dryrun as d
import jax
from repro.configs import get_config, list_configs
from repro.models import build_model
from repro.launch.input_specs import SHAPES, cell_is_applicable, input_specs

def spec(s):
    return [list(a) if isinstance(a, tuple) else a for a in s.spec]

from repro.launch import hillclimb
out = {"skip": {}, "inputs": {}, "cache": {},
       "variants": {k: list(v) for k, v in hillclimb.VARIANTS.items()}}
meshes = {m: d.make_production_mesh(multi_pod=m) for m in (False, True)}
for arch in list_configs():
    cfg = get_config(arch)
    model = build_model(cfg)
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    for cell in SHAPES:
        for multi, mesh in meshes.items():
            key = f"{arch}|{cell.name}|{int(multi)}"
            if not cell_is_applicable(cfg, cell)[0]:
                out["skip"][key] = d.run_cell(arch, cell.name, multi)
                continue
            batch = input_specs(cfg, cell)
            out["inputs"][key] = {k: spec(v) for k, v in
                                  d._input_shardings(batch, mesh).items()}
            if cell.kind != "decode" or cfg.family == "encdec":
                continue
            ctx = input_specs(cfg, cell.__class__(
                name="ctx", seq_len=cell.seq_len,
                global_batch=cell.global_batch, kind="prefill"))
            cache = jax.eval_shape(
                lambda p, b: model.prefill(p, b, cell.seq_len), params,
                ctx)[1]
            sh = d._cache_shardings(cache, mesh, cell.global_batch,
                                    cell.seq_len)
            out["cache"][key] = [[list(x.shape), spec(s)] for x, s in zip(
                jax.tree.leaves(cache), jax.tree.leaves(sh))]
print(json.dumps(out))
'''


class _FakeMesh:
    def __init__(self, **shape):
        self.shape = shape


MESHES = {0: _FakeMesh(data=16, model=16),
          1: _FakeMesh(pod=2, data=16, model=16)}


def _spec(s):
    return tuple(tuple(a) if isinstance(a, list) else a for a in s)


@pytest.fixture(scope="module")
def reference():
    out = subprocess.run([sys.executable, "-c", _REF], env=ENV,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout)


def test_skip_records_equal_the_reference(reference):
    assert reference["skip"]
    for key, want in reference["skip"].items():
        arch, shape, multi = key.split("|")
        assert dryrun.run_cell(arch, shape, bool(int(multi))) == want, key


def test_input_specs_equal_the_reference(reference):
    assert reference["inputs"]
    for key, want in reference["inputs"].items():
        arch, shape, multi = key.split("|")
        cell = next(c for c in SHAPES if c.name == shape)
        batch = input_specs(get_config(arch), cell)
        got = {k: dryrun._input_spec(v, MESHES[int(multi)])
               for k, v in batch.items()}
        # a PartitionSpec shorter than the rank replicates the rest
        assert got == {k: _spec(v) + (None,) * (batch[k].ndim - len(v))
                       for k, v in want.items()}, key


def test_cache_specs_equal_the_reference(reference):
    """Where the decode cache's leaves have the reference's shapes (in the
    reference's leaf order), their layouts are the reference's."""
    assert reference["cache"]
    for key, want in reference["cache"].items():
        arch, shape, multi = key.split("|")
        cfg = get_config(arch)
        cell = next(c for c in SHAPES if c.name == shape)
        model = build_model(cfg, "cpu")
        cache = dryrun._decode_cache(model, None, cfg, cell,
                                     cell.global_batch)
        leaves = tree_leaves(cache)
        assert [list(x.shape) for x in leaves] == [w[0] for w in want], key
        for x, (_, spec) in zip(leaves, want):
            assert dryrun._cache_spec(x, MESHES[int(multi)],
                                      cell.global_batch) == _spec(spec), key


def test_model_flops_equal_the_reference():
    assert [c.name for c in SHAPES] == [c.name for c in REF_SHAPES]
    for arch in list_configs():
        for cell, ref_cell in zip(SHAPES, REF_SHAPES):
            assert model_flops(get_config(arch), cell) == \
                ref_analyze.model_flops(jax_get_config(arch), ref_cell), \
                (arch, cell.name)


# -- tracing ------------------------------------------------------------------

#: one scaled config of each family, and small cells of each kind
FAMILIES = {"dense": "qwen2-1.5b", "moe": "mixtral-8x22b",
            "vlm": "internvl2-26b", "ssm": "rwkv6-3b",
            "hybrid": "jamba-v0.1-52b", "encdec": "seamless-m4t-medium"}
CELLS = [ShapeCell("t", 64, 8, "train"), ShapeCell("p", 64, 8, "prefill"),
         ShapeCell("d", 64, 8, "decode")]


@pytest.mark.parametrize("family", FAMILIES)
def test_scaled_cell_of_each_family_traces(family):
    """Every kind of step of each family traces on a 4×4 mesh of a fake
    16-rank world: FLOPs and bytes counted, collectives issued, and the
    local argument bytes below the global ones."""
    cfg = scale_down(get_config(FAMILIES[family]))
    assert cfg.family == family
    with fake_world(16):
        mesh = make_host_mesh(4, 4, "cpu")
        for cell in CELLS:
            fn, args = dryrun.build_step(cfg, cell, mesh, None, "tp",
                                         cell.global_batch, 1)
            cost = dryrun.trace_step(fn, args)
            assert cost["flops"] > 0 and cost["bytes_accessed"] > 0, cell
            assert cost["collective_bytes"]["total"] > 0, cell
            glob = sum(x.numel() * x.element_size()
                       for x in tree_leaves(args)
                       if isinstance(x, torch.Tensor))
            assert 0 < cost["argument_bytes"] < glob, cell


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_analyze_extrapolates_a_homogeneous_stack_exactly(kind):
    """The 1- and 2-layer traces (and their 2-microbatch twins) give the
    FLOPs of a direct trace of the 4-layer stack, exactly."""
    cfg = scale_down(get_config("qwen2-1.5b"), layers=4)
    cell = ShapeCell("c", 32, 8, kind)
    with fake_world(4):
        mesh = make_host_mesh(2, 2, "cpu")
        res = analyze_cell(cfg, cell, mesh, None, n_micro=2)
        fn, args = dryrun.build_step(cfg, cell, mesh, None, "tp", 8,
                                     2 if kind == "train" else 1)
        direct = dryrun.trace_step(fn, args)
    assert res["extrapolated"]["flops"] == direct["flops"]
    assert set(res["points"]) == ({"A", "B", "C", "D"} if kind == "train"
                                  else {"A", "B"})


def test_collective_bytes_count_known_collectives():
    with fake_world(4):
        mesh = make_host_mesh(2, 2, "cpu")
        x = DTensor.from_local(torch.zeros(3, 16), mesh,
                               [Shard(0), Replicate()], run_check=False)
        p = DTensor.from_local(torch.zeros(5, dtype=torch.bfloat16), mesh,
                               [Replicate(), Partial()], run_check=False)
        with TraceCounter() as tc:
            x.redistribute(mesh, [Replicate(), Replicate()])
            p.redistribute(mesh, [Replicate(), Replicate()])
    got = collective_bytes(tc.records)
    assert got == {"all-gather": 3 * 16 * 4, "all-reduce": 5 * 2,
                   "reduce-scatter": 0, "all-to-all": 0,
                   "collective-permute": 0, "collective-broadcast": 0,
                   "total": 3 * 16 * 4 + 5 * 2}
    assert DTYPE_BYTES["bf16"] == 2 and DTYPE_BYTES["f32"] == 4


def test_trace_counts_local_flops():
    """A matmul of a row-sharded activation by a column-sharded weight:
    each rank's FLOPs are its shard's."""
    with fake_world(4):
        mesh = make_host_mesh(2, 2, "cpu")
        a = DTensor.from_local(torch.zeros(4, 32), mesh,
                               [Shard(0), Replicate()], run_check=False)
        w = DTensor.from_local(torch.zeros(32, 8), mesh,
                               [Replicate(), Shard(1)], run_check=False)
        with TraceCounter() as tc:
            a @ w
    assert tc.flops == 2 * 4 * 32 * 8
    assert tc.records == []


# -- the CLI ------------------------------------------------------------------

#: the reference's record keys (repro/launch/dryrun.py: run_cell), with
#: the port's ``trace_s``
OK_KEYS = {"arch", "shape", "mesh", "kind", "layout", "status",
           "param_bytes", "fsdp", "flops", "bytes_accessed",
           "collective_bytes", "memory", "lower_s", "compile_s", "trace_s"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
               "alias_bytes", "code_bytes"}
COLL_KEYS = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute", "collective-broadcast", "total"}


def test_cli_writes_the_reference_s_files_and_keys(tmp_path):
    out = tmp_path / "dry"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen2-1.5b", "--shape", "long_500k",
                     "--out", str(out), "--layout", "dp", "--policy",
                     "arrival", "--tag", "v1"])
    assert e.value.code == 0
    names = sorted(p.name for p in out.iterdir())
    assert names == [
        f"qwen2-1.5b__long_500k__{m}__arrival__dp__v1.json"
        for m in ("multi", "single")]
    rec = json.loads((out / names[1]).read_text())
    assert rec == {"arch": "qwen2-1.5b", "shape": "long_500k",
                   "mesh": "16x16", "kind": "decode", "status": "skipped",
                   "reason": cell_is_applicable(
                       get_config("qwen2-1.5b"), SHAPES[3])[1]}
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen2-1.5b", "--shape", "decode_32k",
                     "--mesh", "single", "--out", str(out)])
    assert e.value.code == 0
    rec = json.loads((out / "qwen2-1.5b__decode_32k__single.json"
                      ).read_text())
    assert set(rec) == OK_KEYS and rec["status"] == "ok"
    assert set(rec["memory"]) == MEMORY_KEYS
    assert set(rec["collective_bytes"]) == COLL_KEYS
    assert rec["lower_s"] is None and rec["compile_s"] is None
    assert rec["memory"]["code_bytes"] is None
    params = dryrun.shape_only_params(build_model(get_config("qwen2-1.5b"),
                                                  "cpu"))
    assert rec["param_bytes"] == sum(x.numel() * x.element_size()
                                     for _, x in tree_leaves_with_path(
                                         params))


def test_hillclimb_variants_are_the_reference_s(reference):
    from repro_torch.launch.hillclimb import VARIANTS
    assert {k: list(v) for k, v in VARIANTS.items()} == reference["variants"]


def test_hillclimb_runs_a_variant(tmp_path, capsys):
    """One variant of a cell through ``hillclimb.main``: the record with its
    analysis and model FLOPs, the summary line, and the cached file."""
    from repro_torch.launch import hillclimb
    hillclimb.main(["--arch", "qwen2-1.5b", "--shape", "decode_32k",
                    "--variants", "baseline", "--out", str(tmp_path)])
    line = capsys.readouterr().out
    assert "qwen2-1.5b×decode_32k [        baseline] compute=" in line
    rec = json.loads((tmp_path / "qwen2-1.5b__decode_32k__baseline.json"
                      ).read_text())
    assert rec["status"] == "ok" and set(rec["analysis"]["points"]) == {
        "A", "B"}
    assert rec["model_flops"] == model_flops(get_config("qwen2-1.5b"),
                                             SHAPES[2])
    # the extrapolation of the 28-layer decode from 1 and 2 layers is the
    # whole trace's count
    assert rec["analysis"]["extrapolated"]["flops"] == rec["flops"]
