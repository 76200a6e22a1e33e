"""The production dry run: trace the train, prefill and decode steps of
every (architecture x input shape) cell on the 16×16 and 2×16×16 meshes,
with no device.

The PyTorch counterpart of ``repro/launch/dryrun.py``, which lowers and
compiles each step with XLA for 512 placeholder host devices.  Here the
ranks are a fake process group of 256 or 512 (``mesh.fake_world``), in
which this process is rank 0 and collectives move no data; parameters,
optimizer state, inputs and caches are ``meta`` DTensors (shapes, no
storage) placed by the reference's rules; and the step runs once under
``hlo_stats.TraceCounter``, which counts what rank 0 would do:

* ``flops``: the local ops' FLOPs (``torch.utils.flop_counter``);
* ``bytes_accessed``: every local op's input and output bytes, unfused,
  an upper bound (as XLA's CPU count is of the TPU's fused traffic);
* ``collective_bytes``: each collective DTensor issues, by kind;
* ``memory.argument_bytes`` / ``output_bytes``: the local shards' bytes
  of the step's arguments and outputs.

Keys with no PyTorch counterpart stay in the record as ``null``:
``temp_bytes`` (no live-bytes tracker runs), ``alias_bytes`` (no buffer
donation), ``code_bytes`` (no compiled program), and ``lower_s`` and
``compile_s`` (nothing is lowered or compiled: ``trace_s`` is the time of
the traced step, placement included).  A cell the port cannot trace is
written with ``status: "error"`` and its exception.

    python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape decode_32k
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs import get_config, list_configs
from ..models import build_model
from ..optim.adamw import AdamWState, adamw_init
from ..sharding.partition import (Sharding, distribute, mesh_sizes,
                                  param_shardings, param_specs,
                                  placements_for)
from ..train.step import (make_decode_step, make_prefill_step,
                          make_train_step)
from ..tree import tree_leaves, tree_map
from .hlo_stats import TraceCounter, collective_bytes
from .input_specs import (SHAPES, ShapeCell, cell_is_applicable,
                          input_specs, shape_by_name, train_microbatches)
from .mesh import fake_world, make_production_mesh

__all__ = ["run_cell", "build_step", "trace_step", "fsdp_axes",
           "shape_only_params", "main"]

#: parameter-byte threshold above which parameters are FSDP-sharded over the
#: data axes in addition to tensor/expert parallelism.
_FSDP_PARAM_BYTES = 40e9


def _data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh_sizes(mesh))


def _axes_spec(axes: Tuple[str, ...]):
    return axes if len(axes) > 1 else axes[0]


def fsdp_axes(mesh, param_bytes: int, layout: str):
    """The axes that also shard the parameters (FSDP), or None: the data
    axes for models above ``_FSDP_PARAM_BYTES``; every axis in the pure-DP
    layout for models above 8 GB."""
    tp = layout != "dp"
    if param_bytes > _FSDP_PARAM_BYTES or not tp and param_bytes > 8e9:
        return _data_axes(mesh) if tp else tuple(mesh.mesh_dim_names)
    return None


def _input_spec(x, mesh, axes=None) -> tuple:
    """Shard an input's leading (batch) dim over the given axes (default:
    the data axes) when divisible; replicate otherwise (e.g. the batch-1
    long-context cells)."""
    daxes = axes if axes is not None else _data_axes(mesh)
    sizes = mesh_sizes(mesh)
    dsize = 1
    for a in daxes:
        dsize *= sizes[a]
    spec = [None] * x.ndim
    if x.ndim >= 1 and x.shape[0] % dsize == 0:
        spec[0] = _axes_spec(daxes)
    return tuple(spec)


def _input_shardings(batch, mesh, axes=None):
    """A ``Sharding`` per input leaf, by ``_input_spec``."""
    return tree_map(lambda x: Sharding(mesh, placements_for(
        _input_spec(x, mesh, axes), mesh)), batch)


def _tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of the tensors in ``tree``."""
    total = 0
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            local = x.to_local() if hasattr(x, "to_local") else x
            total += local.numel() * local.element_size()
    return total


def _cache_spec(x, mesh, global_batch: int) -> tuple:
    """Decode-cache layout: batch over data axes; the context/seq dim over
    ``model`` (flash-decode style — big caches must not replicate); small
    state leaves fall back to replication."""
    daxes = _data_axes(mesh)
    sizes = mesh_sizes(mesh)
    dsize = 1
    for a in daxes:
        dsize *= sizes[a]
    msize = sizes["model"]
    spec = [None] * x.ndim
    dims = list(x.shape)
    bi = next((i for i, d in enumerate(dims)
               if d == global_batch and d > 1 and d % dsize == 0), None)
    if bi is not None:
        spec[bi] = _axes_spec(daxes)
        dims[bi] = -1
    si = next((i for i, d in enumerate(dims)
               if d >= 4096 and d % msize == 0), None)
    if si is not None:
        spec[si] = "model"
    elif bi is None:
        # no batch, no seq: shard the largest divisible dim over data
        cands = [i for i, d in enumerate(dims) if d % dsize == 0
                 and d >= dsize and x.numel() >= 1 << 20]
        if cands:
            i = max(cands, key=lambda j: dims[j])
            spec[i] = _axes_spec(daxes)
    return tuple(spec)


def _cache_shardings(cache, mesh, global_batch: int, seq: int):
    """A ``Sharding`` per cache leaf (``seq`` is unused, as in the
    reference)."""
    del seq
    return tree_map(lambda x: Sharding(mesh, placements_for(
        _cache_spec(x, mesh, global_batch), mesh)), cache)


def shape_only_params(model):
    """The model's parameter tree as ``meta`` tensors: ``init`` runs under
    ``FakeTensorMode`` (shapes and dtypes, no storage, about a second even
    for a trillion parameters)."""
    return _as_meta(lambda: model.init(0))


def _as_meta(make):
    """What ``make()`` returns, made under ``FakeTensorMode`` (no storage)
    and given back as ``meta`` tensors."""
    with FakeTensorMode():
        fake = make()
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device="meta"), fake)


def _decode_cache(model, params, cfg, cell: ShapeCell, batch_rows: int):
    """The decode cache's shapes (``meta``): ``init_cache``, or for the
    encoder-decoder (whose cache comes from its prefill) the prefill of a
    context batch on plain ``meta`` tensors."""
    if model.init_cache is not None:
        return _as_meta(lambda: model.init_cache(batch_rows, cell.seq_len))
    ctx = input_specs(cfg, ShapeCell("ctx", cell.seq_len, batch_rows,
                                     "prefill"))
    return model.prefill(params, ctx, cell.seq_len)[1]


def build_step(cfg, cell: ShapeCell, mesh, fsdp, layout: str,
               batch_rows: int, n_micro: int):
    """The cell's step and its placed arguments: (fn, args)."""
    model = build_model(cfg, "cpu")
    params = shape_only_params(model)
    tp = layout != "dp"
    all_axes = tuple(mesh.mesh_dim_names)
    p_sh = param_shardings(params, mesh, fsdp_axes=fsdp, tensor_parallel=tp,
                           embed_replicated=layout.endswith("-er"))
    cell_eff = ShapeCell(cell.name, cell.seq_len, batch_rows, cell.kind)
    placed = distribute(params, p_sh)
    if cell.kind == "train":
        batch = input_specs(cfg, cell_eff)
        b_sh = _input_shardings(batch, mesh,
                                axes=_data_axes(mesh) if tp else all_axes)
        opt = adamw_init(params)
        zero1 = _data_axes(mesh)
        # ZeRO-1: moments get params' specs + fsdp over the data axes
        m_specs = param_specs(params, mesh, fsdp_axes=zero1,
                              fsdp_min_size=1 << 16)
        m_sh = tree_map(lambda _, s: Sharding(mesh, placements_for(s, mesh)),
                        params, m_specs)
        step_sh = Sharding(mesh, placements_for((), mesh))
        opt = AdamWState(step=distribute(opt.step, step_sh),
                         m=distribute(opt.m, m_sh), v=distribute(opt.v, m_sh))
        fn = make_train_step(model, num_microbatches=n_micro)
        args = (placed, opt, distribute(batch, b_sh),
                torch.tensor(1e-4, device="meta"))
    elif cell.kind == "prefill":
        batch = input_specs(cfg, cell_eff)
        b_sh = _input_shardings(batch, mesh,
                                axes=_data_axes(mesh) if tp else all_axes)
        fn = make_prefill_step(model, cell.seq_len)
        args = (placed, distribute(batch, b_sh))
    else:
        cache = _decode_cache(model, params, cfg, cell, batch_rows)
        c_sh = _cache_shardings(cache, mesh, batch_rows, cell.seq_len)
        tok = input_specs(cfg, cell_eff)["token"]
        step = make_decode_step(model)
        fn = lambda p, t, c, pos: step(p, t, c, pos)  # noqa: E731
        args = (placed, distribute(tok, _input_shardings(tok, mesh)),
                distribute(cache, c_sh),
                torch.tensor(cell.seq_len - 1, dtype=torch.int32,
                             device="meta"))
    return fn, args


def trace_step(fn, args) -> Dict:
    """Run ``fn(*args)`` once under ``TraceCounter``: the cost record."""
    with TraceCounter() as tc:
        out = fn(*args)
    return {"flops": float(tc.flops),
            "bytes_accessed": float(tc.bytes_accessed),
            "collective_bytes": collective_bytes(tc.records),
            "records": tc.records,
            "argument_bytes": _local_bytes(args),
            "output_bytes": _local_bytes(out)}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             microbatches: Optional[int] = None,
             policy_override: Optional[str] = None,
             save_hlo_to: Optional[str] = None,
             analyze: bool = False, layout: str = "tp",
             cfg_overrides: Optional[Dict] = None) -> Dict:
    """One cell's record, as the reference's.  Starts (and tears down) a
    fake world of 256 or 512 ranks: call it with no process group running.
    ``save_hlo_to`` receives the trace's collectives, one per line."""
    cfg = get_config(arch)
    if policy_override:
        # dispatch policy only matters under capacity pressure
        cfg = cfg.replace(dispatch_policy=policy_override,
                          moe_dropless=False)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    cell = shape_by_name(shape_name)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    base = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "kind": cell.kind}
    ok, why = cell_is_applicable(cfg, cell)
    if not ok:
        return {**base, "status": "skipped", "reason": why}

    t0 = time.time()
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        param_bytes = _tree_bytes(shape_only_params(build_model(cfg,
                                                                "cpu")))
        fsdp = fsdp_axes(mesh, param_bytes, layout)
        base["layout"] = layout
        n_micro = 1
        if cell.kind == "train":
            n_micro = microbatches or train_microbatches(cfg, cell)
            base["microbatches"] = n_micro
        fn, args = build_step(cfg, cell, mesh, fsdp, layout,
                              cell.global_batch, n_micro)
        cost = trace_step(fn, args)
        t_trace = time.time() - t0
        if save_hlo_to:
            with open(save_hlo_to, "w") as f:
                f.writelines(f"{k} {n}\n" for k, n in cost["records"])
        result = {
            **base,
            "status": "ok",
            "param_bytes": param_bytes,
            "fsdp": bool(fsdp),
            "flops": cost["flops"],
            "bytes_accessed": cost["bytes_accessed"],
            "collective_bytes": cost["collective_bytes"],
            "memory": {
                "argument_bytes": cost["argument_bytes"],
                "output_bytes": cost["output_bytes"],
                "temp_bytes": None,
                "alias_bytes": None,
                "code_bytes": None,
            },
            "lower_s": None,
            "compile_s": None,
            "trace_s": round(t_trace, 2),
        }
        if analyze:
            from .analyze import analyze_cell, model_flops
            result["analysis"] = analyze_cell(
                cfg, cell, mesh, fsdp, n_micro=microbatches, layout=layout)
            result["model_flops"] = model_flops(cfg, cell)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="runs/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--policy", default=None,
                    help="override MoE dispatch policy (priority|arrival)")
    ap.add_argument("--save-hlo", default=None,
                    help="write the traced collectives here")
    ap.add_argument("--analyze", action="store_true",
                    help="add extrapolated whole-step roofline costs")
    ap.add_argument("--layout", default="tp", choices=["tp", "dp"])
    ap.add_argument("--tag", default="",
                    help="suffix for output filenames (perf variants)")
    args = ap.parse_args(argv)

    archs = list(list_configs()) if args.arch == "all" else [args.arch]
    shapes = [s.name for s in SHAPES] if args.shape == "all" \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)

    failures = 0
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                tag = f"{arch}__{shape}__{'multi' if multi else 'single'}"
                if args.policy:
                    tag += f"__{args.policy}"
                if args.layout != "tp":
                    tag += f"__{args.layout}"
                if args.tag:
                    tag += f"__{args.tag}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path) and not args.force:
                    print(f"[cached ] {tag}")
                    continue
                print(f"[running] {tag} ...", flush=True)
                try:
                    res = run_cell(arch, shape, multi,
                                   microbatches=args.microbatches,
                                   policy_override=args.policy,
                                   save_hlo_to=args.save_hlo,
                                   analyze=args.analyze and not multi,
                                   layout=args.layout)
                except Exception as e:  # noqa: BLE001 - recorded per cell
                    traceback.print_exc()
                    res = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if multi else "16x16",
                           "status": "error",
                           "error": f"{type(e).__name__}: {e}"}
                    failures += 1
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                status = res["status"]
                extra = ""
                if status == "ok":
                    extra = (f" flops={res['flops']:.3e}"
                             f" coll={res['collective_bytes']['total']:.3e}B"
                             f" trace={res['trace_s']}s")
                print(f"[{status:7s}] {tag}{extra}", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
