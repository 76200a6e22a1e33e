# _RULES and spec_for_path's rules are copied from src/repro/sharding/partition.py.
"""Parameter partitioning rules: param-tree path → partition spec, and the
DTensor placements each spec implies.

The PyTorch counterpart of ``repro/sharding/partition.py``.  A spec is a
plain tuple with one entry per dimension, as ``jax.sharding.PartitionSpec``
has: ``None`` (replicated), a mesh axis name, or a tuple of axis names.
Rules are matched on the path *suffix* and specify the spec for the LAST n
dimensions; leading dims (the stacked layer axis, Jamba's superblock axis)
are replicated automatically.  Tensor-parallel axes go on ``model``; MoE
experts go on ``model`` when the expert count divides the axis (expert
parallelism), otherwise the expert FFN dim is sharded (tensor parallelism
inside each expert).  Any non-divisible dim falls back to replication
instead of failing, so one rule table serves every architecture and mesh.

ZeRO-1 / FSDP: ``fsdp_axes`` additionally shards the largest replicated dim
of big leaves over the data axes — used for optimizer state (ZeRO-1) and,
for the trillion-parameter configs, the parameters themselves.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (axis sizes read
by ``mesh_dim_names``) or anything whose ``shape`` maps axis names to
sizes (the shape-only stand-in of the rule tests).
"""
from __future__ import annotations

import re
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor._utils import (
    compute_local_shape_and_global_offset)

from ..tree import tree_map, tree_map_with_path

__all__ = ["spec_for_path", "param_specs", "param_shardings", "batch_spec",
           "Sharding", "placements_for", "distribute", "mesh_sizes"]

# (path-suffix regex, spec for trailing dims, right-aligned)
_RULES: Tuple[Tuple[str, Tuple], ...] = (
    (r"embed/table$", ("model", None)),
    (r"(wq|wk|wv)/w$", (None, "model")),
    (r"(wq|wk|wv)/b$", ("model",)),
    (r"wo/w$", ("model", None)),
    (r"(gate|up)/w$", (None, "model")),
    (r"down/w$", ("model", None)),
    (r"lm_head/w$", (None, "model")),
    (r"router/w$", (None, None)),
    (r"w_(gate|up)$", ("__expert__", None, None)),   # filled per-config
    (r"w_down$", ("__expert__", None, None)),
    (r"vis_proj/fc1/w$", (None, "model")),
    (r"vis_proj/fc2/w$", ("model", None)),
    (r"audio_proj/w$", (None, "model")),
    # rwkv6
    (r"tm/(wr|wk|wv|wg)/w$", (None, "model")),
    (r"tm/wo/w$", ("model", None)),
    (r"cm/wk/w$", (None, "model")),
    (r"cm/wv/w$", ("model", None)),
    (r"cm/wr/w$", (None, "model")),
    # mamba
    (r"in_proj/w$", (None, "model")),
    (r"conv_w$", (None, "model")),
    (r"conv_b$", ("model",)),
    (r"x_proj/w$", ("model", None)),
    (r"dt_proj/w$", (None, "model")),
    (r"dt_proj/b$", ("model",)),
    (r"a_log$", ("model", None)),
    (r"d_skip$", ("model",)),
    (r"out_proj/w$", ("model", None)),
)


class Sharding(NamedTuple):
    """Where a tensor lives: the counterpart of ``NamedSharding``."""
    mesh: object                       # DeviceMesh
    placements: Tuple[Placement, ...]  # one per mesh dimension


def mesh_sizes(mesh) -> dict:
    """Axis name → size, for a ``DeviceMesh`` or a name → size mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return dict(mesh.shape)


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = mesh_sizes(mesh)
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= sizes[a]
        return n
    return sizes[axis]


def spec_for_path(path: str, shape: Sequence[int], mesh,
                  expert_parallel: bool = True,
                  fsdp_axes: Optional[Tuple[str, ...]] = None,
                  fsdp_min_size: int = 1 << 20,
                  tensor_parallel: bool = True,
                  embed_replicated: bool = False) -> tuple:
    """Partition spec for one leaf.  ``tensor_parallel=False`` keeps
    weights unsharded on the model axis (pure-DP layout for small models
    where TP activation all-reduces dominate); fsdp_axes still applies."""
    rank = len(shape)
    spec = [None] * rank
    if embed_replicated and re.search(r"embed/table$", path):
        # replicate the token table: a vocab-sharded gather hits XLA SPMD's
        # replicate-then-reshard fallback (huge implicit collectives)
        return tuple(spec)
    for pat, tail in (_RULES if tensor_parallel else ()):
        if re.search(pat, path):
            tail = list(tail)
            # expert weights: EP over `model` when divisible, else TP on the
            # expert-internal dim
            if tail and tail[0] == "__expert__":
                e_dim = rank - len(tail)
                if expert_parallel and shape[e_dim] % _axis_size(
                        mesh, "model") == 0:
                    tail[0] = "model"
                else:
                    tail[0] = None
                    # shard the wider of the two inner dims
                    inner = int(shape[-1] < shape[-2])  # 1 → dim -2 bigger
                    tail[-1 - inner] = "model"
            offset = rank - len(tail)
            for i, ax in enumerate(tail):
                if ax is not None and shape[offset + i] % _axis_size(
                        mesh, ax) == 0:
                    spec[offset + i] = ax
            break
    if fsdp_axes:
        size = 1
        for s in shape:
            size *= s
        if size >= fsdp_min_size:
            fs = _axis_size(mesh, tuple(fsdp_axes))
            # largest replicated dim divisible by the fsdp axes
            cands = [i for i in range(rank)
                     if spec[i] is None and shape[i] % fs == 0]
            if cands:
                i = max(cands, key=lambda j: shape[j])
                spec[i] = tuple(fsdp_axes) if len(fsdp_axes) > 1 \
                    else fsdp_axes[0]
    return tuple(spec)


def param_specs(params, mesh, expert_parallel: bool = True,
                fsdp_axes: Optional[Tuple[str, ...]] = None,
                fsdp_min_size: int = 1 << 20,
                tensor_parallel: bool = True,
                embed_replicated: bool = False):
    """Spec tree matching ``params`` (tensors of any device, ``meta`` and
    fake ones included: only shapes are read)."""
    return tree_map_with_path(
        lambda path, x: spec_for_path(path, x.shape, mesh, expert_parallel,
                                      fsdp_axes, fsdp_min_size,
                                      tensor_parallel, embed_replicated),
        params)


def placements_for(spec: tuple, mesh) -> Tuple[Placement, ...]:
    """The DTensor placements a spec implies on a ``DeviceMesh``:
    ``Shard(d)`` on every mesh dimension named at tensor dimension ``d``
    (each of them, for a tuple of axes), ``Replicate()`` on the rest."""
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def param_shardings(params, mesh, **kw):
    """A ``Sharding`` per leaf of ``params``: the mesh and the placements
    of ``param_specs(params, mesh, **kw)``."""
    return tree_map(lambda _, s: Sharding(mesh, placements_for(s, mesh)),
                    params, param_specs(params, mesh, **kw))


def batch_spec(mesh) -> tuple:
    """Input batches shard their leading (batch) dim over all data axes."""
    sizes = mesh_sizes(mesh)
    axes = tuple(a for a in ("pod", "data") if a in sizes)
    return (axes if len(axes) > 1 else axes[0],)


def distribute(tree, shardings):
    """Place every leaf of ``tree`` by the matching ``Sharding`` (the
    counterpart of ``jax.device_put(x, sharding)``).  Every rank passes the
    same full tensors.  A ``meta`` leaf becomes a ``meta`` DTensor with no
    data moved, which is how the dry run places full-size trees."""
    def one(x, sh):
        if x.is_meta:
            local, _ = compute_local_shape_and_global_offset(
                x.shape, sh.mesh, sh.placements)
            return DTensor.from_local(
                torch.empty(local, dtype=x.dtype, device="meta"), sh.mesh,
                sh.placements, run_check=False, shape=x.shape,
                stride=x.stride())
        return distribute_tensor(x, sh.mesh, list(sh.placements))
    return tree_map(one, tree, shardings)
