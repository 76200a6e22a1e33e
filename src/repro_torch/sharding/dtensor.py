"""What the model needs to run on DTensors, where the reference relies on
XLA's partitioner: plain tensors the model makes itself, head splits that
do not divide the mesh, and ops with no DTensor sharding strategy.

* ``implicit_replication``: inside a model step, a plain tensor that meets
  a DTensor (the rope table, positions, masks, a cache made by prefill)
  is taken as replicated on the DTensor's mesh.  Outside a mesh nothing
  changes: every tensor is plain, and the single-device paths keep their
  bits.
* ``split_even``, ``unflatten``, ``flatten``: the rule for an uneven
  split.  Before a dim is split
  into ``n`` parts (heads), each mesh dim that shards it and does not
  divide ``n`` is redistributed to ``Replicate``: heads stay sharded where
  they divide, else the projection is all-gathered.  XLA pads uneven
  shards instead, so the collective bytes of the two differ there.
* ``placed_like``/``put_rows``: a cache that a step fills in place takes
  the placements of what it holds, and a decode step writes its one
  position a row by a select over the cache (``where``), since DTensor
  has no in-place scatter into a sharded tensor.
* ``shard_map``/``heads_local``: a per-row, per-head core (attention's
  einsums, mask and softmax; RWKV's WKV recurrence) runs on each rank's
  own batch rows and heads as plain tensors: heads are sharded where they
  divide the mesh dim, else replicated.
* ``lookup``: rows of a table sharded on its vocab dim, each rank
  gathering the rows it holds and the partial rows summed (DTensor's own
  masked lookup cannot meet other layouts or run backward in every
  version).
* ``replicated_local``/``like``: an op with no sharding strategy (the MoE
  dispatch's sort, searchsorted and scatter) runs on the all-gathered
  value as a plain tensor, and its result rejoins the mesh replicated.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import (
    compute_local_shape_and_global_offset)
from torch.distributed.tensor.experimental import implicit_replication

__all__ = ["is_dtensor", "split_even", "unflatten", "flatten",
           "replicated_local", "like", "on_mesh", "placed_like", "put_rows",
           "heads_local", "shard_map", "lookup"]


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def on_mesh(fn: Callable) -> Callable:
    """``fn`` under DTensor's implicit replication (entered once: a step
    called from a step leaves it to the outer one, since leaving the
    context switches it off rather than restoring it)."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        if DTensor._op_dispatcher._allow_implicit_replication:
            return fn(*args, **kwargs)
        with implicit_replication():
            return fn(*args, **kwargs)
    return run


def split_even(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` with every mesh dim that shards ``dim`` and does not divide
    ``n`` replicated (a plain tensor is returned as it is)."""
    if not is_dtensor(x):
        return x
    dim %= x.ndim
    mesh, pl = x.device_mesh, list(x.placements)
    bad = [i for i, p in enumerate(pl)
           if isinstance(p, Shard) and p.dim == dim and n % mesh.size(i)]
    if not bad:
        return x
    for i in bad:
        pl[i] = Replicate()
    return x.redistribute(mesh, pl)


def unflatten(x: torch.Tensor, dim: int, sizes: tuple) -> torch.Tensor:
    """``x.unflatten(dim, sizes)`` (heads out of a projection, groups out of
    heads), with ``split_even``'s rule for the first of ``sizes``."""
    return split_even(x, dim, sizes[0]).unflatten(dim, sizes)


class _Flatten(torch.autograd.Function):
    """dims ``dim`` and ``dim + 1`` merged, whose gradient is split by the
    rule of ``split_even``."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim % x.ndim
        ctx.sizes = tuple(x.shape[ctx.dim:ctx.dim + 2])
        return x.flatten(ctx.dim, ctx.dim + 1)

    @staticmethod
    def backward(ctx, g):
        return unflatten(g, ctx.dim, ctx.sizes), None


def flatten(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x.flatten(dim, dim + 1)`` (heads side by side)."""
    if is_dtensor(x):
        return _Flatten.apply(x, dim)
    dim %= x.ndim
    return x.flatten(dim, dim + 1)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous: a DTensor assumes
    its local shard's layout follows its own, and a gradient computed on a
    plain local tensor (an einsum's, a gather's) need not."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _to_local(x: torch.Tensor) -> torch.Tensor:
    return _ContiguousGrad.apply(x.to_local())


def replicated_local(x: torch.Tensor) -> torch.Tensor:
    """The full value of ``x`` as a plain tensor: a DTensor is
    redistributed to ``Replicate`` (an all-gather where it is sharded)."""
    if not is_dtensor(x):
        return x
    return _to_local(x.redistribute(x.device_mesh,
                                    [Replicate()] * x.device_mesh.ndim))


def like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``x`` (the same value on every rank) as a replicated DTensor on
    ``ref``'s mesh when ``ref`` is a DTensor, else ``x`` itself."""
    if not is_dtensor(ref) or is_dtensor(x):
        return x
    mesh = ref.device_mesh
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def placed_like(t: torch.Tensor, ref: torch.Tensor, lead: int = 0
                ) -> torch.Tensor:
    """``t`` (zeros, as a cache starts) placed as ``ref`` is when ``ref`` is
    a DTensor: each ``Shard(d)`` of ``ref`` shards dim ``d + lead`` of the
    result, every other mesh dim replicates.  Else ``t`` itself."""
    if not is_dtensor(ref):
        return t
    mesh = ref.device_mesh
    pl = [Shard(p.dim + lead) if isinstance(p, Shard) else Replicate()
          for p in ref.placements]
    local, _ = compute_local_shape_and_global_offset(t.shape, mesh, pl)
    return DTensor.from_local(
        torch.zeros(local, dtype=t.dtype, device=ref.to_local().device),
        mesh, pl, run_check=False, shape=t.shape, stride=t.stride())


def put_rows(buf: torch.Tensor, pos: torch.Tensor, rows: torch.Tensor
             ) -> None:
    """``buf[b, pos[b]] = rows[b]`` for every row ``b``, in place.  buf:
    [B, S, ...]; pos: [B]; rows: [B, ...]."""
    b, s = buf.shape[:2]
    if not is_dtensor(buf):
        buf[torch.arange(b, device=pos.device), pos] = rows
        return
    hit = torch.arange(s, device=pos.device)[None, :] == pos[:, None]
    hit = hit.reshape(b, s, *([1] * (buf.ndim - 2)))
    buf.copy_(torch.where(hit, rows[:, None], buf))


def _global_stride(shape) -> tuple:
    return torch.empty(shape, device="meta").stride()


def shard_map(fn: Callable, args: tuple, dims: tuple, out_dims: tuple,
              heads: int):
    """``fn(*args)`` on each rank's rows and heads, as plain tensors.

    ``dims[i]`` is (batch dim, heads dim) of tensor argument ``i`` (either
    None where it has no such dim; ``None`` for an argument that is not a
    tensor, passed as it is), ``out_dims`` the same for each output.  The
    first DTensor argument with a batch dim decides: a mesh dim that shards
    its batch dim shards every batch dim, one that shards its heads dim
    and divides ``heads`` shards every heads dim, every other mesh dim
    replicates.  Without a DTensor argument this is ``fn(*args)``."""
    ref_i = next((i for i, (a, d) in enumerate(zip(args, dims))
                  if is_dtensor(a) and d and d[0] is not None), None)
    if ref_i is None:
        return fn(*args)
    ref = args[ref_i]
    mesh = ref.device_mesh
    rb, rh = dims[ref_i]
    role = []
    for i, p in enumerate(ref.placements):
        if isinstance(p, Shard) and p.dim == rb:
            role.append(0)
        elif rh is not None and isinstance(p, Shard) and p.dim == rh \
                and not heads % mesh.size(i):
            role.append(1)
        else:
            role.append(None)

    def placements(d):
        return [Shard(d[r]) if r is not None and d[r] is not None
                else Replicate() for r in role]

    local = [a if d is None else
             _to_local(like(a, ref).redistribute(mesh, placements(d)))
             for a, d in zip(args, dims)]
    out = fn(*local)
    single = not isinstance(out, tuple)
    outs = []
    for o, d in zip((out,) if single else out, out_dims):
        shape = list(o.shape)       # global: the batch's, heads times split
        if d[0] is not None and 0 in role:
            shape[d[0]] = ref.shape[rb]
        for i, r in enumerate(role):
            if r == 1 and d[1] is not None:
                shape[d[1]] *= mesh.size(i)
        pl = placements(d)
        outs.append(DTensor.from_local(o.contiguous(), mesh, pl,
                                       run_check=False, shape=tuple(shape),
                                       stride=_global_stride(shape)))
    return outs[0] if single else tuple(outs)


def heads_local(fn: Callable, q, k, v, mask, *args) -> torch.Tensor:
    """``fn(q, k, v, mask, *args)``, an attention core over q [B, S, H, hd],
    k and v [B, T, Hkv, hd] and mask [B or 1, S, T] (or None) returning
    [B, S, H, hd], by ``shard_map`` over batch rows and kv-head groups (a
    query head's group must sit with its kv head)."""
    bh = (0, 2)
    mdims = None if mask is None else (0 if mask.shape[0] > 1 else None,
                                       None)
    return shard_map(lambda q, k, v, m: fn(q, k, v, m, *args),
                     (q, k, v, mask), (bh, bh, bh, mdims), (bh,),
                     k.shape[2])


class _Lookup(torch.autograd.Function):
    """``table[tokens]`` for a DTensor table sharded on dim 0 (the vocab)
    over some mesh dims, tokens replicated on those: each rank gathers the
    rows in its slice (zeros for the rest) and the mesh sums them.  The
    backward adds each rank's rows of the gradient into its slice, summed
    over the mesh dims that shard the tokens (their batch), and placed as
    the table is."""

    @staticmethod
    def forward(ctx, tokens, table):
        mesh = table.device_mesh
        t_pl = [Shard(0) if isinstance(p, Shard) and p.dim == 0
                else Replicate() for p in table.placements]
        vocab = [i for i, p in enumerate(t_pl) if isinstance(p, Shard)]
        tok = like(tokens, table)
        tok_pl = [Replicate() if i in vocab else p
                  for i, p in enumerate(tok.placements)]
        tok = tok.redistribute(mesh, tok_pl)
        tab = table.redistribute(mesh, t_pl)
        local, off = compute_local_shape_and_global_offset(
            tab.shape, mesh, t_pl)
        idx = tok.to_local().long() - off[0]
        hit = (idx >= 0) & (idx < local[0])
        idx = torch.where(hit, idx, 0)
        rows = tab.to_local()[idx] * hit[..., None].to(tab.dtype)
        out_pl = [Partial() if i in vocab else p
                  for i, p in enumerate(tok_pl)]
        shape = tuple(tok.shape) + (table.shape[1],)
        out = DTensor.from_local(rows, mesh, out_pl, run_check=False,
                                 shape=shape, stride=_global_stride(shape))
        ctx.save_for_backward(idx, hit)
        ctx.meta = (mesh, tok_pl, t_pl, tuple(table.placements),
                    tuple(table.shape), tuple(local), table.dtype)
        return out.redistribute(mesh, [
            Replicate() if i in vocab else p for i, p in enumerate(out_pl)])

    @staticmethod
    def backward(ctx, g):
        idx, hit = ctx.saved_tensors
        mesh, tok_pl, t_pl, placements, shape, local, dtype = ctx.meta
        g_l = g.redistribute(mesh, tok_pl).to_local()
        grad = torch.zeros(local, dtype=dtype, device=g_l.device)
        rows = (g_l * hit[..., None].to(g_l.dtype)).to(dtype)
        grad.index_add_(0, idx.reshape(-1), rows.reshape(-1, local[1]))
        grad_pl = [Partial() if isinstance(p, Shard) else t
                   for p, t in zip(tok_pl, t_pl)]
        grad = DTensor.from_local(grad, mesh, grad_pl, run_check=False,
                                  shape=shape, stride=_global_stride(shape))
        return None, grad.redistribute(mesh, placements)


def lookup(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` for a DTensor ``table`` (see ``_Lookup``)."""
    return _Lookup.apply(tokens, table)
