"""Gradient compression for the slow cross-pod reduction.

The PyTorch counterpart of ``repro/optim/compress.py``.  fp32→bf16 with
**error feedback**: the quantization residual is carried into the next
step's gradient, so the compression bias vanishes over time (the standard
EF-SGD construction).  ``compressed_allreduce`` performs the cross-pod mean
in bf16 — halving cross-pod collective bytes, the term that dominates the
multi-pod roofline.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..tree import tree_map

__all__ = ["error_feedback_compress", "compressed_allreduce"]


def error_feedback_compress(grads, error):
    """Quantize (grads + error) to bf16; return (compressed, new_error)."""
    def one(g, e):
        target = g.float() + e
        q = target.to(torch.bfloat16)
        return q, target - q.float()

    pairs = tree_map(one, grads, error)      # a (q, residual) per leaf
    comp = tree_map(lambda _, p: p[0], grads, pairs)
    new_err = tree_map(lambda _, p: p[1], grads, pairs)
    return comp, new_err


def compressed_allreduce(grads, error, mesh, axis: str = "pod"):
    """Mean-reduce ``grads`` over the ``axis`` dimension of ``mesh`` in bf16
    with error feedback; returns (reduced fp32, new_error).

    Each rank passes its own gradients (plain tensors): bf16(g + e) is
    summed in bf16 over the axis's group, divided by the group's size in
    bf16 and widened to fp32, the order of the reference.  The reference
    feeds every pod the same replicated array (``in_specs=P()``); given
    identical inputs on every rank the two agree bit for bit.
    Inside-pod reduction should already have happened; this covers the
    expensive cross-pod hop.
    """
    comp, new_err = error_feedback_compress(grads, error)
    group = mesh.get_group(axis)
    n = mesh.size(mesh.mesh_dim_names.index(axis))

    def reduce(q):
        q = q.clone()
        dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
        return (q / n).float()

    return tree_map(reduce, comp), new_err
