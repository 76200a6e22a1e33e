"""AdamW with global-norm clipping, on trees of tensors: the PyTorch
counterpart of ``repro.optim.adamw``.

Moments are fp32 whatever the parameter's dtype.  The update is the
reference's, formula for formula and in its order, but written into the
parameters and moments in place (the reference returns new trees) and
taken over slices of at most ``_SLICE`` elements, so its fp32 temporaries
stay small beside a full-width model's moments.  The update is elementwise,
so slicing changes no result.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..sharding.dtensor import is_dtensor
from ..tree import tree_leaves, tree_map

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm"]

#: elements of a leaf updated at a time (a 64M-element slice: 256 MB of
#: each fp32 temporary)
_SLICE = 1 << 26


class AdamWState(NamedTuple):
    step: torch.Tensor   # [] int32
    m: dict
    v: dict


def _slices(n: int):
    return ((i, min(i + _SLICE, n)) for i in range(0, n, _SLICE))


def zeros32(p: torch.Tensor) -> torch.Tensor:
    """fp32 zeros of ``p``'s shape, placed as ``p`` is on a mesh."""
    if is_dtensor(p):
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def adamw_init(params) -> AdamWState:
    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros32, params),
                      v=tree_map(zeros32, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, in fp32."""
    total = 0
    for x in tree_leaves(tree):
        if is_dtensor(x):       # flat slices of a shard would reshard it
            total = total + torch.sum(torch.square(x.detach().float()))
            continue
        flat = x.detach().reshape(-1)
        for a, b in _slices(flat.numel()):
            total = total + torch.sum(torch.square(flat[a:b].float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, lr, *,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0):
    """Returns (params, new_state, metrics).  ``params`` and the moments of
    ``state`` are updated in place; ``grads`` are read only."""
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()

    def upd_slice(gs, ms, vs, ps):
        ms.mul_(b1).add_((1 - b1) * gs)
        vs.mul_(b2).add_((1 - b2) * gs * gs)
        mhat = ms / bc1
        vhat = vs / bc2
        pf = ps.float()
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * pf
        ps.copy_(pf - lr * delta)

    def upd(g, m, v, p):
        if is_dtensor(p):
            # whole leaves: moments placed otherwise than the parameter
            # (ZeRO-1) are met by DTensor's redistributes in the writes
            upd_slice(g.float() * scale, m, v, p)
            return
        g = g.reshape(-1)
        m, v, p = (t.view(-1) for t in (m, v, p))
        for a, b in _slices(p.numel()):
            upd_slice(g[a:b].float() * scale, m[a:b], v[a:b], p[a:b])

    tree_map(upd, grads, state.m, state.v, params)
    return params, AdamWState(step, state.m, state.v), {"grad_norm": gnorm}
