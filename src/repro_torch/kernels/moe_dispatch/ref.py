"""Plain PyTorch versions of the MoE dispatch kernels.

The plain form is ``core/device/moe_balance.py``'s (``route_topk``,
``priority_dispatch``, ``gather_expert_inputs``, ``combine_expert_outputs``)
with ``models/moe.py``'s load-balance loss: :func:`moe_route_plain`,
:func:`moe_dispatch_plain` and :func:`moe_combine_plain` compose them with
the wrappers' signatures.  Training and every CPU tensor take them.

:func:`route_alt_plain`, :func:`dispatch_ranked_plain` and
:func:`combine_by_slot_plain` are the CUDA kernels' algorithms written in
PyTorch (each expert ranks its own assignments; the resteal pass skipped
where capacity >= T; the combine reads each assignment's slot), so that the
CPU tests hold the algorithms to the plain form.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...core.device.moe_balance import (DispatchPlan, combine_expert_outputs,
                                        gather_expert_inputs,
                                        priority_dispatch, route_topk)

__all__ = ["Routing", "Dispatched", "moe_route_plain", "moe_dispatch_plain",
           "moe_combine_plain", "aux_loss_plain", "route_alt_plain",
           "dispatch_ranked_plain", "combine_by_slot_plain"]


class Routing(NamedTuple):
    """Top-k routing of T tokens over E experts."""
    expert_idx: torch.Tensor                    # [T, k] int32
    gate: torch.Tensor                          # [T, k] f32 combine weight
    probs: torch.Tensor                         # [T, E] f32 router probs
    alt_expert: Optional[torch.Tensor] = None   # [T] int32 (k+1)-th choice
    alt_prob: Optional[torch.Tensor] = None     # [T] f32 its probability


class Dispatched(NamedTuple):
    """The dispatch plan, the expert buffer it fills and the aux loss."""
    plan: DispatchPlan
    buf: torch.Tensor                           # [E, C, D]
    aux_loss: torch.Tensor                      # []
    slot: Optional[torch.Tensor] = None         # [T, k] int32 e*C+pos or -1


def moe_route_plain(logits: torch.Tensor, k: int, alt: bool = False,
                    renormalize: bool = True) -> Routing:
    """``route_topk``; ``alt`` is taken and ignored (``priority_dispatch``
    finds the next choice itself)."""
    del alt
    return Routing(*route_topk(logits, k, renormalize=renormalize))


def aux_loss_plain(probs: torch.Tensor, load: torch.Tensor,
                   num_experts: int) -> torch.Tensor:
    """Switch-style load-balance aux loss: E * Σ_e f_e · P_e."""
    me = probs.mean(0)                                # mean router prob [E]
    ce = load.float() / torch.clamp(load.sum(), min=1)
    return num_experts * torch.sum(me * ce)


def moe_dispatch_plain(x: torch.Tensor, routing: Routing, *,
                       num_experts: int, capacity: int,
                       policy: str = "priority",
                       resteal: bool = False) -> Dispatched:
    """x: [T, D] -> the plan, the [E, C, D] buffer and the aux loss."""
    plan = priority_dispatch(routing.expert_idx, routing.gate, routing.probs,
                             num_experts=num_experts, capacity=capacity,
                             policy=policy, resteal=resteal)
    buf = gather_expert_inputs(x, plan, routing.expert_idx.shape[1])
    return Dispatched(plan, buf,
                      aux_loss_plain(routing.probs, plan.load, num_experts))


def moe_combine_plain(y_buf: torch.Tensor, dispatched: Dispatched,
                      num_tokens: int, num_choices: int) -> torch.Tensor:
    """y_buf: [E, C, D] -> [T, D]."""
    return combine_expert_outputs(y_buf, dispatched.plan, num_tokens,
                                  num_choices)


def route_alt_plain(probs: torch.Tensor, k: int):
    """The route kernel's (k+1)-th choice: entry k of the stable descending
    sort, which is the plain path's first maximum of the probabilities
    masked by the top-k; expert 0 at -inf where k = E."""
    t, e = probs.shape
    if k >= e:
        return (torch.zeros(t, dtype=torch.int32),
                torch.full((t,), float("-inf")))
    p, i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return i[:, k].int(), p[:, k]


def _rank(eff: torch.Tensor, key: Optional[torch.Tensor],
          num_experts: int) -> torch.Tensor:
    """Each assignment's rank among those of its expert ``eff``: by (key
    descending, index ascending), or by index where ``key`` is None, as
    one rank CTA an expert counts it."""
    rank = torch.empty_like(eff)
    for x in range(num_experts):
        mine = (eff == x).nonzero().squeeze(1)    # collected in index order
        n = mine.numel()
        if key is None:
            rank[mine] = torch.arange(n)
            continue
        kx = key[mine]
        j = torch.arange(n)
        ahead = (kx[None, :] > kx[:, None]) | (
            (kx[None, :] == kx[:, None]) & (j[None, :] < j[:, None]))
        rank[mine] = ahead.sum(1)
    return rank


def dispatch_ranked_plain(routing: Routing, *, num_experts: int,
                          capacity: int, policy: str = "priority",
                          resteal: bool = False):
    """The rank kernel's plan: (DispatchPlan, slot [T, k]).  Without
    restealing one pass by the policy's priority; with it and capacity >=
    T one pass by index (the first pass keeps everything, and the second
    puts every kept assignment at +inf); else a first pass, then the
    second with kept assignments at +inf and dropped ones at their next
    choice."""
    t, k = routing.expert_idx.shape
    a = t * k
    e1 = routing.expert_idx.reshape(a).long()
    g1 = routing.gate.reshape(a).float()
    index = torch.arange(a)
    arrival = -index.float()
    key1 = arrival if policy != "priority" else g1
    if not resteal:
        eff, rank, g = e1, _rank(e1, key1, num_experts), g1
    elif capacity >= t:
        eff, rank, g = e1, _rank(e1, None, num_experts), g1
    else:
        alt_e, alt_p = routing.alt_expert, routing.alt_prob
        if alt_e is None:
            alt_e, alt_p = route_alt_plain(routing.probs, k)
        alt_e = alt_e.long().repeat_interleave(k)
        alt_p = alt_p.float().repeat_interleave(k)
        keep1 = _rank(e1, key1, num_experts) < capacity
        eff = torch.where(keep1, e1, alt_e)
        key2 = torch.where(keep1, float("inf"),
                           arrival if policy != "priority" else alt_p)
        rank = _rank(eff, key2, num_experts)
        g = torch.where(keep1, g1, alt_p)
    keep = rank < capacity
    slot = torch.where(keep, eff * capacity + rank, -1)
    slot_src = torch.full((num_experts * capacity,), -1, dtype=torch.int32)
    slot_src[slot[keep]] = index[keep].int()
    plan = DispatchPlan(
        slot_src=slot_src.reshape(num_experts, capacity),
        kept=keep.reshape(t, k),
        expert=torch.where(keep, eff, e1).int().reshape(t, k),
        gate=torch.where(keep, g, 0.0).reshape(t, k),
        load=torch.bincount(eff[keep], minlength=num_experts).int(),
        dropped_mass=g1[~keep].sum())
    return plan, slot.int().reshape(t, k)


def combine_by_slot_plain(y_buf: torch.Tensor, slot: torch.Tensor,
                          gate: torch.Tensor) -> torch.Tensor:
    """The combine kernel's algorithm: each token's kept slots ascending,
    y * gate in fp32 added from +0 one choice at a time, cast once."""
    e, c, d = y_buf.shape
    t, k = slot.shape
    order = torch.where(slot >= 0, slot, e * c).argsort(dim=-1, stable=True)
    s = slot.gather(1, order)
    w = gate.gather(1, order)
    rows = y_buf.reshape(e * c, d)
    out = torch.zeros(t, d, dtype=torch.float32)
    for j in range(k):
        live = s[:, j] >= 0
        term = rows[s[:, j].clamp(min=0).long()].float() * w[:, j, None]
        out = torch.where(live[:, None], out + term, out)
    return out.to(y_buf.dtype)
