"""Strategy-scheduled MoE token dispatch.

The PyTorch counterpart of ``repro/core/device/moe_balance.py``: the paper's
decision procedures, applied to the per-token routing problem of a
Mixture-of-Experts layer (tokens = tasks, experts = places):

* **priority** — under capacity pressure, an expert keeps the tokens with the
  highest router probability (the strategy's priority), not the
  first-arrived ones (the oblivious baseline, ``policy="arrival"``).
* **dead tasks** — assignments beyond capacity are *dropped before compute*
  and their probability mass is excised from the combine weights.
* **steal (second choice)** — with ``resteal=True`` dropped assignments are
  re-routed to the token's next-best expert where spare capacity remains:
  one extra priority-dispatch pass in which already-kept assignments carry
  +inf priority.

The plan is bit-identical to the reference's on the same logits: ties keep
the reference's order (lower expert index first in top-k, lower assignment
index first within a sort key).  Everything stays on the tensors' device,
with no host synchronisation.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["route_topk", "priority_dispatch", "gather_expert_inputs",
           "combine_expert_outputs", "DispatchPlan"]


class DispatchPlan(NamedTuple):
    """Static-shape dispatch decision for T tokens × k choices → E experts of
    capacity C."""
    slot_src: torch.Tensor      # [E, C] int32: flat assignment index, or -1
    kept: torch.Tensor          # [T, k] bool: assignment survived capacity
    expert: torch.Tensor        # [T, k] int32: expert finally serving it
    gate: torch.Tensor          # [T, k] f32: combine weight (0 where dropped)
    load: torch.Tensor          # [E] int32: tokens per expert (≤ C)
    dropped_mass: torch.Tensor  # [] f32: router prob mass lost to drops


def route_topk(logits: torch.Tensor, k: int, *, renormalize: bool = True):
    """Top-k routing.  Returns (expert_idx [T,k] int32, gate [T,k],
    full_probs [T,E]).  A stable descending sort puts tied probabilities in
    ascending expert order, as ``lax.top_k`` does."""
    probs = torch.softmax(logits.float(), dim=-1)
    gate, expert_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert_idx = gate[:, :k], expert_idx[:, :k]
    if renormalize:
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return expert_idx.int(), gate, probs


def _dispatch_once(e: torch.Tensor, prio: torch.Tensor, num_experts: int,
                   capacity: int):
    """Sort-based segment dispatch.  e: [A] expert ids, prio: [A] priority
    (higher first).  Returns (pos [A] position-within-expert, keep [A])."""
    a = e.shape[0]
    # jnp.lexsort((-prio, e)): experts ascending, then priority descending,
    # then assignment index — two stable passes, minor key first
    minor = torch.argsort(-prio, stable=True)
    order = minor[torch.argsort(e[minor], stable=True)]
    e_sorted = e[order]
    seg_start = torch.searchsorted(
        e_sorted, torch.arange(num_experts, dtype=e.dtype, device=e.device),
        side="left")
    pos_sorted = (torch.arange(a, dtype=torch.int32, device=e.device)
                  - seg_start[e_sorted].int())
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    return pos, pos < capacity


def priority_dispatch(expert_idx: torch.Tensor, gate: torch.Tensor,
                      full_probs: torch.Tensor, *, num_experts: int,
                      capacity: int, policy: str = "priority",
                      resteal: bool = False) -> DispatchPlan:
    """Build the dispatch plan for [T, k] routed assignments.

    policy="priority": strategy scheduling — highest router prob survives.
    policy="arrival":  oblivious baseline — first-come-first-served.
    resteal=True:      dropped assignments take the token's next-best expert
                       with spare capacity (one extra pass).
    """
    t, k = expert_idx.shape
    a = t * k
    dev = expert_idx.device
    e = expert_idx.reshape(a)
    g = gate.reshape(a)
    arrival = -torch.arange(a, dtype=torch.float32, device=dev)
    prio = g if policy == "priority" else arrival

    pos, keep = _dispatch_once(e, prio, num_experts, capacity)

    if resteal:
        # next-best expert not already among the token's top-k choices
        chosen = torch.zeros(t, num_experts, dtype=torch.bool, device=dev)
        chosen.scatter_(1, expert_idx.long(), True)
        masked = torch.where(chosen, float("-inf"), full_probs)
        alt_e = masked.argmax(dim=-1)            # first maximum, as jnp's
        alt_p = masked.amax(dim=-1)
        alt_e_a = alt_e.int().repeat_interleave(k)
        alt_p_a = alt_p.repeat_interleave(k)
        e2 = torch.where(keep, e, alt_e_a)
        prio2 = torch.where(keep, float("inf"),
                            alt_p_a if policy == "priority" else arrival)
        pos2, keep2 = _dispatch_once(e2, prio2, num_experts, capacity)
        restolen = keep2 & ~keep
        e = torch.where(restolen, e2, e)
        g = torch.where(restolen, alt_p_a.to(g.dtype), g)
        pos, keep = pos2, keep2

    # every dropped assignment lands on the sentinel slot E*C, cut off below
    slot = torch.where(keep, e * capacity + pos, num_experts * capacity)
    slot_src = torch.full((num_experts * capacity + 1,), -1,
                          dtype=torch.int32, device=dev)
    slot_src[slot.long()] = torch.arange(a, dtype=torch.int32, device=dev)
    slot_src = slot_src[:-1].reshape(num_experts, capacity)

    experts = torch.arange(num_experts, device=dev)[:, None]
    load = ((experts == e[None, :]) & keep[None, :]).sum(1, dtype=torch.int32)
    zero = torch.zeros((), dtype=g.dtype, device=dev)
    gate_kept = torch.where(keep, g, zero)
    dropped_mass = torch.where(keep, zero, g).sum()
    return DispatchPlan(slot_src=slot_src,
                        kept=keep.reshape(t, k),
                        expert=e.reshape(t, k).int(),
                        gate=gate_kept.reshape(t, k).float(),
                        load=load,
                        dropped_mass=dropped_mass)


def gather_expert_inputs(x: torch.Tensor, plan: DispatchPlan,
                         num_choices: int) -> torch.Tensor:
    """Gather token vectors into expert buffers.  x: [T, D] → [E, C, D];
    empty slots are zero."""
    valid = plan.slot_src >= 0
    token = torch.where(valid, plan.slot_src // num_choices, 0)
    return x[token.long()] * valid[..., None].to(x.dtype)


def combine_expert_outputs(y_buf: torch.Tensor, plan: DispatchPlan,
                           num_tokens: int, num_choices: int) -> torch.Tensor:
    """Scatter expert outputs back and apply combine (gate) weights.
    y_buf: [E, C, D] → [T, D].  The fp32 sum starts from 0, so for
    ``num_choices == 2`` each token's two contributions give the same bits
    in either order: the scatter-add is deterministic there on any device."""
    e, c, d = y_buf.shape
    flat_src = plan.slot_src.reshape(e * c)
    valid = flat_src >= 0
    token = torch.where(valid, flat_src // num_choices, num_tokens)
    gate = plan.gate.reshape(-1)[flat_src.clamp(min=0).long()]
    contrib = (y_buf.reshape(e * c, d).float()
               * (gate * valid)[:, None])
    out = torch.zeros(num_tokens + 1, d, dtype=torch.float32,
                      device=y_buf.device)
    out.index_add_(0, token.long(), contrib)
    return out[:num_tokens].to(y_buf.dtype)
