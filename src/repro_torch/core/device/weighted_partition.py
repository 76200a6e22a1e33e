"""Steal-half-the-WORK as a deterministic balancing pass.

The PyTorch counterpart of ``repro/core/device/weighted_partition.py``.  The
paper: a thief should transfer half the victim's *work* (sum of transitive
weights), not half its task count.  Over weighted items the same decision
becomes a deterministic balancing pass:

* :func:`greedy_weighted_partition` — LPT greedy: place the heaviest
  remaining item on the least-loaded bin.  Used to pack variable-length
  sequences onto data-parallel shards and to assign data-pipeline shards to
  hosts.
* :func:`steal_half_transfers` — iterative pairwise balancing: while the
  spread is large, the richest bin sends half its surplus over the mean to
  the poorest bin (exactly the paper's steal-half rule applied until
  convergence).  Returns the transfer matrix, e.g. to re-issue input shards
  away from stragglers.

Each function computes on the device of the tensor it is given and reads
nothing back to the host.  Ties resolve as in the reference: the sort is
stable, and ``argmin``/``argmax`` return the first index.  The balancing
loop runs all ``max_rounds`` rounds, each a no-op once the reference's
``while`` condition fails (a balanced load stays balanced), so the result
is the reference's without a host read per round.
"""
from __future__ import annotations

import torch

__all__ = ["greedy_weighted_partition", "steal_half_transfers",
           "partition_cost"]


def greedy_weighted_partition(weights: torch.Tensor,
                              num_bins: int) -> torch.Tensor:
    """Assign each item to a bin, heaviest-first onto the least-loaded bin.

    Args:
      weights: [N] nonnegative work estimates (transitive weights).
      num_bins: number of places/shards.
    Returns:
      [N] int32 bin ids.
    """
    n = weights.shape[0]
    order = torch.argsort(-weights, stable=True)
    loads = torch.zeros(num_bins, dtype=weights.dtype, device=weights.device)
    assign = torch.zeros(n, dtype=torch.int32, device=weights.device)
    for i in range(n):
        item = order[i]
        b = torch.argmin(loads)
        loads[b] += weights[item]
        assign[item] = b.to(torch.int32)
    return assign


def steal_half_transfers(loads: torch.Tensor, max_rounds: int = 16,
                         rel_tol: float = 0.05):
    """Pairwise steal-half-work until balanced.

    Each round the poorest bin steals ``(richest - mean) / 2`` from the
    richest bin (the paper's rule: a steal moves half the victim's surplus
    work).  Stops when ``max/mean - 1 <= rel_tol`` or after ``max_rounds``.

    Returns (transfers [P, P], final_loads [P]) where ``transfers[i, j]`` is
    the amount of work moved i → j.
    """
    p = loads.shape[0]
    cur = loads.to(torch.float32).clone()
    mean = torch.mean(cur)
    limit = mean * (1.0 + rel_tol)
    transfers = torch.zeros((p, p), dtype=torch.float32, device=cur.device)
    for _ in range(max_rounds):
        go = torch.max(cur) > limit
        rich = torch.argmax(cur)
        poor = torch.argmin(cur)
        amount = torch.where(go, torch.clamp_min((cur[rich] - mean) * 0.5,
                                                 0.0), 0.0)
        cur[rich] += -amount
        cur[poor] += amount
        transfers[rich, poor] += amount
    return transfers, cur


def partition_cost(weights: torch.Tensor, assign: torch.Tensor,
                   num_bins: int) -> torch.Tensor:
    """Makespan (max bin load) of an assignment — lower is better."""
    loads = torch.zeros(num_bins, dtype=weights.dtype, device=weights.device)
    loads.index_add_(0, assign.long(), weights)
    return torch.max(loads)
