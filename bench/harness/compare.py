"""How ``correct`` is decided: after the window, a sample drawn from the
seed of the requests that were due in the window and finished, with the
longest of them in it and one that held a slot in the upper half of the
batch, until it holds the cell's number of requests and some hundreds of
served tokens.  The plain reference (the cell's family's
``forward_logits``) runs once over each prompt with its served tokens,
from the benchmark's own weights, and each served token is judged by its
gap: how far its reference logit lies below the reference's best at that
position.  Greedy decoding serves the best token of its own logits, so a
sound bf16 program leaves gaps of rounding size only.

The numbers compared, each against a limit in the cell's file:

* ``gap_max``: the widest gap of any served token;
* ``gap_mean``: the mean gap over the served tokens;
* ``mismatch``: the share of served tokens that are not the reference's
  best.

The control (``control_numbers``) puts the reference computed in float8
in the program's place and reads the same numbers for the tokens that it
puts first.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

__all__ = ["draw_sample", "judge", "control_numbers",
           "gap_numbers", "reference_inputs"]


def draw_sample(records: Sequence, seed: int, served_tokens: int,
                requests: int = 1, high_slot: int = 0) -> list:
    """The longest finished request (prompt and output), then others in an
    order drawn from the seed, the first of them one that held a batch slot
    at or above ``high_slot`` where the longest did not, until ``requests``
    requests and ``served_tokens`` served tokens are held."""
    done = sorted((r for r in records if r.done),
                  key=lambda r: r.arrival.prompt_len + r.n_out)
    if not done:
        return []
    out = [done.pop()]
    rng = np.random.default_rng([int(seed), 7])
    rest = [done[i] for i in rng.permutation(len(done))]
    high = [r for r in rest if r.slot >= high_slot]
    if out[0].slot < high_slot and high:
        rest.remove(high[0])
        rest.insert(0, high[0])
    served = out[0].n_out
    for r in rest:
        if served >= served_tokens and len(out) >= requests:
            break
        out.append(r)
        served += r.n_out
    return out


def reference_inputs(sample, outputs: Dict[int, List[int]], device):
    """Each request's prompt and served tokens but the last, the row of its
    first served token, and the served tokens."""
    seqs, rows, served = [], [], []
    for r in sample:
        toks = list(outputs[r.rid])
        seqs.append(torch.as_tensor(
            np.concatenate([r.arrival.tokens, np.asarray(toks[:-1],
                                                         np.int64)]),
            device=device))
        rows.append(r.arrival.prompt_len - 1)
        served.append(torch.as_tensor(toks, device=device))
    return seqs, rows, served


def _gaps(ref: Sequence[torch.Tensor], tokens: Sequence[torch.Tensor]):
    gaps, miss = [], []
    for logits, tok in zip(ref, tokens):
        at = logits.gather(1, tok.long()[:, None])[:, 0]
        best = logits.max(dim=1)
        gaps.append(best.values - at)
        miss.append(best.indices != tok.long())
    return torch.cat(gaps), torch.cat(miss)


def _summary(gaps: torch.Tensor, miss: torch.Tensor) -> dict:
    return {"gap_max": float(gaps.max()), "gap_mean": float(gaps.mean()),
            "mismatch": float(miss.float().mean()),
            "served_tokens": int(gaps.numel())}


def gap_numbers(ref: Sequence[torch.Tensor],
                tokens: Sequence[torch.Tensor]) -> dict:
    """The numbers of ``tokens`` judged by the reference's logits."""
    return _summary(*_gaps(ref, tokens))


def control_numbers(family, weights, sizes, seqs, rows, ref=None) -> dict:
    """The numbers of the family's float8 reference in the program's
    place: at each position the token it puts first, judged by the fp32
    reference (``ref``, computed here when not given)."""
    if ref is None:
        ref = family.forward_logits(weights, sizes, seqs, rows)
    ctrl = family.forward_logits(weights, sizes, seqs, rows, quant="fp8")
    return gap_numbers(ref, [c.argmax(dim=1) for c in ctrl])


def judge(found: dict, limits: dict) -> tuple:
    """(correct, checks): every number with a limit at or under it."""
    checks = {k: {"value": found.get(k), "limit": v}
              for k, v in limits.items()}
    ok = bool(found) and all(c["value"] is not None
                             and c["value"] <= c["limit"]
                             for c in checks.values())
    return ok, checks
