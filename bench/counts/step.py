"""Model FLOPs of the work a step does: 2 FLOPs a token for every
parameter the token passes through (attention's projections, the dense
MLP or the router and the k experts it was routed to, the output head
where logits are taken), plus attention's 4 * head_dim FLOPs a query head
for every key it sees.  The embedding lookup is no FLOP.  Useful work
only: empty decode slots and padding are not counted."""
from typing import Optional


def layer_params_per_token(s: dict) -> int:
    d, h, hkv, hd = s["d_model"], s["num_heads"], s["num_kv_heads"], \
        s["head_dim"]
    attn = d * (h + 2 * hkv) * hd + h * hd * d
    if s["num_experts"]:
        ffn = s["top_k"] * 3 * d * s["d_ff"] + d * s["num_experts"]
    else:
        ffn = 3 * d * s["d_ff"]
    return attn + ffn


def _visible(pos: int, window: Optional[int]) -> int:
    """Keys a query at position ``pos`` sees."""
    return pos + 1 if window is None else min(pos + 1, window)


def token_flops(s: dict, pos: int, logits: bool) -> int:
    """One token at position ``pos`` through every layer."""
    per_layer = 2 * layer_params_per_token(s) + 4 * s["head_dim"] \
        * s["num_heads"] * _visible(pos, s.get("sliding_window"))
    head = 2 * s["d_model"] * s["vocab_size"] if logits else 0
    return s["num_layers"] * per_layer + head


def _visible_sum(start: int, n: int, window: Optional[int]) -> int:
    """Keys seen by queries at positions start..start+n-1, summed."""
    lo, hi = start + 1, start + n            # each query sees min(p+1, w)
    cut = hi if window is None else min(hi, window)
    below = (lo + cut) * (cut - lo + 1) // 2 if cut >= lo else 0
    return below + (hi - max(cut, lo - 1)) * (window or 0)


def chunk_flops(s: dict, start: int, n: int) -> int:
    """A prefill chunk of ``n`` tokens at positions start..start+n-1, the
    logits of its last row only."""
    attn = 4 * s["head_dim"] * s["num_heads"] * _visible_sum(
        start, n, s.get("sliding_window"))
    return s["num_layers"] * (2 * n * layer_params_per_token(s) + attn) \
        + 2 * s["d_model"] * s["vocab_size"]


def decode_flops(s: dict, positions) -> int:
    """One decode step of the live sequences at ``positions``."""
    return sum(token_flops(s, int(p), True) for p in positions)
