"""Public wrappers of the MoE layer's route, dispatch and combine.

On CUDA tensors they launch the hand-written kernels
(``csrc/moe_dispatch.cu``) or raise; on CPU tensors they run the plain form
(``ref.py``: ``route_topk``, ``priority_dispatch``,
``gather_expert_inputs``, ``combine_expert_outputs`` and the aux loss).  A
MoE layer call takes three wrapper calls and, on CUDA, at most five
kernels: :func:`moe_route` one, :func:`moe_dispatch` two or three (a rank
pass, a second where restealing can act, the gather), :func:`moe_combine`
one.

``moe_dispatch.launches`` counts the MoE layer calls that took the CUDA
route (one a :func:`moe_dispatch` call), and ``moe_dispatch.kernel_launches``
the kernels that :func:`moe_route`, :func:`moe_dispatch` and
:func:`moe_combine` launched.
"""
from __future__ import annotations

import torch

from .. import refuse_autograd, refuse_dtensor
from ...core.device.moe_balance import DispatchPlan
from .ref import (Dispatched, Routing, moe_combine_plain, moe_dispatch_plain,
                  moe_route_plain)

__all__ = ["moe_route", "moe_dispatch", "moe_combine", "Routing",
           "Dispatched", "rank_list", "rank_passes", "MAX_EXPERTS", "MAX_K",
           "RANK_SMEM_LIMIT"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the route kernel keeps a token's E probabilities in one warp's registers
MAX_EXPERTS = 1024
#: the route and combine kernels keep a token's k choices in registers
MAX_K = 16
#: shared memory a rank CTA may take for its list (8 bytes an entry); a
#: longer list goes to a global scratch
RANK_SMEM_LIMIT = 160 * 1024


def rank_passes(num_tokens: int, capacity: int, resteal: bool) -> int:
    """Rank launches a dispatch takes: two where restealing can move an
    assignment (capacity < T), else one (with capacity >= T the first pass
    keeps everything, and the second only orders by index)."""
    return 2 if resteal and capacity < num_tokens else 1


def rank_list(num_tokens: int, num_choices: int, capacity: int,
              resteal: bool) -> int:
    """The most assignments one expert's rank CTA can collect: T in a first
    pass (a token's choices are distinct experts), T * k in a second (a
    token's dropped choices share one next choice)."""
    if rank_passes(num_tokens, capacity, resteal) == 2:
        return num_tokens * num_choices
    return num_tokens


def _library():
    from .build import LIBRARY
    return LIBRARY.load()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(name: str, t: torch.Tensor, device, dtype, shape) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} "
                         f"{list(shape)} tensor on {device}; got "
                         f"{t.dtype} {list(t.shape)} on {t.device}")


def moe_route(logits: torch.Tensor, k: int, alt: bool = False) -> Routing:
    """logits: [T, E] fp32 -> top-k routing: expert_idx [T, k] int32 (ties
    to the lower expert), gate [T, k] renormalised over the k, probs
    [T, E]; with ``alt`` (CUDA) also the (k+1)-th choice and its
    probability, which the resteal pass of :func:`moe_dispatch` reads."""
    refuse_dtensor("moe_route", logits)
    if logits.device.type == "cpu":
        return moe_route_plain(logits, k)
    if logits.device.type != "cuda":
        raise ValueError(f"moe_route runs on cuda or cpu, not "
                         f"{logits.device}")
    refuse_autograd("moe_route", logits)
    if logits.dim() != 2:
        raise ValueError(f"logits [T, E]; got {list(logits.shape)}")
    t, e = logits.shape
    _check("logits", logits, logits.device, torch.float32, (t, e))
    if not (1 <= e <= MAX_EXPERTS and 1 <= k <= min(e, MAX_K)) or t < 1:
        raise ValueError(f"moe_route takes 1 <= E <= {MAX_EXPERTS}, 1 <= k "
                         f"<= min(E, {MAX_K}), T >= 1; got T={t}, E={e}, "
                         f"k={k}")
    dev = logits.device
    probs = torch.empty(t, e, dtype=torch.float32, device=dev)
    expert = torch.empty(t, k, dtype=torch.int32, device=dev)
    gate = torch.empty(t, k, dtype=torch.float32, device=dev)
    alt_e = torch.empty(t, dtype=torch.int32, device=dev) if alt else None
    alt_p = (torch.empty(t, dtype=torch.float32, device=dev) if alt
             else None)
    lib = _library()
    code = lib.moe_route_fwd(
        logits.data_ptr(), probs.data_ptr(), expert.data_ptr(),
        gate.data_ptr(), None if alt_e is None else alt_e.data_ptr(),
        None if alt_p is None else alt_p.data_ptr(), t, e, k,
        _stream(logits))
    if code != 0:
        raise RuntimeError("moe_route launch failed: "
                           + lib.moe_dispatch_error_string(code).decode())
    moe_dispatch.kernel_launches += 1
    return Routing(expert, gate, probs, alt_e, alt_p)


def moe_dispatch(x: torch.Tensor, routing: Routing, *, num_experts: int,
                 capacity: int, policy: str = "priority",
                 resteal: bool = False) -> Dispatched:
    """x: [T, D] and its routing -> the plan (``DispatchPlan``: the fields,
    meanings and dtypes of ``priority_dispatch``'s), the [E, C, D] expert
    buffer (zeros in empty slots), the aux loss, and (CUDA) each
    assignment's slot.  Where restealing can act (capacity < T) the routing
    must carry the next choice (``moe_route(..., alt=True)``)."""
    refuse_dtensor("moe_dispatch", x, *routing[:3])
    if x.device.type == "cpu":
        return moe_dispatch_plain(x, routing, num_experts=num_experts,
                                  capacity=capacity, policy=policy,
                                  resteal=resteal)
    if x.device.type != "cuda":
        raise ValueError(f"moe_dispatch runs on cuda or cpu, not {x.device}")
    refuse_autograd("moe_dispatch", x, routing.gate, routing.probs)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"moe_dispatch takes float32 or bfloat16 x, not "
                        f"{x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"x [T, D]; got {list(x.shape)}")
    t, d = x.shape
    e, c = num_experts, capacity
    dev = x.device
    expert_idx, gate, probs, alt_e, alt_p = routing
    k = expert_idx.shape[-1]
    _check("x", x, dev, x.dtype, (t, d))
    _check("expert_idx", expert_idx, dev, torch.int32, (t, k))
    _check("gate", gate, dev, torch.float32, (t, k))
    _check("probs", probs, dev, torch.float32, (t, e))
    if (d * x.element_size()) % 16 or x.data_ptr() % 16:
        raise ValueError(f"D={d} must be a multiple of "
                         f"{16 // x.element_size()} for {x.dtype}, and x "
                         f"16-byte aligned")
    if not (1 <= k <= MAX_K and c >= 1):
        raise ValueError(f"moe_dispatch takes 1 <= k <= {MAX_K} and C >= 1; "
                         f"got k={k}, C={c}")
    passes = rank_passes(t, c, resteal)
    if passes == 2:
        if alt_e is None or alt_p is None:
            raise ValueError("resteal with capacity < T needs the routing's "
                             "next choice: moe_route(..., alt=True)")
        _check("alt_expert", alt_e, dev, torch.int32, (t,))
        _check("alt_prob", alt_p, dev, torch.float32, (t,))
    cap = rank_list(t, k, c, resteal)
    kept = torch.empty(t, k, dtype=torch.bool, device=dev)
    expert = torch.empty(t, k, dtype=torch.int32, device=dev)
    gate_out = torch.empty(t, k, dtype=torch.float32, device=dev)
    slot = torch.empty(t, k, dtype=torch.int32, device=dev)
    slot_src = torch.empty(e, c, dtype=torch.int32, device=dev)
    load = torch.empty(e, dtype=torch.int32, device=dev)
    stats = torch.empty(2 * e + 2, dtype=torch.float32, device=dev)
    keep_first = (torch.empty(t * k, dtype=torch.uint8, device=dev)
                  if passes == 2 else None)
    lists = (torch.empty(2 * e * cap, dtype=torch.int32, device=dev)
             if cap * 8 > RANK_SMEM_LIMIT else None)
    buf = torch.empty(e, c, d, dtype=x.dtype, device=dev)
    lib = _library()
    code = lib.moe_dispatch_fwd(
        _DTYPE_CODE[x.dtype], x.data_ptr(), expert_idx.data_ptr(),
        gate.data_ptr(), probs.data_ptr(),
        None if passes == 1 else alt_e.data_ptr(),
        None if passes == 1 else alt_p.data_ptr(),
        None if keep_first is None else keep_first.data_ptr(),
        kept.data_ptr(), expert.data_ptr(), gate_out.data_ptr(),
        slot.data_ptr(), slot_src.data_ptr(), load.data_ptr(),
        stats.data_ptr(), None if lists is None else lists.data_ptr(),
        buf.data_ptr(), t, k, e, c, d, cap, int(policy != "priority"),
        int(resteal), _stream(x))
    if code != 0:
        raise RuntimeError("moe_dispatch launch failed: "
                           + lib.moe_dispatch_error_string(code).decode())
    moe_dispatch.launches += 1
    moe_dispatch.kernel_launches += passes + 1
    plan = DispatchPlan(slot_src=slot_src, kept=kept, expert=expert,
                        gate=gate_out, load=load, dropped_mass=stats[2 * e])
    return Dispatched(plan, buf, stats[2 * e + 1], slot)


def moe_combine(y_buf: torch.Tensor, dispatched: Dispatched, num_tokens: int,
                num_choices: int) -> torch.Tensor:
    """y_buf: [E, C, D] -> [T, D]: each token's expert outputs times their
    gates, added in ascending slot order from +0 in fp32, cast to y_buf's
    dtype (the bits of ``combine_expert_outputs``)."""
    refuse_dtensor("moe_combine", y_buf)
    if y_buf.device.type == "cpu":
        return moe_combine_plain(y_buf, dispatched, num_tokens, num_choices)
    if y_buf.device.type != "cuda":
        raise ValueError(f"moe_combine runs on cuda or cpu, not "
                         f"{y_buf.device}")
    refuse_autograd("moe_combine", y_buf)
    if y_buf.dtype not in _DTYPE_CODE or y_buf.dim() != 3:
        raise ValueError(f"y_buf: float32 or bfloat16 [E, C, D]; got "
                         f"{y_buf.dtype} {list(y_buf.shape)}")
    if dispatched.slot is None:
        raise ValueError("moe_combine on CUDA takes moe_dispatch's CUDA "
                         "result (its slots)")
    dev = y_buf.device
    _check("y_buf", y_buf, dev, y_buf.dtype, tuple(y_buf.shape))
    d = y_buf.shape[2]
    shape = (num_tokens, num_choices)
    _check("slot", dispatched.slot, dev, torch.int32, shape)
    _check("gate", dispatched.plan.gate, dev, torch.float32, shape)
    if (d * y_buf.element_size()) % 16 or y_buf.data_ptr() % 16:
        raise ValueError(f"D={d} must be a multiple of "
                         f"{16 // y_buf.element_size()} for {y_buf.dtype}, "
                         f"and y_buf 16-byte aligned")
    out = torch.empty(num_tokens, d, dtype=y_buf.dtype, device=dev)
    lib = _library()
    code = lib.moe_combine_fwd(
        _DTYPE_CODE[y_buf.dtype], y_buf.data_ptr(),
        dispatched.slot.data_ptr(), dispatched.plan.gate.data_ptr(),
        out.data_ptr(), num_tokens, d, num_choices, _stream(y_buf))
    if code != 0:
        raise RuntimeError("moe_combine launch failed: "
                           + lib.moe_dispatch_error_string(code).decode())
    moe_dispatch.kernel_launches += 1
    return out


moe_dispatch.launches = 0
moe_dispatch.kernel_launches = 0
