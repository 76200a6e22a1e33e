"""Mixture-of-Experts layer with strategy-scheduled dispatch.

The PyTorch counterpart of ``repro/models/moe.py``.  Routing and dispatch
are the paper's decision procedure (``core/device/moe_balance.py``): router
probability = task priority, capacity overflow = dead tasks, second-choice
restealing = idle experts stealing shed work.

Expert compute is a grouped SwiGLU over the dispatch buffers
([E, C, D] × [E, D, F]): the hand-written kernel (``kernels/moe_gmm``) with
``use_kernel``, else the einsum path of the reference.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core.device.moe_balance import (combine_expert_outputs,
                                       gather_expert_inputs,
                                       priority_dispatch, route_topk)
from ..kernels.moe_gmm import grouped_swiglu
from .layers import init_linear

__all__ = ["init_moe", "moe_fwd", "MoEStats", "moe_capacity"]


class MoEStats(NamedTuple):
    load: torch.Tensor          # [E] tokens kept per expert
    dropped_mass: torch.Tensor  # [] router prob mass dropped (dead tasks)
    aux_loss: torch.Tensor      # [] load-balancing auxiliary loss


def moe_capacity(cfg: ModelConfig, num_tokens: int) -> int:
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    return max(1, int(num_tokens * k * cfg.capacity_factor / e + 0.5))


def init_moe(gen: torch.Generator, cfg: ModelConfig,
             dtype=torch.bfloat16) -> dict:
    """The reference's distributions: He-normal fp32 router, normal/√D
    gate and up, normal/√F down.  Each expert leaf is drawn in fp32 and
    cast, one leaf at a time."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.resolved_moe_d_ff
    dev = gen.device

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=dev).mul_(
            scale).to(dtype)

    return {
        "router": init_linear(gen, d, e, dtype=torch.float32),
        "w_gate": normal((e, d, f), 1.0 / math.sqrt(d)),
        "w_up": normal((e, d, f), 1.0 / math.sqrt(d)),
        "w_down": normal((e, f, d), 1.0 / math.sqrt(f)),
    }


def _expert_ffn(p: dict, buf: torch.Tensor, use_kernel: bool,
                load: torch.Tensor) -> torch.Tensor:
    """buf: [E, C, D] → [E, C, D] per-expert SwiGLU (grouped matmul)."""
    if use_kernel:
        return grouped_swiglu(buf, p["w_gate"], p["w_up"], p["w_down"], load)
    # the reference's einsum path: in bf16, g and u are rounded to bf16
    # before the SwiGLU, which the kernel does not do
    g = torch.bmm(buf, p["w_gate"])
    u = torch.bmm(buf, p["w_up"])
    return torch.bmm(F.silu(g) * u, p["w_down"])


def moe_fwd(p: dict, x: torch.Tensor, cfg: ModelConfig,
            use_kernel: bool = False) -> tuple[torch.Tensor, MoEStats]:
    """x: [B, S, D] (or [T, D]) → same shape + stats."""
    orig_shape = x.shape
    d = orig_shape[-1]
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    # Dropless: capacity = T is the exact worst case (a token's top-k
    # experts are distinct), so no assignment sheds and decode ≡ forward.
    # Droppy: the configured capacity, clamped to the same T bound.
    cap = t if cfg.moe_dropless else min(moe_capacity(cfg, t), t)

    logits = xt.float() @ p["router"]["w"]
    expert_idx, gate, probs = route_topk(logits, k)
    plan = priority_dispatch(expert_idx, gate, probs, num_experts=e,
                             capacity=cap, policy=cfg.dispatch_policy,
                             resteal=cfg.dispatch_resteal)
    buf = gather_expert_inputs(xt, plan, k)          # [E, C, D]
    buf = _expert_ffn(p, buf, use_kernel, plan.load)
    y = combine_expert_outputs(buf, plan, t, k).to(x.dtype)

    # Switch-style load-balance aux loss: E * Σ_e f_e · P_e.
    me = probs.mean(0)                                # mean router prob [E]
    ce = plan.load.float() / torch.clamp(plan.load.sum(), min=1)
    aux = e * torch.sum(me * ce)
    stats = MoEStats(load=plan.load, dropped_mass=plan.dropped_mass,
                     aux_loss=aux)
    return y.reshape(orig_shape), stats
