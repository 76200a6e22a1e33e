"""Shared building blocks: RMSNorm, GroupNorm, linear, RoPE, SwiGLU MLP,
embeddings.

The PyTorch counterpart of ``repro/models/layers.py``.  Parameters are plain
nested dicts of tensors, in the reference's layouts (linear weights
``[d_in, d_out]`` applied as ``x @ w``); every module is an ``init_*``/apply
pair.  Inits draw from an explicit ``torch.Generator`` on the target device
with the reference's distributions (He-normal linears, embedding x 0.02,
ones for norms, zeros for biases).  Compute happens in ``cfg.dtype``;
normalization statistics in fp32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..sharding.dtensor import flatten, is_dtensor, lookup, unflatten

__all__ = ["dtype_of", "init_linear", "linear", "init_rms_norm", "rms_norm",
           "init_group_norm", "group_norm", "init_embedding", "embed",
           "unembed", "rope_freqs", "apply_rope", "init_mlp", "mlp"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _he(gen: torch.Generator, shape, dtype, fan_in: Optional[int] = None):
    fan = fan_in if fan_in is not None else shape[0]
    x = torch.randn(shape, generator=gen, device=gen.device)
    return (x / math.sqrt(fan)).to(dtype)


def init_linear(gen: torch.Generator, d_in: int, d_out: int, *,
                bias: bool = False, dtype=torch.bfloat16) -> dict:
    p = {"w": _he(gen, (d_in, d_out), dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def init_rms_norm(d: int, dtype=torch.bfloat16, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rms_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * p["scale"]


def init_group_norm(num_groups: int, d: int, dtype=torch.bfloat16,
                    device=None) -> dict:
    del num_groups  # static: callers pass it to group_norm (not a param)
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def group_norm(p: dict, x: torch.Tensor, groups: int,
               eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the last dim split into ``groups`` groups: statistics
    in fp32, cast back to x's type before the scale and bias."""
    xf = unflatten(x.float(), x.ndim - 1, (groups, x.shape[-1] // groups))
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    return flatten(xf, -2).to(x.dtype) * p["scale"] + p["bias"]


def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.bfloat16) -> dict:
    x = torch.randn((vocab, d), generator=gen, device=gen.device)
    return {"table": (x * 0.02).to(dtype)}


def embed(p: dict, tokens: torch.Tensor,
          onehot: bool = False) -> torch.Tensor:
    """Row gather, or with ``onehot`` the reference's matmul form: one-hot
    rows in the table's dtype times the table (one nonzero term a sum, so
    the same values as the gather)."""
    if onehot:
        oh = F.one_hot(tokens.long(), p["table"].shape[0])
        return oh.to(p["table"].dtype) @ p["table"]
    if is_dtensor(p["table"]):
        return lookup(tokens, p["table"])
    return p["table"][tokens]


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["table"].T


# -- rotary ------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)  # [head_dim/2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: broadcastable to [..., S]."""
    if theta <= 0:
        return x
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].float() * inv          # [..., S, hd/2]
    cos = torch.cos(ang)[..., None, :]                # [..., S, 1, hd/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- SwiGLU MLP ---------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, d_ff: int,
             dtype=torch.bfloat16) -> dict:
    return {"gate": init_linear(gen, d, d_ff, dtype=dtype),
            "up": init_linear(gen, d, d_ff, dtype=dtype),
            "down": init_linear(gen, d_ff, d, dtype=dtype)}


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    return linear(p["down"], F.silu(linear(p["gate"], x))
                  * linear(p["up"], x))
