"""Weight bridge: the reference's parameter tree, as numpy arrays, into the
port's tensors.

The tree is what ``repro``'s ``model.init`` returns, mapped through
``np.asarray``: nested dicts with layer-stacked ``[L, ...]`` leaves under
``"blocks"`` (for ``moe``, ``blocks/moe/{router/w, w_gate, w_up, w_down}``
with ``[L, E, ...]`` expert leaves; for ``ssm``, ``blocks/{ln1, tm, ln2,
cm}``).  The port keeps that tree and those layouts, so the bridge is a
leaf-by-leaf copy.  bf16 leaves arrive as ``ml_dtypes`` bfloat16 arrays;
they are viewed as ``uint16`` and then as ``torch.bfloat16``, bit for bit,
without importing ``ml_dtypes``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .configs.base import ModelConfig

__all__ = ["from_numpy_params"]


def _leaf(a, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    t = t.to(device)
    return t if dtype is None else t.to(dtype)


def _convert(tree, device, dtype, path=""):
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype, f"{path}/{k}")
                for k, v in tree.items()}
    # the MoE router and RWKV's decay bias and bonus stay fp32 whatever the
    # model's dtype, as in the reference's init
    keep = path.endswith(("/moe/router/w", "/tm/w0", "/tm/u"))
    return _leaf(tree, device, None if keep else dtype)


def from_numpy_params(tree: dict, cfg: ModelConfig, device,
                      dtype: Optional[torch.dtype] = None) -> dict:
    """Convert the reference's numpy parameter tree for a ``dense``,
    ``moe`` or ``ssm`` config.  ``dtype`` casts every leaf but the fp32 MoE
    router and RWKV ``w0`` and ``u`` (None keeps each leaf's own type)."""
    if cfg.family not in ("dense", "moe", "ssm"):
        raise NotImplementedError(f"family {cfg.family!r} is not yet ported")
    want = {"embed", "blocks", "ln_f"} | (set() if cfg.tie_embeddings
                                          else {"lm_head"})
    if set(tree) != want:
        raise ValueError(f"parameter tree has {sorted(tree)}, "
                         f"{cfg.name} needs {sorted(want)}")

    def check_stacked(sub, path):
        if isinstance(sub, dict):
            for k, v in sub.items():
                check_stacked(v, f"{path}/{k}")
        elif np.shape(sub)[0] != cfg.num_layers:
            raise ValueError(f"{path}: leading dim {np.shape(sub)[0]} != "
                             f"{cfg.num_layers} layers")

    check_stacked(tree["blocks"], "blocks")
    return _convert(tree, torch.device(device), dtype)
