"""Weight bridge: the reference's parameter tree, as numpy arrays, into the
port's tensors.

The tree is what ``repro``'s ``model.init`` returns, mapped through
``np.asarray``: nested dicts with layer-stacked ``[L, ...]`` leaves under
``"blocks"`` (for ``moe``, ``blocks/moe/{router/w, w_gate, w_up, w_down}``
with ``[L, E, ...]`` expert leaves; for ``ssm``, ``blocks/{ln1, tm, ln2,
cm}``; ``vlm`` adds the unstacked projector ``vis_proj/{fc1, fc2}/w``).
The ``hybrid`` tree stacks superblocks instead: ``superblocks/
layers`` is a list of a superblock's layers, each leaf ``[n_sb, ...]``.  The
``encdec`` tree has two stacks, ``enc_blocks`` ``[num_encoder_layers,
...]`` and ``dec_blocks`` ``[num_layers, ...]``, with ``enc_ln_f`` and,
where the source width differs from ``d_model``, ``audio_proj``.  The
port keeps those trees and layouts, so the bridge is a leaf-by-leaf copy.
bf16 leaves arrive as ``ml_dtypes`` bfloat16 arrays;
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
    if isinstance(tree, list):
        return [_convert(v, device, dtype, f"{path}/{i}")
                for i, v in enumerate(tree)]
    # the MoE router, RWKV's decay bias and bonus, and Mamba's A and D stay
    # fp32 whatever the model's dtype, as in the reference's init
    keep = path.endswith(("/moe/router/w", "/tm/w0", "/tm/u",
                          "/mamba/a_log", "/mamba/d_skip"))
    return _leaf(tree, device, None if keep else dtype)


def from_numpy_params(tree: dict, cfg: ModelConfig, device,
                      dtype: Optional[torch.dtype] = None) -> dict:
    """Convert the reference's numpy parameter tree for a config of any
    family.  ``dtype`` casts every leaf but the fp32 MoE router, RWKV
    ``w0`` and ``u`` and Mamba ``a_log`` and ``d_skip`` (None keeps each
    leaf's own type)."""
    if cfg.family == "hybrid":
        stacks = {"superblocks": (cfg.num_layers // cfg.attn_every,
                                  "superblocks")}
    elif cfg.family == "encdec":
        stacks = {"enc_blocks": (cfg.num_encoder_layers, "encoder layers"),
                  "dec_blocks": (cfg.num_layers, "decoder layers")}
    else:
        stacks = {"blocks": (cfg.num_layers, "layers")}
    want = {"embed", "ln_f", *stacks} | (set() if cfg.tie_embeddings
                                         else {"lm_head"})
    if cfg.vision_embed_dim:
        want.add("vis_proj")
    if cfg.family == "encdec":
        want.add("enc_ln_f")
        if cfg.audio_embed_dim and cfg.audio_embed_dim != cfg.d_model:
            want.add("audio_proj")
    if set(tree) != want:
        raise ValueError(f"parameter tree has {sorted(tree)}, "
                         f"{cfg.name} needs {sorted(want)}")
    if cfg.vision_embed_dim:
        shapes = {k: np.shape(v.get("w")) if isinstance(v, dict) else None
                  for k, v in tree["vis_proj"].items()}
        need = {"fc1": (cfg.vision_embed_dim, cfg.d_model),
                "fc2": (cfg.d_model, cfg.d_model)}
        if shapes != need:
            raise ValueError(f"vis_proj has {shapes}, {cfg.name} needs "
                             f"{need}")

    def check_stacked(sub, path, lead, unit):
        if isinstance(sub, (dict, list)):
            items = sub.items() if isinstance(sub, dict) else enumerate(sub)
            for k, v in items:
                check_stacked(v, f"{path}/{k}", lead, unit)
        elif np.shape(sub)[0] != lead:
            raise ValueError(f"{path}: leading dim {np.shape(sub)[0]} != "
                             f"{lead} {unit}")

    for name, (lead, unit) in stacks.items():
        check_stacked(tree[name], name, lead, unit)
    return _convert(tree, torch.device(device), dtype)
