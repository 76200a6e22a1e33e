"""The model's weights, made by the benchmark on the device from the seed:
one ``torch.Generator`` on the device, one ``normal_`` call a stacked leaf,
in the type the leaf is served in.  The tree is the port's parameter
layout (``init`` of ``repro_torch.models``): layer-stacked ``[L, ...]``
leaves under ``blocks``, linear weights ``[d_in, d_out]`` applied as
``x @ w``, the MoE router in fp32.

Distributions: embedding 0.02 N(0, 1); linears and experts N(0, 1/fan_in)
(the port's He-normal); norm scales 1 + 0.1 N(0, 1), so that the
comparison sees each norm's weight applied.  Both the program and the
plain reference read these tensors; neither draws its own.
"""
from __future__ import annotations

import torch

__all__ = ["make_weights"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _leaf_specs(s: dict) -> list:
    """(path, shape, dtype name or None for the model's, mean, std) in the
    order they are drawn."""
    d, L, v = s["d_model"], s["num_layers"], s["vocab_size"]
    h, hkv, hd = s["num_heads"], s["num_kv_heads"], s["head_dim"]
    f, e = s["d_ff"], s["num_experts"]
    specs = [(("embed", "table"), (v, d), None, 0.0, 0.02),
             (("blocks", "ln1", "scale"), (L, d), None, 1.0, 0.1),
             (("blocks", "attn", "wq", "w"), (L, d, h * hd), None, 0.0,
              d ** -0.5),
             (("blocks", "attn", "wk", "w"), (L, d, hkv * hd), None, 0.0,
              d ** -0.5),
             (("blocks", "attn", "wv", "w"), (L, d, hkv * hd), None, 0.0,
              d ** -0.5),
             (("blocks", "attn", "wo", "w"), (L, h * hd, d), None, 0.0,
              (h * hd) ** -0.5),
             (("blocks", "ln2", "scale"), (L, d), None, 1.0, 0.1)]
    if e:
        specs += [(("blocks", "moe", "router", "w"), (L, d, e), "float32",
                   0.0, d ** -0.5),
                  (("blocks", "moe", "w_gate"), (L, e, d, f), None, 0.0,
                   d ** -0.5),
                  (("blocks", "moe", "w_up"), (L, e, d, f), None, 0.0,
                   d ** -0.5),
                  (("blocks", "moe", "w_down"), (L, e, f, d), None, 0.0,
                   f ** -0.5)]
    else:
        specs += [(("blocks", "mlp", "gate", "w"), (L, d, f), None, 0.0,
                   d ** -0.5),
                  (("blocks", "mlp", "up", "w"), (L, d, f), None, 0.0,
                   d ** -0.5),
                  (("blocks", "mlp", "down", "w"), (L, f, d), None, 0.0,
                   f ** -0.5)]
    specs += [(("ln_f", "scale"), (d,), None, 1.0, 0.1),
              (("lm_head", "w"), (d, v), None, 0.0, d ** -0.5)]
    return specs


def make_weights(sizes: dict, seed: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    tree: dict = {}
    for path, shape, dt, mean, std in _leaf_specs(sizes):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.empty(
            shape, dtype=_DTYPES[dt or sizes["dtype"]],
            device=device).normal_(mean, std, generator=gen)
    return tree
