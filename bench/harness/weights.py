"""The model's weights, made by the benchmark on the device from the seed:
one ``torch.Generator`` on the device, one ``normal_`` call a leaf, in the
type the leaf is served in, leaf by leaf in the order of the cell's family
(``leaf_specs``: the port's parameter tree and each leaf's distribution).
Both the program and the plain reference read these tensors; neither
draws its own.
"""
from __future__ import annotations

import torch

__all__ = ["make_weights"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _child(node, key, empty):
    """``node[key]``, set to ``empty`` where missing (a list grows to
    ``key``)."""
    if isinstance(node, list):
        node.extend([None] * (key + 1 - len(node)))
        if node[key] is None:
            node[key] = empty
        return node[key]
    return node.setdefault(key, empty)


def make_weights(family, sizes: dict, seed: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    tree: dict = {}
    for path, shape, dt, mean, std in family.leaf_specs(sizes):
        node = tree
        for key, nxt in zip(path[:-1], path[1:]):
            node = _child(node, key, [] if isinstance(nxt, int) else {})
        _child(node, path[-1], torch.empty(
            shape, dtype=_DTYPES[dt or sizes["dtype"]],
            device=device).normal_(mean, std, generator=gen))
    return tree
