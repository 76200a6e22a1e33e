"""Step functions: training (with microbatch gradient accumulation) and
serving (prefill / decode): the PyTorch counterpart of
``repro/train/step.py``.

Gradients come from autograd over ``model.loss``.  Where the reference
returns new parameter and moment trees, the train step updates them in
place (a full-width model's moments do not fit twice) and returns them.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models.model_zoo import Model
from ..optim.adamw import AdamWState, adamw_update, zeros32
from ..sharding.dtensor import is_dtensor, on_mesh, split_even
from ..tree import tree_leaves_with_path, tree_map, tree_map_with_path

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step"]


def _loss_and_grads(model: Model, params: dict, batch: dict):
    """(metrics, grads) of ``model.loss`` at ``params``: the metrics
    detached, the grads a tree like ``params`` (zeros for a leaf the loss
    does not reach, as ``jax.grad`` gives)."""
    # aliases of the parameters that require grad: the same storage, so the
    # caller's tensors are neither copied nor marked
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = model.loss(live, batch)
    paths, leaves = zip(*tree_leaves_with_path(live))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_path = {k: torch.zeros_like(p) if g is None else g
               for k, p, g in zip(paths, leaves, grads)}
    return ({k: v.detach() for k, v in metrics.items()},
            tree_map_with_path(lambda k, _: by_path[k], live))


def _microbatch(x: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """Rows ``i * B/n .. (i+1) * B/n - 1`` of ``x``.  Under a mesh those
    rows sit on a few ranks: they are gathered and then sharded as ``x``
    is."""
    rows = x.shape[0] // n
    if is_dtensor(x):
        return x[i * rows:(i + 1) * rows].redistribute(x.device_mesh,
                                                        x.placements)
    return x.reshape((n, rows) + x.shape[1:])[i]


def make_train_step(model: Model, *, num_microbatches: int = 1,
                    weight_decay: float = 0.1, clip_norm: float = 1.0,
                    b1: float = 0.9, b2: float = 0.95) -> Callable:
    """Returns train_step(params, opt_state, batch, lr) ->
    (params, opt_state, metrics); ``params`` and the moments are updated in
    place.

    With ``num_microbatches > 1`` the global batch is split along the batch
    axis and gradients accumulate in fp32, ``g / n`` a microbatch, bounding
    activation memory to one microbatch; the metrics are the microbatches'
    means.
    """

    def train_step(params, opt_state: AdamWState, batch: dict, lr):
        n = num_microbatches
        if n == 1:
            metrics, grads = _loss_and_grads(model, params, batch)
        else:
            for k, x in batch.items():
                if x.shape[0] % n:
                    raise ValueError(f"batch[{k!r}] has {x.shape[0]} rows, "
                                     f"not a multiple of {n} microbatches")
            grads = tree_map(zeros32, params)
            mets = []
            for i in range(n):
                mb = {k: _microbatch(x, n, i) for k, x in batch.items()}
                met, g = _loss_and_grads(model, params, mb)
                with torch.no_grad():
                    tree_map(lambda a, gg: a.add_(gg.float() / n), grads, g)
                del g
                mets.append(met)
            metrics = {k: torch.stack([m[k] for m in mets]).mean()
                       for k in mets[0]}
        params, opt_state, om = adamw_update(
            grads, opt_state, params, lr, weight_decay=weight_decay,
            clip_norm=clip_norm, b1=b1, b2=b2)
        return params, opt_state, {**metrics, **om}

    return on_mesh(train_step)


def make_prefill_step(model: Model, s_max: Optional[int] = None) -> Callable:
    @torch.no_grad()
    def prefill_step(params, batch):
        return model.prefill(params, batch, s_max)
    return prefill_step


def make_decode_step(model: Model, *, sample: bool = False,
                     temperature: float = 1.0) -> Callable:
    """decode_step(params, token [B,1], cache, pos, rng=None) ->
    (next_token [B,1] int32, logits, cache).  ``rng`` is a
    ``torch.Generator`` on the model's device: with ``sample`` the next
    token is drawn from softmax(logits / temperature) with it, else (or
    without ``rng``) it is the argmax."""

    @torch.no_grad()
    def decode_step(params, token, cache, pos, rng=None):
        logits, cache = model.decode_step(params, token, cache, pos)
        if sample and rng is not None:
            probs = torch.softmax(logits[:, -1].float() / temperature, -1)
            nxt = torch.multinomial(probs, 1, generator=rng)
        else:
            # under a mesh, over the whole vocab: its shards gathered
            nxt = torch.argmax(split_even(logits[:, -1], -1, 1),
                               dim=-1)[:, None]
        return nxt.int(), logits, cache

    return decode_step
