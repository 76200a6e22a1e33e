"""Spawned gloo worlds on the CPU for the sharded tests: every rank of a
(data x model) world runs one case on ``repro_torch`` alone (no JAX is
imported here), and rank 0 saves what the test compares.

``run_world(case, data, model, tmp)`` starts the world with a ``FileStore``
under ``tmp`` (no TCP port, so concurrent test workers cannot collide),
tears the process group down on every rank, and returns rank 0's result.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.configs import get_config, scale_down
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.optim import (adamw_init, compressed_allreduce,
                               error_feedback_compress)
from repro_torch.params import from_numpy_params
from repro_torch.sharding import (batch_spec, distribute, param_shardings,
                                  placements_for)
from repro_torch.sharding.dtensor import on_mesh
from repro_torch.train import (make_decode_step, make_prefill_step,
                               make_train_step)
from repro_torch.train.step import _loss_and_grads
from repro_torch.tree import tree_leaves_with_path, tree_map

#: the prompt batch, its length, the cache's capacity and the greedy steps
B, S, S_MAX, STEPS = 4, 12, 20, 4


def run_world(case: str, data: int, model: int, tmp, **kw) -> dict:
    world = data * model
    mp.spawn(_worker, args=(world, data, model, str(tmp), case, kw),
             nprocs=world, join=True)
    return torch.load(os.path.join(str(tmp), "result.pt"))


def _worker(rank, world, data, model, tmp, case, kw):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(data, model, "cpu")
        out = CASES[case](mesh, **kw)
        if rank == 0:
            torch.save(out, os.path.join(tmp, "result.pt"))
    finally:
        dist.destroy_process_group()


def _full(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def _cfg(arch: str):
    return scale_down(get_config(arch)).replace(
        dtype="float32", param_dtype="float32", activation_sharding=True)


def _batch(mesh, cfg, seed: int, placed: bool = True):
    """Seeded tokens [B, S], and (``placed``) the same sharded by
    ``batch_spec``."""
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S),
                                           dtype=np.int32))
    if not placed:
        return tokens, None
    return tokens, distribute_tensor(
        tokens, mesh, list(placements_for(batch_spec(mesh) + (None,),
                                          mesh)))


def _clone(tree):
    return tree_map(lambda x: x.clone(), tree)


def steps(mesh, arch: str, weights=None, train: bool = True) -> dict:
    """The unsharded and the sharded port on the same weights: forward
    logits, prefill logits and cache, ``STEPS`` greedy decode steps, and
    one train step (its metrics and the updated parameters)."""
    cfg = _cfg(arch)
    model = build_model(cfg, "cpu")
    params = (model.init(0) if weights is None else
              from_numpy_params(torch.load(weights, weights_only=False),
                                cfg, "cpu"))
    sharded = distribute(params, param_shardings(params, mesh))
    tokens, placed = _batch(mesh, cfg, 1)
    out = {"placements": {k: tuple(str(p) for p in v.placements)
                          for k, v in tree_leaves_with_path(sharded)}}
    with torch.no_grad():
        for name, p, tok in (("plain", params, tokens),
                             ("sharded", sharded, placed)):
            res = out[name] = {}
            res["fwd"] = _full(model.forward(p, {"tokens": tok}).logits)
            if not cfg.num_experts:
                res["pin_fwd"] = _pin_placements(model, p, tok)
            logits, cache = make_prefill_step(model, S_MAX)(
                p, {"tokens": tok})
            res["prefill"] = _full(logits)
            res["cache_k"] = _full(cache.k).clone()
            decode = make_decode_step(model)
            nxt = torch.argmax(logits[:, -1], -1)[:, None].int()
            toks, steps_logits = [], []
            for i in range(STEPS):
                nxt, lg, cache = decode(p, nxt, cache, torch.tensor(S + i))
                toks.append(_full(nxt))
                steps_logits.append(_full(lg))
            res["tokens"] = torch.cat(toks, 1)
            res["decode"] = torch.stack(steps_logits)
    if train:
        labels = tokens.roll(-1, 1)
        for name, p, tok in (("plain", params, tokens),
                             ("sharded", sharded, placed)):
            p = _clone(p)
            lab = (labels if name == "plain" else
                   distribute_tensor(labels, mesh, placed.placements))
            _, grads = on_mesh(_loss_and_grads)(
                model, p, {"tokens": tok, "labels": lab})
            out[name]["grads"] = {k: _full(v)
                                  for k, v in tree_leaves_with_path(grads)}
            step = make_train_step(model)
            p, _, met = step(p, adamw_init(p), {"tokens": tok,
                                                "labels": lab}, 1e-2)
            out[name]["train"] = {k: _full(v) for k, v in met.items()}
            out[name]["params"] = {k: _full(v)
                                   for k, v in tree_leaves_with_path(p)}
    return out


def _pin_placements(model, params, tok):
    """The placements of the activations that ``_pin`` returns."""
    from repro_torch.models import transformer
    seen = []
    pin = transformer._pin

    def spy(x, cfg):
        y = pin(x, cfg)
        seen.append(tuple(str(p) for p in y.placements)
                    if isinstance(y, DTensor) else None)
        return y
    transformer._pin = spy
    try:
        model.forward(params, {"tokens": tok})
    finally:
        transformer._pin = pin
    return seen


def compress(mesh, axis: str, same: bool) -> dict:
    """``compressed_allreduce`` over ``axis`` on seeded fp32 gradients:
    every rank's own (``same`` False) or one set on every rank."""
    rank = dist.get_rank()
    rng = np.random.default_rng(0 if same else 1 + rank)
    grads = {"w": torch.from_numpy(rng.standard_normal((33, 17)).astype(
        np.float32)), "b": [torch.from_numpy(
            rng.standard_normal(5).astype(np.float32))]}
    error = {"w": torch.from_numpy((rng.standard_normal((33, 17)) * 1e-3
                                    ).astype(np.float32)),
             "b": [torch.zeros(5)]}
    reduced, new_err = compressed_allreduce(grads, error, mesh, axis)
    comp, _ = error_feedback_compress(grads, error)
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, comp)
    return {"reduced": reduced, "new_err": new_err, "grads": grads,
            "error": error, "comp_by_rank": gathered}


def models(mesh, weights: dict) -> dict:
    """``steps`` for each architecture in ``weights`` (arch -> a saved
    reference tree, or None for the port's own init), in one world."""
    return {arch: steps(mesh, arch, w) for arch, w in weights.items()}


CASES = {"steps": steps, "models": models, "compress": compress}
