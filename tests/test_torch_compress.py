"""Gradient compression against the reference: ``error_feedback_compress``
bit for bit on seeded numpy gradients, and ``compressed_allreduce`` in a
spawned 2-rank gloo world: the bf16 formula on each rank's own gradients,
and the reference's bits when every rank passes the same ones."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_worlds as worlds
from repro.optim import compress as ref
from repro_torch.optim import (compressed_allreduce,
                               error_feedback_compress)
from repro_torch.tree import tree_map


def _tree(rng, scale=1.0):
    return {"w": (rng.standard_normal((33, 17)) * scale).astype(np.float32),
            "blocks": {"b": [(rng.standard_normal(5) * scale).astype(
                np.float32)]},
            "big": (rng.standard_normal((3, 1000)) * 1e3 * scale).astype(
                np.float32)}


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint32)


def _torch_bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_error_feedback_compress_bit_exact(seed):
    rng = np.random.default_rng(seed)
    grads, error = _tree(rng), _tree(rng, 1e-3)
    want_q, want_e = ref.error_feedback_compress(
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, error))
    got_q, got_e = error_feedback_compress(tree_map(torch.from_numpy, grads),
                                           tree_map(torch.from_numpy, error))
    for want, got in ((want_q, got_q), (want_e, got_e)):
        flat_w = jax.tree.leaves(want)
        flat_g = [x for x in _leaves(got)]
        assert len(flat_w) == len(flat_g)
        for w, g in zip(flat_w, flat_g):
            assert g.dtype == (torch.bfloat16 if w.dtype == jnp.bfloat16
                               else torch.float32)
            np.testing.assert_array_equal(_bits(w), _torch_bits(g))


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@pytest.fixture(scope="module", params=[False, True],
                ids=["own_grads", "same_grads"])
def reduced(request, tmp_path_factory):
    return request.param, worlds.run_world(
        "compress", 2, 1, tmp_path_factory.mktemp("compress"),
        axis="data", same=request.param)


def test_compressed_allreduce_is_the_bf16_mean(reduced):
    """bf16(g + e) summed over the 2 ranks in bf16, halved in bf16, widened:
    the reference's order of operations."""
    _, res = reduced
    comp = res["comp_by_rank"]
    want = tree_map(lambda a, b: ((a.float() + b.float()).to(torch.bfloat16)
                                  / 2).float(), comp[0], comp[1])
    for w, g in zip(_leaves(want), _leaves(res["reduced"])):
        np.testing.assert_array_equal(_torch_bits(w), _torch_bits(g))


def test_compressed_allreduce_residual_and_reference_bits(reduced):
    """The new error is rank 0's residual, bit for bit; with the same
    gradients on both ranks the reduced tree is the reference's (a mesh of
    one pod here: the mean of equal values is that value)."""
    same, res = reduced
    grads = tree_map(lambda x: x.numpy(), res["grads"])
    error = tree_map(lambda x: x.numpy(), res["error"])
    _, want_e = ref.error_feedback_compress(
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, error))
    for w, g in zip(jax.tree.leaves(want_e), _leaves(res["new_err"])):
        np.testing.assert_array_equal(_bits(w), _torch_bits(g))
    if not same:
        return
    mesh = jax.make_mesh((1,), ("pod",))
    want, _ = ref.compressed_allreduce(jax.tree.map(jnp.asarray, grads),
                                       jax.tree.map(jnp.asarray, error),
                                       mesh, "pod")
    for w, g in zip(jax.tree.leaves(want), _leaves(res["reduced"])):
        np.testing.assert_array_equal(_bits(w), _torch_bits(g))


def test_compressed_allreduce_on_one_rank_is_the_compression():
    """A world of one rank: the reduced tree is bf16(g + e) widened."""
    from repro_torch.launch.mesh import fake_world, make_host_mesh
    rng = np.random.default_rng(3)
    grads = tree_map(torch.from_numpy, _tree(rng))
    error = tree_map(torch.from_numpy, _tree(rng, 1e-3))
    with fake_world(1):
        mesh = make_host_mesh(1, 1, "cpu")
        got, new_err = compressed_allreduce(grads, error, mesh, "data")
    q, e = error_feedback_compress(grads, error)
    for a, b in zip(_leaves(got), _leaves(q)):
        assert torch.equal(a, b.float())
    for a, b in zip(_leaves(new_err), _leaves(e)):
        assert torch.equal(a, b)
