"""The port's checkpoints against the reference's, in both directions: the
JAX package saves ``{"params", "opt"}`` (bf16 parameters, AdamW's fp32
moments and int32 step) and the port restores every leaf bit for bit, and
the other way round; the port's keys are the reference's tree paths; the
manager's async saves and GC; the supervisor's bit-exact recovery with the
port's manager (the counterpart of
``tests/test_checkpoint_runtime.py::test_supervisor_bitexact_recovery``)."""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.checkpoint.ckpt import _flatten as jax_flatten
from repro.configs import get_config as jax_get_config
from repro.configs import scale_down as jax_scale_down
from repro.models import build_model as jax_build_model
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.checkpoint.ckpt import _flatten
from repro_torch.configs import get_config, scale_down
from repro_torch.models import build_model
from repro_torch.optim import AdamWState, adamw_init
from repro_torch.params import from_numpy_params
from repro_torch.runtime import SimulatedFailure, TrainSupervisor
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: one intra-op thread is the fastest, and it keeps the
    test workers running in parallel from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _bits(x) -> np.ndarray:
    """A leaf's raw bits (bf16 as uint16), from either package."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@functools.lru_cache(maxsize=None)
def _reference_state(seed=0):
    """The reference's train state for the scaled-down bf16 qwen2-1.5b,
    after one AdamW update (so the moments are not zeros)."""
    cfg = jax_scale_down(jax_get_config("qwen2-1.5b"))

    def make(key):
        params = jax_build_model(cfg).init(key)
        opt = jax_adamw_init(params)
        grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype),
                             params)
        params, opt, _ = jax_adamw_update(grads, opt, params, 1e-3)
        return {"params": params, "opt": opt}

    return jax.jit(make)(jax.random.PRNGKey(seed))


def _port_template():
    model = build_model(scale_down(get_config("qwen2-1.5b")), "cpu")
    params = model.init(1)
    return {"params": params, "opt": adamw_init(params)}


def test_keys_are_the_reference_tree_paths():
    ref = jax_flatten(_reference_state())
    port = _flatten(_port_template())
    assert set(port) == set(ref)
    assert {"opt/.step", "opt/.m/embed/table",
            "params/blocks/attn/wq/w"} <= set(port)
    for k, a in port.items():
        assert a.shape == ref[k].shape, k
        assert a.dtype == ref[k].dtype or (
            a.dtype.kind == "V" and ref[k].dtype.name == "bfloat16"), k


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    state = _reference_state()
    jax_save(str(tmp_path), 7, state)
    got, manifest = restore_checkpoint(str(tmp_path), _port_template())
    assert manifest["step"] == 7
    assert isinstance(got["opt"], AdamWState)
    assert got["params"]["embed"]["table"].dtype == torch.bfloat16
    want = dict(tree_leaves_with_path(state))
    for k, leaf in tree_leaves_with_path(got):
        np.testing.assert_array_equal(_bits(leaf), _bits(want[k]),
                                      err_msg=k)
    assert int(got["opt"].step) == 1


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    template = _reference_state(seed=1)
    cfg = scale_down(get_config("qwen2-1.5b"))
    tree = jax.tree.map(np.asarray, template)
    state = {"params": from_numpy_params(tree["params"], cfg, "cpu"),
             "opt": AdamWState(
                 torch.tensor(5, dtype=torch.int32),
                 *(from_numpy_params(m, cfg, "cpu", torch.float32)
                   for m in (tree["opt"].m, tree["opt"].v)))}
    save_checkpoint(str(tmp_path), 3, state, extra={"note": "port"})
    got, manifest = jax_restore(str(tmp_path), template)
    assert manifest == {**manifest, "step": 3, "extra": {"note": "port"}}
    assert got["params"]["embed"]["table"].dtype == jnp.bfloat16
    want = dict(tree_leaves_with_path(state))
    for kp, leaf in jax.tree_util.tree_flatten_with_path(got)[0]:
        k = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in kp)
        np.testing.assert_array_equal(_bits(leaf), _bits(want[k]),
                                      err_msg=k)


def test_restore_missing_leaf_and_dtype_mismatch(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"a": torch.ones(2)})
    with pytest.raises(KeyError, match="checkpoint missing leaf b"):
        restore_checkpoint(str(tmp_path), {"a": torch.ones(2),
                                           "b": torch.ones(2)})
    save_checkpoint(str(tmp_path), 2, {"a": torch.ones(2, dtype=torch.bfloat16)})
    with pytest.raises(TypeError, match="raw 2-byte leaf"):
        restore_checkpoint(str(tmp_path), {"a": torch.ones(2)})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), {"a": torch.ones(2)})


def _tree():
    return {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.ones(2, dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 5, tree)
    assert latest_step(str(tmp_path)) == 5
    restored, manifest = restore_checkpoint(str(tmp_path), tree)
    assert manifest["step"] == 5
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_manager_async_and_gc(tmp_path):
    """Saves run on a worker thread, one at a time; the last ``keep``
    stay.  A tensor updated in place after ``save`` returns is saved as it
    was at the call."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
        tree["w"].add_(1)
    mgr.wait()
    assert latest_step(str(tmp_path)) == 4
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_000000003", "step_000000004"]
    restored, _ = mgr.restore_latest(_tree())
    assert torch.equal(restored["w"], _tree()["w"] + 3)


def test_checkpoint_manager_reraises_a_failed_save(tmp_path):
    path = tmp_path / "file"
    path.write_text("not a directory")
    mgr = CheckpointManager(str(path))
    mgr.save(1, _tree())
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                       # the error is raised once


def test_supervisor_bitexact_recovery(tmp_path):
    """Failure + restore-from-checkpoint reproduces the uninterrupted run
    exactly (deterministic step function)."""

    def step_fn(state, i):
        return {"x": state["x"] + torch.tensor(i + 1, dtype=torch.float32)}

    def run(inject):
        mgr = CheckpointManager(str(tmp_path) + ("_f" if inject else "_c"),
                                keep=3)
        failed = {"done": False}

        def wrapped(state, i):
            if inject and i == 7 and not failed["done"]:
                failed["done"] = True
                raise SimulatedFailure("chip fell over")
            return step_fn(state, i)

        zero = {"x": torch.tensor(0.0)}
        sup = TrainSupervisor(mgr, wrapped, zero, ckpt_every=3)
        state, step = sup.run(zero, 12)
        return state, sup.restarts

    clean, r0 = run(False)
    faulty, r1 = run(True)
    assert r0 == 0 and r1 == 1
    assert torch.equal(clean["x"], faulty["x"])
    assert float(clean["x"]) == sum(range(1, 13))


def test_restore_onto_a_device(tmp_path):
    """``device`` places every leaf; None keeps each template leaf's."""
    save_checkpoint(str(tmp_path), 1, _tree())
    got, _ = restore_checkpoint(str(tmp_path), _tree(), device="cpu")
    assert all(t.device.type == "cpu" for t in tree_leaves(got))
    assert tree_map(lambda t: t.dtype, got) \
        == tree_map(lambda t: t.dtype, _tree())
