"""The port's steps on DTensors against the same steps on plain tensors:
spawned gloo worlds of (data=1, model=2) and (data=2, model=2) on the CPU
run scaled qwen2-1.5b (fp32, the reference's weights) and scaled
Mixtral-8x22B (fp32, the port's init) through the forward, prefill, 4
greedy decode steps and one train step, sharded by the reference's rules
with ``activation_sharding`` on; one case is held against the JAX
reference directly.  Also: ``_pin``'s placements, and the kernel wrappers
refusing DTensors.

Tolerances: logits, caches and gradients within ``REL`` of the largest
|value| (a sharded matmul sums its partial products in another order, so
fp32 results differ in the last bits); greedy tokens identical; the
parameters after one AdamW step within ``STEP_REL`` of the learning rate
(the first step is lr·g/(|g| + eps) per element, which turns the last-bit
differences of gradients near eps into larger ones)."""
import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

import _torch_mesh_worlds as worlds
from _torch_parity import models
from repro_torch.configs import get_config, scale_down
from repro_torch.launch.mesh import fake_world, make_host_mesh
from repro_torch.models import transformer

REL = 1e-5
STEP_REL = 0.05
LR = 1e-2
MESHES = [(1, 2), (2, 2)]
ARCHS = ["qwen2-1.5b", "mixtral-8x22b"]


@pytest.fixture(scope="module", params=MESHES,
                ids=lambda m: f"data{m[0]}_model{m[1]}")
def world(request, tmp_path_factory):
    """Each mesh's world, run once: rank 0's results, and the JAX model,
    parameters and batch of the qwen case."""
    tmp = tmp_path_factory.mktemp("world")
    jmodel, jparams, _, _ = models(0, "qwen2-1.5b")
    weights = tmp / "qwen.pt"
    torch.save(jax.tree.map(np.asarray, jparams), weights)
    data, model = request.param
    res = worlds.run_world("models", data, model, tmp,
                           weights={"qwen2-1.5b": str(weights),
                                    "mixtral-8x22b": None})
    return res, (jmodel, jparams)


def _close(a, b, rel=REL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(a).max(), 1e-30)
    assert a.shape == b.shape
    err = np.abs(a - b).max() / scale
    assert err <= rel, err


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("what", ["fwd", "prefill", "cache_k", "decode"])
def test_sharded_steps_match_unsharded(world, arch, what):
    res = world[0][arch]
    _close(res["plain"][what], res["sharded"][what])


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_greedy_tokens_identical(world, arch):
    res = world[0][arch]
    assert res["plain"]["tokens"].shape == (worlds.B, worlds.STEPS)
    assert torch.equal(res["plain"]["tokens"], res["sharded"]["tokens"])


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_unsharded(world, arch):
    plain, sharded = world[0][arch]["plain"], world[0][arch]["sharded"]
    for k in plain["train"]:
        _close(plain["train"][k], sharded["train"][k])
    assert set(plain["grads"]) == set(sharded["grads"])
    for k in plain["grads"]:
        _close(plain["grads"][k], sharded["grads"][k])
    for k in plain["params"]:
        err = (plain["params"][k] - sharded["params"][k]).abs().max()
        assert float(err) <= STEP_REL * LR, (k, float(err))


def test_sharded_forward_matches_the_reference(world):
    """The sharded port's qwen logits against ``jax`` on the same weights
    and tokens."""
    jmodel, jparams = world[1]
    tokens, _ = worlds._batch(None, worlds._cfg("qwen2-1.5b"), 1,
                              placed=False)
    want = jmodel.forward(jparams, {"tokens": jax.numpy.asarray(
        tokens.numpy())}).logits
    _close(np.asarray(want), world[0]["qwen2-1.5b"]["sharded"]["fwd"])


def test_params_placed_by_the_rules(world):
    placed = world[0]["qwen2-1.5b"]["placements"]
    assert placed["blocks/attn/wq/w"] == ("R", "S(2)")
    assert placed["blocks/attn/wo/w"] == ("R", "S(1)")
    assert placed["embed/table"] == ("R", "S(0)")
    assert placed["blocks/ln1/scale"] == ("R", "R")
    moe = world[0]["mixtral-8x22b"]["placements"]
    # 4 experts split over 2 model ranks: expert parallel
    assert moe["blocks/moe/w_gate"] == ("R", "S(1)")
    assert moe["blocks/moe/router/w"] == ("R", "R")


def test_pin_shards_the_batch_at_every_layer_boundary(world):
    """With ``activation_sharding``, the embedding and every block's
    output are pinned to ``Shard(0)`` on 'data', replicated on 'model';
    on plain tensors ``_pin`` is the identity."""
    res = world[0]["qwen2-1.5b"]
    n = worlds._cfg("qwen2-1.5b").num_layers + 1
    assert res["sharded"]["pin_fwd"] == [("S(0)", "R")] * n
    assert res["plain"]["pin_fwd"] == [None] * n


def _dtensor(mesh, shape, placements):
    return DTensor.from_local(torch.zeros(shape), mesh, placements,
                              run_check=False)


def test_pin_placements_and_identity():
    cfg = scale_down(get_config("mixtral-8x22b")).replace(
        activation_sharding=True)
    with fake_world(4):
        mesh = make_host_mesh(2, 2, "cpu")
        x = _dtensor(mesh, (2, 3, 8), [Replicate(), Shard(2)])
        assert transformer._pin(x, cfg).placements == (Shard(0),
                                                       Replicate())
        moe = cfg.replace(activation_sharding_moe_model=True)
        assert transformer._pin(x, moe).placements == (Shard(0), Shard(2))
        dense = scale_down(get_config("qwen2-1.5b")).replace(
            activation_sharding=True, activation_sharding_moe_model=True)
        assert transformer._pin(x, dense).placements == (Shard(0),
                                                         Replicate())
        assert transformer._pin(x, cfg.replace(
            activation_sharding=False)) is x
        plain = torch.zeros(2, 3, 8)
        assert transformer._pin(plain, cfg) is plain
        model_only = make_host_mesh(1, 4, "cpu")["model"]
        y = _dtensor(model_only, (2, 3, 8), [Replicate()])
        assert transformer._pin(y, cfg) is y          # no 'data' axis


def test_kernel_wrappers_refuse_dtensors():
    """A kernel takes raw pointers to whole tensors: every wrapper raises
    on a DTensor, on the CPU as on the card, before any route is taken."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gmm import grouped_swiglu
    from repro_torch.kernels.prefix_scan import prefix_scan
    from repro_torch.kernels.wkv6 import wkv6
    with fake_world(2):
        mesh = make_host_mesh(1, 2, "cpu")

        def dt(*shape):
            return _dtensor(mesh, shape, [Replicate(), Replicate()])
        q = dt(1, 4, 2, 8)
        calls = {
            "flash_attention": lambda: flash_attention(q, q, q),
            "grouped_swiglu": lambda: grouped_swiglu(
                dt(2, 4, 8), dt(2, 8, 16), dt(2, 8, 16), dt(2, 16, 8)),
            "prefix_scan": lambda: prefix_scan(dt(2, 16)),
            "wkv6": lambda: wkv6(q, q, q, q, torch.zeros(2, 8)),
        }
        for name, call in calls.items():
            with pytest.raises(TypeError, match=f"{name}: the kernel takes "
                               "plain tensors"):
                call()
