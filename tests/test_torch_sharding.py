"""The port's partition rules against the reference's: every spec of every
config at full size (shape-only trees: ``jax.eval_shape`` against
``FakeTensorMode``) on 16×16 and 2×16×16, in the tp, dp and tp-er layouts,
with and without the dry run's ``fsdp_axes``; every case of
``tests/test_sharding.py``; the placements a spec implies on a
``DeviceMesh``; and the meshes."""
import ast
import pathlib

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.sharding import batch_spec as jax_batch_spec
from repro.sharding import param_specs as jax_param_specs
from repro_torch.configs import get_config, list_configs, scale_down
from repro_torch.launch.mesh import (fake_world, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import build_model
from repro_torch.sharding import (Sharding, batch_spec, distribute,
                                  param_shardings, param_specs,
                                  placements_for, spec_for_path)
from repro_torch.tree import tree_leaves_with_path, tree_map

ROOT = pathlib.Path(__file__).resolve().parents[1]


class _FakeMesh:
    """Shape-only stand-in so rule tests don't need real devices."""

    def __init__(self, **shape):
        self.shape = shape


MESH = _FakeMesh(data=16, model=16)
MESH_POD = _FakeMesh(pod=2, data=16, model=16)

# -- every case of tests/test_sharding.py, on the port ------------------------


def test_attention_rules():
    assert spec_for_path("blocks/attn/wq/w", (28, 1536, 1536), MESH) \
        == (None, None, "model")
    assert spec_for_path("blocks/attn/wo/w", (28, 1536, 1536), MESH) \
        == (None, "model", None)
    assert spec_for_path("blocks/attn/wq/b", (28, 1536), MESH) \
        == (None, "model")


def test_embedding_vocab_sharded():
    assert spec_for_path("embed/table", (151936, 1536), MESH) \
        == ("model", None)


def test_indivisible_dim_falls_back_to_replication():
    # 10 heads*hd=1000 not divisible by 16 → replicated, not an error
    assert spec_for_path("blocks/attn/wq/w", (2, 64, 1000), MESH) \
        == (None, None, None)


def test_expert_parallel_when_divisible():
    # kimi: 384 experts % 16 == 0 → experts sharded over model
    assert spec_for_path("blocks/moe/w_gate", (61, 384, 7168, 2048), MESH) \
        == (None, "model", None, None)
    # mixtral: 8 experts % 16 != 0 → TP inside experts on the wide dim
    assert spec_for_path("blocks/moe/w_gate", (56, 8, 6144, 16384), MESH) \
        == (None, None, None, "model")
    assert spec_for_path("blocks/moe/w_down", (56, 8, 16384, 6144), MESH) \
        == (None, None, "model", None)


def test_fsdp_shards_biggest_replicated_dim():
    spec = spec_for_path("blocks/mlp/gate/w", (88, 12288, 28672), MESH_POD,
                         fsdp_axes=("pod", "data"))
    assert spec == (None, ("pod", "data"), "model")


def test_param_specs_cover_whole_tree():
    cfg = scale_down(get_config("jamba-v0.1-52b"))
    params = build_model(cfg, "cpu").init(0)
    specs = param_specs(params, MESH)
    leaves = list(tree_leaves_with_path(params))
    assert len(leaves) == len(list(_spec_leaves(specs)))
    for path, x in leaves:
        assert len(_spec_at(specs, path)) == x.ndim, path


def test_batch_spec_axes():
    assert batch_spec(MESH) == ("data",)
    assert batch_spec(MESH_POD) == (("pod", "data"),)
    for mesh in (MESH, MESH_POD):
        assert batch_spec(mesh) == tuple(jax_batch_spec(mesh))


def test_rwkv_and_mamba_rules():
    assert spec_for_path("blocks/tm/wr/w", (32, 2560, 2560), MESH) \
        == (None, None, "model")
    assert spec_for_path("blocks/tm/wo/w", (32, 2560, 2560), MESH) \
        == (None, "model", None)
    assert spec_for_path("superblocks/layers/1/mamba/in_proj/w",
                         (4, 4096, 16384), MESH) == (None, None, "model")
    assert spec_for_path("superblocks/layers/1/mamba/a_log",
                         (4, 8192, 16), MESH) == (None, "model", None)


def test_dp_layout_specs_replicate_weights():
    # TP rule applies normally...
    assert spec_for_path("blocks/attn/wq/w", (28, 1536, 1536), MESH) \
        == (None, None, "model")
    # ...but not under the pure-DP layout
    assert spec_for_path("blocks/attn/wq/w", (28, 1536, 1536), MESH,
                         tensor_parallel=False) == (None, None, None)
    # fsdp still shards big leaves over the given axes
    spec = spec_for_path("blocks/attn/wq/w", (28, 1536, 1536), MESH,
                         tensor_parallel=False,
                         fsdp_axes=("data", "model"))
    assert spec == (None, ("data", "model"), None)


def _spec_leaves(specs):
    """The spec tuples of a spec tree (tuples are leaves here)."""
    if isinstance(specs, dict):
        for v in specs.values():
            yield from _spec_leaves(v)
    elif isinstance(specs, list):
        for v in specs:
            yield from _spec_leaves(v)
    else:
        yield specs


def _spec_at(specs, path: str):
    for k in path.split("/"):
        specs = specs[int(k)] if isinstance(specs, list) else specs[k]
    return specs


# -- the rules against the reference at full size -----------------------------

@pytest.fixture(scope="module")
def trees():
    """(reference shape tree, port meta tree) of every config."""
    out = {}
    for arch in list_configs():
        jm = jax_build_model(jax_get_config(arch))
        sds = jax.eval_shape(lambda m=jm: m.init(jax.random.PRNGKey(0)))
        with FakeTensorMode():
            fake = build_model(get_config(arch), "cpu").init(0)
        out[arch] = (sds, fake)
    return out


def _jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    out = {}
    for kp, x in flat:
        parts = [str(getattr(k, "key", getattr(k, "idx", k))) for k in kp]
        out["/".join(parts)] = x
    return out


def _jax_spec_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): x for kp, x in flat}


def _param_bytes(tree) -> int:
    return sum(x.numel() * x.element_size()
               for _, x in tree_leaves_with_path(tree))


@pytest.mark.parametrize("layout", ["tp", "dp", "tp-er"])
@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
def test_param_specs_equal_the_reference_for_every_config(trees, layout,
                                                          multi):
    mesh = MESH_POD if multi else MESH
    axes = tuple(mesh.shape)
    data_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    tp = layout != "dp"
    for arch, (sds, fake) in trees.items():
        ref_leaves = _jax_leaves(sds)
        port_leaves = dict(tree_leaves_with_path(fake))
        assert set(ref_leaves) == set(port_leaves), arch
        for path, x in port_leaves.items():
            assert tuple(x.shape) == tuple(ref_leaves[path].shape), path
        # the fsdp axes the dry run picks (dryrun.py:122-124), and none
        nbytes = _param_bytes(fake)
        picked = (data_axes if tp else axes) \
            if (nbytes > 40e9 or not tp and nbytes > 8e9) else None
        for fsdp in {picked, None, data_axes}:
            kw = dict(fsdp_axes=fsdp, tensor_parallel=tp,
                      embed_replicated=layout.endswith("-er"))
            ref = _jax_spec_leaves(jax_param_specs(sds, mesh, **kw))
            port = param_specs(fake, mesh, **kw)
            for path in port_leaves:
                assert _spec_at(port, path) == tuple(ref[path]), \
                    (arch, layout, fsdp, path)


def test_zero1_moment_specs_equal_the_reference(trees):
    """The dry run's ZeRO-1 moments: the parameters' rules plus the data
    axes over leaves of 64K elements and more."""
    for mesh in (MESH, MESH_POD):
        zero1 = tuple(a for a in ("pod", "data") if a in mesh.shape)
        for arch, (sds, fake) in trees.items():
            ref = _jax_spec_leaves(jax_param_specs(
                sds, mesh, fsdp_axes=zero1, fsdp_min_size=1 << 16))
            port = param_specs(fake, mesh, fsdp_axes=zero1,
                               fsdp_min_size=1 << 16)
            for path, _ in tree_leaves_with_path(fake):
                assert _spec_at(port, path) == tuple(ref[path]), (arch, path)


def test_rules_table_is_the_reference_s():
    """``_RULES`` is copied from the reference, entry for entry."""
    from repro.sharding import partition as ref_partition
    from repro_torch.sharding import partition
    assert partition._RULES == ref_partition._RULES


# -- placements on a DeviceMesh -------------------------------------------------

def test_placements_follow_the_spec():
    with fake_world(512):
        mesh = make_production_mesh(multi_pod=True)
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert tuple(mesh.shape) == (2, 16, 16)
        assert placements_for((None, ("pod", "data"), "model"), mesh) == (
            Shard(1), Shard(1), Shard(2))
        assert placements_for(("model", None), mesh) == (
            Replicate(), Replicate(), Shard(0))
        assert placements_for((None, None), mesh) == (Replicate(),) * 3


def test_param_shardings_and_distribute_on_meta():
    """Full-width qwen2-1.5b placed on the 16×16 fake mesh as ``meta``
    DTensors: every leaf's placements are its spec's, its local shard the
    spec's split of its shape."""
    cfg = get_config("qwen2-1.5b").replace(num_layers=2)
    with FakeTensorMode():
        fake = build_model(cfg, "cpu").init(0)
    meta = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device="meta"), fake)
    with fake_world(256):
        mesh = make_production_mesh()
        assert tuple(mesh.shape) == (16, 16)
        sh = param_shardings(meta, mesh)
        specs = param_specs(meta, mesh)
        placed = distribute(meta, sh)
        for path, x in tree_leaves_with_path(placed):
            assert isinstance(x, DTensor) and x.is_meta, path
            spec = _spec_at(specs, path)
            assert _spec_at(sh, path) == Sharding(
                mesh, placements_for(spec, mesh))
            assert tuple(x.placements) == placements_for(spec, mesh)
            want = [n // (16 if a else 1) for n, a in zip(x.shape, spec)]
            assert list(x.to_local().shape) == want, path
        assert _spec_at(specs, "blocks/attn/wq/w") == (None, None, "model")
        assert _spec_at(specs, "embed/table") == ("model", None)


def test_host_mesh_clips_data_to_the_world():
    with fake_world(4):
        mesh = make_host_mesh(8, 2, "cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (2, 2)
        mesh = make_host_mesh(1, 4, "cpu")
        assert tuple(mesh.shape) == (1, 4)


def test_host_mesh_defaults_to_cuda():
    """Without ``device`` the mesh is on the card, which this machine may
    not have: then it raises rather than fall back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with fake_world(1):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_host_mesh(1, 1)


def test_only_fake_world_imports_the_private_fake_group():
    """``torch.testing._internal`` is imported in one place of the port:
    inside ``launch/mesh.py::fake_world``."""
    found = []
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        tree = ast.parse(path.read_text())
        for fn in [None] + [n for n in ast.walk(tree)
                            if isinstance(n, ast.FunctionDef)]:
            body = tree.body if fn is None else fn.body
            for node in body:
                for sub in ast.walk(node) if fn else [node]:
                    if isinstance(sub, ast.ImportFrom) and (
                            sub.module or "").startswith(
                                "torch.testing._internal"):
                        found.append((path.relative_to(ROOT).as_posix(),
                                      fn.name if fn else None))
    assert set(found) == {("src/repro_torch/launch/mesh.py", "fake_world")}
