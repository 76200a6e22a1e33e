"""The grouped-SwiGLU kernel's plain version against the JAX kernel (Pallas,
interpret mode) and its oracle, on the shapes of ``test_kernels.py``, and
the wrapper's device rules.  The CUDA kernel itself is held to the plain
version on the card (``test_torch_cuda.py``, ``chip_smoke.py``)."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gmm.ops import grouped_swiglu as jax_grouped_swiglu
from repro.kernels.moe_gmm.ref import grouped_swiglu_ref
from repro_torch.kernels.moe_gmm import build, grouped_swiglu, ops
from repro_torch.kernels.moe_gmm.ref import grouped_swiglu_plain

from _torch_parity import to_np

SHAPES = [(4, 64, 32, 64), (2, 100, 16, 48), (8, 16, 128, 256), (1, 8, 8, 8),
          # on the fp32 tiles' edges: C not a multiple of a row tile (just
          # over the decode tile's 8, over 32 and 128), D and F multiples of
          # 4 but not of the column tiles
          (3, 40, 20, 36), (2, 130, 12, 68), (5, 9, 36, 132)]
# fp32: the products' sums differ in order only; bf16: h and y are rounded
# to bf16 (one ulp of |y| ~ 1 is 7.8e-3) at points where the fp32 sums may
# fall on either side
TOL = {"float32": dict(atol=5e-5, rtol=1e-4),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}


def _inputs(e, c, d, f, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((e, c, d)).astype(np.float32),
            (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32),
            (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32),
            (rng.standard_normal((e, f, d)) / np.sqrt(f)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,c,d,f", SHAPES)
def test_plain_matches_jax_kernel_and_oracle(e, c, d, f, dtype):
    arrays = _inputs(e, c, d, f)
    jx = [jnp.asarray(a).astype(dtype) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    got = to_np(grouped_swiglu_plain(*tx))
    kernel = to_np(jax_grouped_swiglu(*jx, bc=32, bf=32, interpret=True))
    oracle = to_np(grouped_swiglu_ref(*jx))
    np.testing.assert_allclose(got, kernel, **TOL[dtype])
    np.testing.assert_allclose(got, oracle, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_skips_only_zero_rows(dtype):
    """Rows beyond each expert's load are zero (as dispatch leaves them):
    the output is the same with and without ``load``, and zero there."""
    e, c, d, f = 4, 24, 32, 48
    x, wg, wu, wd = (torch.from_numpy(a).to(getattr(torch, dtype))
                     for a in _inputs(e, c, d, f, seed=5))
    load = torch.tensor([0, 24, 7, 1], dtype=torch.int32)
    x[torch.arange(c)[None, :] >= load[:, None]] = 0
    with_load = grouped_swiglu(x, wg, wu, wd, load)
    assert torch.equal(with_load, grouped_swiglu(x, wg, wu, wd))
    assert torch.equal(with_load, grouped_swiglu_plain(x, wg, wu, wd))
    assert torch.all(with_load[0] == 0) and torch.all(with_load[3, 1:] == 0)
    assert torch.all(with_load[2, :7] != 0)


def test_device_rules():
    """CPU tensors take the plain version (no launch); other devices raise;
    malformed shapes raise before any device work."""
    x, wg, wu, wd = (torch.from_numpy(a) for a in _inputs(2, 8, 16, 16))
    before = (ops.grouped_swiglu.launches,
              ops.grouped_swiglu.kernel_launches)
    assert torch.equal(grouped_swiglu(x, wg, wu, wd),
                       grouped_swiglu_plain(x, wg, wu, wd))
    assert (ops.grouped_swiglu.launches,
            ops.grouped_swiglu.kernel_launches) == before
    meta = [t.to("meta") for t in (x, wg, wu, wd)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        grouped_swiglu(*meta)
    with pytest.raises(ValueError, match="mismatched"):
        grouped_swiglu(x, wg, wu, wd[:, :8])
    with pytest.raises(ValueError, match=r"x \[E,C,D\]"):
        grouped_swiglu(x[0], wg, wu, wd)


@pytest.mark.parametrize("dtype,d,f,ok", [
    (torch.bfloat16, 264, 520, True),    # multiples of 8, not of 16
    (torch.bfloat16, 6144, 16384, True),
    (torch.bfloat16, 260, 520, False),
    (torch.bfloat16, 264, 516, False),
    (torch.float32, 260, 516, True),     # fp32: multiples of 4
    (torch.float32, 262, 516, False),
])
def test_kernel_shape_rule(dtype, d, f, ok):
    """The kernels take D and F in whole 16-byte vectors (8 bf16 or 4 fp32
    elements): the tensor-core path masks the k edge inside a k-step, so
    D and F need not be multiples of 16.  Checked before any launch."""
    e, c = 2, 16
    args = [torch.empty(shape, dtype=dtype, device="meta") for shape in
            ((e, c, d), (e, d, f), (e, d, f), (e, f, d))]
    if ok:
        ops._check_cuda(*args, None)
    else:
        with pytest.raises(ValueError, match="multiples of"):
            ops._check_cuda(*args, None)


@pytest.mark.parametrize("e,c,d,f", [
    (8, 8, 6144, 16384), (8, 40, 6144, 16384), (8, 16, 6144, 16384),
    (16, 1024, 4096, 14336), (16, 8, 4096, 14336), (4, 64, 256, 512),
    (384, 8, 7168, 2048), (384, 512, 7168, 2048), (2, 100, 16, 48),
    (3, 40, 260, 516), (1, 1, 4, 4), (4, 300, 5636, 2820), (8, 65, 64, 64),
])
def test_gmm_plan_covers_and_fits(e, c, d, f):
    """Each phase's tile: its grid covers the C rows and the N columns, the
    k-groups split a k-step into whole float4, a CTA (its sliver path too)
    fits the H100's 227 KB of shared memory; the same shapes give the same
    plan (a pure function of the shapes: never of ``load``)."""
    plan = ops.gmm_plan(e, c, d, f)
    for name, n, glu in ((plan.glu, f, True), (plan.down, d, False)):
        tile = ops.FP32_TILES[name]
        bn = tile.bn_glu if glu else tile.bn_down
        rows, cols = -(-c // tile.bm), -(-n // bn)
        assert (rows - 1) * tile.bm < c <= rows * tile.bm
        assert (cols - 1) * bn < n <= cols * bn
        assert tile.bk % (4 * tile.ks) == 0
        assert ops.tile_smem(name, glu) <= ops.SMEM_LIMIT
    assert ops.gmm_plan(e, c, d, f) == plan
    if c <= ops.DECODE_ROWS:
        assert plan == ("decode", "decode")


def test_gmm_plan_at_the_fp32_rows():
    """The fp32 phases' shapes: Mixtral-8x22B's decode (C = 8) and verify
    (C = 40), Jamba's prefill (C = 1024), and the small row, whose prefill
    tiles would give 16 and 4 CTAs: the narrow tile's 128 and 32."""
    assert ops.gmm_plan(8, 8, 6144, 16384) == ("decode", "decode")
    assert ops.gmm_plan(8, 40, 6144, 16384) == ("prefill", "prefill")
    assert ops.gmm_plan(16, 1024, 4096, 14336) == ("prefill", "prefill")
    assert ops.gmm_plan(4, 64, 256, 512) == ("narrow", "narrow")
    with pytest.raises(ValueError):
        ops.gmm_plan(0, 8, 16, 16)


def _cu_tiles(source: str) -> dict:
    """``using Name = FmaTile<BM, BN, TM, TN, KS, BK, STAGES, MINB, GLU>``
    of the .cu file: name -> the ints (GLU dropped)."""
    return {m.group(1): tuple(int(v) for v in m.group(2).split(",")[:-1])
            for m in re.finditer(r"using (\w+) = FmaTile<([^>]*)>;", source)}


def test_fp32_tiles_match_the_source():
    """ops.FP32_TILES and SLIVERS mirror the kernel's tiles (rows, columns
    of each phase, k-groups, k-step, stages) and the codes the C interface
    takes (0-2 in the order of FP32_TILES), so the plan's checks hold for
    what runs."""
    source = build.LIBRARY.source.read_text()
    cu = _cu_tiles(source)
    names = {"decode": "Decode", "narrow": "Narrow", "prefill": "Prefill"}
    for name, tile in [*ops.FP32_TILES.items(),
                       *((f"sliver:{k}", t) for k, t in ops.SLIVERS.items())]:
        cname = "Sliver" if name.startswith("sliver:") else names[name]
        for suffix, bn in (("Glu", tile.bn_glu), ("Down", tile.bn_down)):
            bm, bn_cu, _, _, ks, bk, stages, _ = cu[cname + suffix]
            assert (bm, bn_cu, ks, bk, stages) == (
                tile.bm, bn, tile.ks, tile.bk, tile.stages), cname + suffix
    for code, cname in enumerate(names.values()):
        if cname != "Prefill":
            assert re.search(rf"case {code}: err = launch_fma_phase<"
                             rf"{cname}Glu>", source)
            assert re.search(rf"case {code}: return launch_fma_phase<"
                             rf"{cname}Down>", source)
    assert "launch_fma_phase<PrefillGlu, SliverGlu>" in source
    assert "launch_fma_phase<PrefillDown, SliverDown>" in source
    assert list(ops.FP32_TILES) == list(names)
