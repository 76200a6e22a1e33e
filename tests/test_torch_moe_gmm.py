"""The grouped-SwiGLU kernel's plain version against the JAX kernel (Pallas,
interpret mode) and its oracle, on the shapes of ``test_kernels.py``, and
the wrapper's device rules.  The CUDA kernel itself is held to the plain
version on the card (``test_torch_cuda.py``, ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gmm.ops import grouped_swiglu as jax_grouped_swiglu
from repro.kernels.moe_gmm.ref import grouped_swiglu_ref
from repro_torch.kernels.moe_gmm import grouped_swiglu, ops
from repro_torch.kernels.moe_gmm.ref import grouped_swiglu_plain

from _torch_parity import to_np

SHAPES = [(4, 64, 32, 64), (2, 100, 16, 48), (8, 16, 128, 256), (1, 8, 8, 8)]
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
