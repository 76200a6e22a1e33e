"""The prefix-scan kernel's plain version against the JAX kernel (Pallas,
interpret mode) on the shapes and types of ``test_kernels.py``, the int32
property test, and the wrapper's device rules.  The CUDA kernel itself is
held to the plain version on the card (``test_torch_cuda.py``,
``chip_smoke.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                     # optional dep: deterministic fallback
    from _hypothesis_fallback import given, settings, st

from repro.kernels.prefix_scan.ops import prefix_scan as jax_prefix_scan
from repro_torch.kernels.prefix_scan import ops, prefix_scan
from repro_torch.kernels.prefix_scan.ref import prefix_scan_plain

# int32 is exact; fp32 sums differ in order only (1e-3 at |sums| of a few
# hundred); bf16 outputs are rounded to bf16, whose ulp at |sums| in
# [64, 128) is 0.5
TOL = {"int32": 0, "float32": 1e-3, "bfloat16": 0.5}


def _x(shape, dtype, seed=0):
    """x ~ 8 N(0, 1) cast to dtype (int32 truncates), as numpy fp32 and in
    both frameworks."""
    a = (8 * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)
    if dtype == "int32":
        a = a.astype(np.int32)
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    return t, jnp.asarray(a).astype(dtype)


@pytest.mark.parametrize("dtype", ["int32", "float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 64), (4, 1000), (2, 3, 130), (8, 8)])
def test_plain_matches_jax_kernel(shape, dtype):
    t, j = _x(shape, dtype)
    got = prefix_scan_plain(t)
    assert got.dtype == t.dtype and got.shape == t.shape
    want = jax_prefix_scan(j, block=64, interpret=True)
    np.testing.assert_allclose(got.double().numpy(),
                               np.asarray(want, np.float64), atol=TOL[dtype],
                               rtol=0)


@given(st.integers(1, 5), st.integers(1, 700), st.integers(8, 128),
       st.integers(0, 99))
@settings(max_examples=20, deadline=None)
def test_int32_property(rows, n, block, seed):
    """Integers in [-50, 50): the plain version equals jnp.cumsum and the
    JAX kernel exactly, for any block size of the JAX kernel."""
    block = 1 << int(np.log2(block))
    x = jax.random.randint(jax.random.PRNGKey(seed), (rows, n), -50, 50)
    got = prefix_scan_plain(torch.from_numpy(np.array(x, np.int32)))
    assert got.dtype == torch.int32
    want = jnp.cumsum(x, axis=-1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    kernel = jax_prefix_scan(x.astype(jnp.int32), block=block,
                             interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(kernel))


def test_int32_overflow_wraps():
    """Sums beyond 2^31 wrap to 32 bits, as jnp.cumsum's do."""
    x = np.full((2, 300), 2 ** 30 + 12345, np.int32)
    x[1] *= -1
    got = prefix_scan_plain(torch.from_numpy(x))
    want = jnp.cumsum(jnp.asarray(x), axis=-1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    kernel = jax_prefix_scan(jnp.asarray(x), block=64, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(kernel))


def test_device_rules():
    """CPU tensors take the plain version (no launch); other devices and a
    rank-0 tensor raise."""
    x, _ = _x((3, 50), "float32")
    before = ops.prefix_scan.launches
    assert torch.equal(prefix_scan(x), prefix_scan_plain(x))
    assert ops.prefix_scan.launches == before
    assert torch.equal(prefix_scan(x[0]), prefix_scan_plain(x[0]))
    with pytest.raises(ValueError, match="cuda or cpu"):
        prefix_scan(x.to("meta"))
    with pytest.raises(ValueError, match="rank"):
        prefix_scan(torch.tensor(1.0))
