"""The WKV-6 kernel's plain version against the JAX kernel (Pallas, interpret
mode), its step-scan oracle and the chunked associative scan, on the shapes
of ``test_kernels.py``, and the wrapper's device rules.  The CUDA kernel
itself is held to the plain version on the card (``test_torch_cuda.py``,
``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6.ops import wkv6 as jax_wkv6
from repro.kernels.wkv6.ref import wkv6_ref
from repro.models.ssm import _wkv_chunk as jax_wkv_chunk
from repro_torch.kernels.wkv6 import ops, wkv6
from repro_torch.kernels.wkv6.ref import wkv6_plain
from repro_torch.models.ssm import _wkv_chunk

from _torch_parity import to_np

# fp32 throughout: the sums differ in order only (the kernel's N-long dots,
# the oracle's einsum, the associative scan's tree), ~1e-6 relative at the
# |y| ~ 10 these inputs reach
ATOL = 1e-3
SHAPES = [(2, 32, 2, 16, 8), (1, 64, 4, 32, 16), (2, 48, 3, 8, 16),
          (1, 16, 1, 64, 4)]


def _inputs(b, t, h, n, seed=4):
    """r, k, v ~ N(0, 1); w in (0.45, 0.95) as ``test_kernels.py`` draws
    it; u ~ N(0, 0.1); all fp32 numpy."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, t, h, n)).astype(np.float32)
               for _ in range(3))
    w = (0.45 + 0.5 / (1 + np.exp(-rng.standard_normal((b, t, h, n))))
         ).astype(np.float32)
    u = (0.1 * rng.standard_normal((h, n))).astype(np.float32)
    return r, k, v, w, u


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("b,t,h,n,chunk", SHAPES)
def test_plain_matches_jax_kernel_and_oracle(b, t, h, n, chunk):
    arrays = _inputs(b, t, h, n)
    y, s = wkv6_plain(*_torch(*arrays))
    jx = [jnp.asarray(a) for a in arrays]
    yk, sk = jax_wkv6(*jx, chunk=chunk, interpret=True)
    yr, sr = wkv6_ref(*jx)
    for want_y, want_s in ((yk, sk), (yr, sr)):
        np.testing.assert_allclose(to_np(y), to_np(want_y), atol=ATOL)
        np.testing.assert_allclose(to_np(s), to_np(want_s), atol=ATOL)


@pytest.mark.parametrize("t,half", [(32, 16), (77, 40)])
def test_initial_state_handoff(t, half):
    """[0, half) then [half, T) from its s_end equals the whole run, and
    the second half with s0 matches the JAX kernel given the same s0 (the
    ragged T = 77 drives the JAX wrapper's chunk down to 1)."""
    b, h, n = 2, 2, 16
    r, k, v, w, u = _torch(*_inputs(b, t, h, n, seed=9))
    y_full, s_full = wkv6_plain(r, k, v, w, u)
    cut = [a[:, :half] for a in (r, k, v, w)]
    rest = [a[:, half:] for a in (r, k, v, w)]
    y1, s1 = wkv6_plain(*cut, u)
    y2, s2 = wkv6_plain(*rest, u, s1)
    np.testing.assert_allclose(to_np(torch.cat([y1, y2], 1)), to_np(y_full),
                               atol=ATOL)
    np.testing.assert_allclose(to_np(s2), to_np(s_full), atol=ATOL)
    yk, sk = jax_wkv6(*(jnp.asarray(a.numpy()) for a in rest),
                      jnp.asarray(u.numpy()), jnp.asarray(s1.numpy()),
                      chunk=8, interpret=True)
    np.testing.assert_allclose(to_np(y2), to_np(yk), atol=ATOL)
    np.testing.assert_allclose(to_np(s2), to_np(sk), atol=ATOL)


def test_plain_matches_chunked_scan():
    """Plain version ≡ the port's associative-scan chunk ≡ the reference's,
    from a non-zero state."""
    b, t, h, n = 2, 32, 2, 16
    r, k, v, w, u = _inputs(b, t, h, n, seed=5)
    s0 = np.random.default_rng(6).standard_normal(
        (b, h, n, n)).astype(np.float32)
    y, s = wkv6_plain(*_torch(r, k, v, w, u, s0))
    y_c, s_c = _wkv_chunk(*_torch(r, k, v, w, u, s0))
    y_j, s_j = jax_wkv_chunk(*(jnp.asarray(a) for a in (r, k, v, w, u, s0)))
    for got_y, got_s in ((y_c, s_c), (y_j, s_j)):
        np.testing.assert_allclose(to_np(y), to_np(got_y), atol=ATOL)
        np.testing.assert_allclose(to_np(s), to_np(got_s), atol=ATOL)


def test_bf16_inputs_fp32_decay():
    """The bf16 model's combination: r, k, v bf16, w, u and s0 fp32.  Both
    sides compute in fp32 from the same bf16 values and round y to bf16,
    so y may differ by one bf16 ulp (2^-8 relative) where the fp32 sums
    fall on either side of a rounding point; s_end stays fp32."""
    b, t, h, n = 1, 64, 4, 64
    r, k, v, w, u = _inputs(b, t, h, n, seed=11)
    rb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (r, k, v))
    y, s = wkv6_plain(rb, kb, vb, *_torch(w, u))
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    jx = [jnp.asarray(a).astype(jnp.bfloat16) for a in (r, k, v)]
    yk, sk = jax_wkv6(*jx, jnp.asarray(w), jnp.asarray(u), chunk=16,
                      interpret=True)
    assert yk.dtype == jnp.bfloat16
    np.testing.assert_allclose(to_np(y), to_np(yk), rtol=2 ** -7, atol=1e-2)
    np.testing.assert_allclose(to_np(s), to_np(sk), atol=ATOL)


def test_device_rules():
    """CPU tensors take the plain version (no launch); other devices raise;
    malformed shapes raise before any device work."""
    r, k, v, w, u = _torch(*_inputs(1, 8, 2, 16))
    before = ops.wkv6.launches
    y, s = wkv6(r, k, v, w, u)
    want_y, want_s = wkv6_plain(r, k, v, w, u)
    assert torch.equal(y, want_y) and torch.equal(s, want_s)
    assert ops.wkv6.launches == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        wkv6(*(a.to("meta") for a in (r, k, v, w, u)))
    with pytest.raises(ValueError, match="one \\[B, T, H, N\\]"):
        wkv6(r, k, v[:, :4], w, u)
    with pytest.raises(ValueError, match="u must be"):
        wkv6(r, k, v, w, u[:, :8])
    with pytest.raises(ValueError, match="u must be"):
        wkv6(r, k, v, w, u, torch.zeros(1, 2, 16, 8))
