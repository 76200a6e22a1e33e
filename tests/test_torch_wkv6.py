"""The WKV-6 kernel's plain version against the JAX kernel (Pallas, interpret
mode), its step-scan oracle and the chunked associative scan, on the shapes
of ``test_kernels.py``; the CUDA kernel's chunked algorithm
(``wkv6_chunked_plain``) against the same, at ragged lengths, from a
non-zero state and under extreme decays; and the wrapper's device rules.
The CUDA kernel itself is held to the plain version on the card
(``test_torch_cuda.py``, ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6.ops import wkv6 as jax_wkv6
from repro.kernels.wkv6.ref import wkv6_ref
from repro.models.ssm import _wkv_chunk as jax_wkv_chunk
from repro_torch.kernels.wkv6 import ops, wkv6
from repro_torch.kernels.wkv6.ref import wkv6_chunked_plain, wkv6_plain
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


# (B, T, H, N, non-zero s0): one step, a chunk less one, one chunk, a chunk
# and one, the ragged 77, and four chunks, the last ragged
CHUNKED = [(b, t, h, n, False) for b, t, h, n, _ in SHAPES] + [
    (2, 1, 2, 16, True), (1, 63, 2, 32, True), (1, 64, 2, 64, False),
    (2, 65, 3, 16, True), (1, 77, 2, 64, True), (1, 200, 2, 64, True)]


@pytest.mark.parametrize("b,t,h,n,with_s0", CHUNKED)
def test_chunked_plain_matches_jax(b, t, h, n, with_s0):
    """The kernel's chunked algorithm (fp32) against the JAX kernel in
    interpret mode, and, from a zero state, its step-scan oracle; within
    ATOL (sums in other orders, the exps of summed log decays)."""
    arrays = _inputs(b, t, h, n, seed=t + n)
    s0 = (np.random.default_rng(t).standard_normal((b, h, n, n))
          .astype(np.float32) if with_s0 else None)
    y, s = wkv6_chunked_plain(*_torch(*arrays),
                              None if s0 is None else torch.from_numpy(s0))
    jx = [jnp.asarray(a) for a in arrays]
    want = [jax_wkv6(*jx, None if s0 is None else jnp.asarray(s0),
                     interpret=True)]
    if s0 is None:
        want.append(wkv6_ref(*jx))
    for want_y, want_s in want:
        np.testing.assert_allclose(to_np(y), to_np(want_y), atol=ATOL)
        np.testing.assert_allclose(to_np(s), to_np(want_s), atol=ATOL)


def _wkv_fp64(r, k, v, w, u, s0):
    """The recurrence step by step in fp64 numpy: (y, s_end)."""
    r, k, v, w, u, s = (a.astype(np.float64) for a in (r, k, v, w, u, s0))
    y = np.empty_like(r)
    for i in range(r.shape[1]):
        ri, ki, vi, wi = r[:, i], k[:, i], v[:, i], w[:, i]
        y[:, i] = (np.einsum("bhk,bhkv->bhv", ri, s)
                   + (ri * u * ki).sum(-1, keepdims=True) * vi)
        s = wi[..., None] * s + ki[..., None] * vi[..., None, :]
    return y, s


def test_chunked_plain_extreme_decay():
    """Decays w = exp(-exp(x)), x up to 5 (fp32 w underflows to 0, and is
    denormal just before), whole steps at exactly 0 and exactly 1 (one
    inside the 4th chunk's 2nd sub-block, one across two chunks), and
    channels held at 1 throughout: finite, and within 1e-4 of the largest
    |y| and |s_end| of the fp64 recurrence on the same fp32 inputs (the
    LOG_FLOOR of e^-30 stands in for the decays below it)."""
    b, t, h, n = 1, 200, 2, 64
    rng = np.random.default_rng(12)
    r, k, v = (rng.standard_normal((b, t, h, n)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.uniform(-6, 5, (b, t, h, n)))).astype(np.float32)
    w[:, 5:9] = 0
    w[:, 60:80] = 1
    w[:, 130] = 0
    w[..., :4] = 1
    assert (w == 0).any() and ((w > 0) & (w < 1.2e-38)).any()
    u = (0.1 * rng.standard_normal((h, n))).astype(np.float32)
    s0 = rng.standard_normal((b, h, n, n)).astype(np.float32)
    y, s = wkv6_chunked_plain(*_torch(r, k, v, w, u, s0))
    want_y, want_s = _wkv_fp64(r, k, v, w, u, s0)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    assert np.abs(to_np(y) - want_y).max() <= 1e-4 * np.abs(want_y).max()
    assert np.abs(to_np(s) - want_s).max() <= 1e-4 * np.abs(want_s).max()


def test_phase_profiler_marks_every_phase():
    """``launch/profile_wkv6.py`` instruments a copy of the kernel at its
    phase comments: each phase is marked once, the last mark and the timer
    reads close the kernel's body, and the read-out function is exported."""
    from repro_torch.launch.profile_wkv6 import PHASES, instrumented_source
    src = instrumented_source()
    for i in range(len(PHASES) + 1):
        assert src.count(f"WKV6_MARK({i});") == 1, i
    assert src.count("WKV6_TIME(14);") == 1
    assert src.count("WKV6_TIME(15);") == 1
    assert src.index(f"WKV6_MARK({len(PHASES)});") \
        < src.index("cudaError_t launch(")
    assert "int wkv6_prof_read(" in src
    assert src.count("= ticket;") == 1


@pytest.mark.parametrize("b,t,h,n,chunks", [
    (1, 1, 40, 64, 1), (1, 64, 40, 64, 1), (1, 65, 40, 64, 2),
    (1, 1024, 40, 64, 16), (2, 77, 3, 16, 2)])
def test_wkv6_plan(b, t, h, n, chunks):
    """A CTA a (b, h, chunk of 64 steps); one chunk needs no chain, more
    need two tagged states a head and the chunk counter, all zeroed."""
    plan = ops.wkv6_plan(b, t, h, n)
    assert plan.chunks == chunks and plan.ctas == b * h * chunks
    assert plan.chain_words == (2 * b * h * n * n + 1 if chunks > 1 else 0)
