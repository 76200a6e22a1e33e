"""The port's flash attention against the JAX reference: the plain version
(what a CPU tensor runs) against the Pallas kernel in interpret mode and
against the softmax oracle, and the wrapper's device rules."""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import mha_ref as jax_mha_ref
from repro_torch.kernels.flash_attention import build, ops
from repro_torch.kernels.flash_attention.ref import (flash_attention_plain,
                                                     mha_ref)

CASES = [
    (2, 64, 64, 4, 2, 32, True, None),
    (1, 128, 128, 4, 4, 64, True, 48),
    (2, 96, 96, 8, 2, 32, True, None),
    (1, 32, 96, 4, 1, 32, False, None),
    (1, 64, 64, 2, 2, 128, True, None),
    (1, 32, 96, 4, 2, 32, True, None),
    (2, 64, 128, 4, 1, 32, True, 48),
    (2, 40, 100, 4, 2, 32, True, None),
    (1, 100, 100, 4, 4, 32, False, None),
    (1, 24, 72, 2, 2, 32, True, 16),
    # on the fp32 route's tile edges (64 query rows, kv tiles of 64 in two
    # halves of 32): S just over a tile, T not a multiple of 32, a window
    (1, 65, 97, 4, 2, 128, True, None),
    (2, 130, 161, 4, 1, 64, True, 40),
    (1, 33, 33, 2, 2, 32, False, None),
]


def _inputs(b, s, t, h, hkv, d, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, t, hkv, d)).astype(np.float32),
            rng.standard_normal((b, t, hkv, d)).astype(np.float32))


def _both(q, k, v, kv_valid=None, **kw):
    want = np.asarray(jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if kv_valid is None else jnp.asarray(kv_valid, jnp.int32),
        bq=32, bk=32, interpret=True, **kw))
    got = ops.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if kv_valid is None else torch.tensor(kv_valid,
                                                   dtype=torch.int32), **kw)
    return got.numpy(), want


@pytest.mark.parametrize("b,s,t,h,hkv,d,causal,window", CASES)
def test_plain_matches_jax_flash_and_oracle(b, s, t, h, hkv, d, causal,
                                            window):
    q, k, v = _inputs(b, s, t, h, hkv, d)
    got, want = _both(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got, want, atol=2e-5)
    t_ = lambda x: torch.from_numpy(x).permute(0, 2, 1, 3)  # noqa: E731
    oracle = mha_ref(t_(q), t_(k), t_(v), causal=causal, window=window)
    jax_oracle = jax_mha_ref(*(jnp.moveaxis(jnp.asarray(x), 2, 1)
                               for x in (q, k, v)),
                             causal=causal, window=window)
    np.testing.assert_allclose(oracle.numpy(), np.asarray(jax_oracle),
                               atol=2e-5)
    np.testing.assert_allclose(got, oracle.permute(0, 2, 1, 3).numpy(),
                               atol=2e-5)


@pytest.mark.parametrize("window", [None, 24])
def test_plain_bottom_right_q_offset(window):
    """Chunked-prefill alignment: the last s rows of a t-long sequence."""
    s, t = 24, 72
    q, k, v = _inputs(2, s, t, 4, 2, 32, seed=3)
    got, want = _both(q, k, v, causal=True, window=window, q_offset=t - s)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_plain_kv_valid_decode():
    q, k, v = _inputs(4, 1, 80, 4, 2, 32, seed=4)
    kv_valid = [1, 80, 17, 33]
    got, want = _both(q, k, v, kv_valid, causal=False)
    np.testing.assert_allclose(got, want, atol=2e-5)
    oracle = mha_ref(*(torch.from_numpy(x).permute(0, 2, 1, 3)
                       for x in (q, k, v)), causal=False,
                     kv_valid=torch.tensor(kv_valid, dtype=torch.int32))
    np.testing.assert_allclose(got, oracle.permute(0, 2, 1, 3).numpy(),
                               atol=2e-5)


def test_plain_fully_masked_row_is_zero():
    q, k, v = _inputs(2, 1, 40, 4, 2, 32, seed=5)
    got, want = _both(q, k, v, [0, 40], causal=False)
    assert np.all(got[0] == 0.0) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_wrapper_counts_no_launch_on_cpu():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 8, 8, 2, 2, 32))
    before = (ops.flash_attention.launches,
              ops.flash_attention.kernel_launches)
    out = ops.flash_attention(q, k, v)
    assert (ops.flash_attention.launches,
            ops.flash_attention.kernel_launches) == before
    torch.testing.assert_close(out, flash_attention_plain(q, k, v),
                               rtol=0, atol=0)


def test_wrapper_never_falls_back_off_cpu(monkeypatch):
    """A tensor that is not on the CPU never reaches the plain version."""
    class FellBack(Exception):
        pass

    def boom(*a, **kw):
        raise FellBack("plain version called for a non-CPU tensor")
    monkeypatch.setattr(ops, "flash_attention_plain", boom)
    q = torch.empty(1, 4, 2, 32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.flash_attention(q, q, q)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError),
                           match="CUDA|NVIDIA|cuda"):
            ops.flash_attention(q.to("cuda"), q.to("cuda"), q.to("cuda"))


@pytest.mark.parametrize("dtype,s,route", [
    (torch.bfloat16, 1, "split"), (torch.bfloat16, 4, "split"),
    (torch.bfloat16, 5, "mma"), (torch.bfloat16, 77, "mma"),
    (torch.bfloat16, 1024, "mma"), (torch.float32, 1, "split"),
    (torch.float32, 4, "split"), (torch.float32, 5, "fma"),
    (torch.float32, 1024, "fma"),
])
def test_kernel_route(dtype, s, route):
    """Decode (S <= 4) takes the split-KV kernel in either dtype; bf16
    prefill the tensor-core kernel; fp32 prefill (TF32 stays off) the
    CUDA-core one."""
    assert ops.kernel_route(dtype, s) == route


def test_c_signature_passes_the_route():
    """The route goes to C as an int before the pointers, the decode plan
    (splits, chunk) as ints before the scale; every pointer (the scratch
    too) and the stream are c_void_p (a c_int would cut them to 32 bits)."""
    argtypes, restype = build.LIBRARY.signatures["flash_attention_fwd"]
    assert restype is ctypes.c_int and len(argtypes) == 21
    assert argtypes[:3] == [ctypes.c_int] * 3          # dtype, head dim, route
    assert argtypes[3:9] == [ctypes.c_void_p] * 6  # q k v kv_valid o scratch
    assert argtypes[9:19] == [ctypes.c_int] * 10
    assert argtypes[19:] == [ctypes.c_float, ctypes.c_void_p]
    assert set(ops._ROUTE_CODE) == {"fma", "mma", "split"}


@pytest.mark.parametrize("b,hkv,t", [
    (8, 2, 2048), (8, 8, 1024), (8, 2, 1000), (1, 1, 50), (1, 1, 1),
    (1, 1, 32768), (3, 5, 4097), (64, 8, 64), (300, 1, 129),
])
def test_decode_plan_covers_the_kv_axis(b, hkv, t):
    """The splits cover [0, T) exactly, each chunk whole tiles, the last
    non-empty; at least one split, and no more than the CTA target asks;
    where T allows, at least one CTA an SM (half the target)."""
    plan = ops.decode_plan(b, hkv, t)
    want = -(-ops.TARGET_CTAS // (b * hkv))
    assert 1 <= plan.splits <= want and plan.chunk % ops.KV_TILE == 0
    assert (plan.splits - 1) * plan.chunk < t <= plan.splits * plan.chunk
    if t >= ops.KV_TILE * want:
        assert plan.splits * b * hkv >= ops.TARGET_CTAS // 2


def test_decode_plan_at_the_main_paths():
    """qwen2-1.5b (B = 8, 2 kv heads, T = 2048) and Mixtral-8x22B (B = 8,
    8 kv heads, the 1024-slot paged view) get 256 CTAs each."""
    assert ops.decode_plan(8, 2, 2048) == (16, 128)
    assert ops.decode_plan(8, 8, 1024) == (4, 256)


def test_decode_plan_rejects_empty_shapes():
    with pytest.raises(ValueError):
        ops.decode_plan(0, 2, 2048)
