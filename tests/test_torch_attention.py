"""The port's attention paths against ``repro.models.attention`` on bridged
weights (fp32), and the port's own paged == contiguous decode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ja
from repro_torch.models import attention as ta
from repro_torch.models.transformer import _layer

from _torch_parity import models, to_np

ATOL = 1e-5


@pytest.fixture(scope="module")
def bridged():
    jmodel, jparams, tmodel, tparams = models(seed=3)
    jp = {k: {kk: vv[0] for kk, vv in v.items()}
          for k, v in jparams["blocks"]["attn"].items()}
    return jmodel.cfg, jp, tmodel.cfg, _layer(tparams["blocks"]["attn"], 0)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("flash", [False, True])
def test_attention_fwd(bridged, flash):
    jcfg, jp, tcfg, tp = bridged
    x = _x(2, 12, jcfg.d_model)
    jy, (jk, jv) = ja.attention_fwd(jp, jnp.asarray(x), jcfg,
                                    use_flash=flash, return_kv=True)
    ty, (tk, tv) = ta.attention_fwd(tp, torch.from_numpy(x), tcfg,
                                    use_flash=flash, return_kv=True)
    for got, want in ((ty, jy), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(to_np(got), to_np(want), atol=ATOL)


@pytest.mark.parametrize("flash", [False, True])
def test_attention_decode(bridged, flash):
    jcfg, jp, tcfg, tp = bridged
    jcfg, tcfg = jcfg.replace(use_flash=flash), tcfg.replace(use_flash=flash)
    b, s_max, hkv, hd = 3, 16, tcfg.num_kv_heads, tcfg.resolved_head_dim
    k, v = _x(b, s_max, hkv, hd, seed=1), _x(b, s_max, hkv, hd, seed=2)
    x = _x(b, 1, tcfg.d_model, seed=3)
    pos = np.array([3, 0, 15])
    jy, jc = ja.attention_decode(jp, jnp.asarray(x),
                                 ja.KVCache(jnp.asarray(k), jnp.asarray(v)),
                                 jnp.asarray(pos), jcfg)
    ty, tc = ta.attention_decode(
        tp, torch.from_numpy(x),
        ta.KVCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy())),
        torch.from_numpy(pos), tcfg)
    np.testing.assert_allclose(to_np(ty), to_np(jy), atol=ATOL)
    np.testing.assert_allclose(to_np(tc.k), to_np(jc.k), atol=ATOL)
    np.testing.assert_allclose(to_np(tc.v), to_np(jc.v), atol=ATOL)


def _pool(cfg, num_blocks=12, bs=4, seed=4):
    shape = (num_blocks, bs, cfg.num_kv_heads, cfg.resolved_head_dim)
    return _x(*shape, seed=seed), _x(*shape, seed=seed + 1)


@pytest.mark.parametrize("flash", [False, True])
def test_attention_decode_paged(bridged, flash):
    jcfg, jp, tcfg, tp = bridged
    jcfg, tcfg = jcfg.replace(use_flash=flash), tcfg.replace(use_flash=flash)
    k, v = _pool(tcfg)
    table = np.array([[3, 5, 0, 0], [7, 1, 2, 9], [0, 0, 0, 0]], np.int32)
    pos = np.array([5, 14, 0])
    x = _x(3, 1, tcfg.d_model, seed=6)
    jy, jc = ja.attention_decode_paged(
        jp, jnp.asarray(x), ja.PagedKVCache(jnp.asarray(k), jnp.asarray(v)),
        jnp.asarray(table), jnp.asarray(pos), jcfg)
    ty, tc = ta.attention_decode_paged(
        tp, torch.from_numpy(x),
        ta.PagedKVCache(torch.from_numpy(k.copy()),
                        torch.from_numpy(v.copy())),
        torch.from_numpy(table), torch.from_numpy(pos), tcfg)
    np.testing.assert_allclose(to_np(ty), to_np(jy), atol=ATOL)
    # the sink (block 0) takes the empty slot's write: garbage by design
    np.testing.assert_allclose(to_np(tc.k)[1:], to_np(jc.k)[1:], atol=ATOL)
    np.testing.assert_allclose(to_np(tc.v)[1:], to_np(jc.v)[1:], atol=ATOL)


@pytest.mark.parametrize("flash", [False, True])
def test_paged_decode_equals_contiguous(bridged, flash):
    """The gathered logical view has the contiguous cache's width, mask and
    values: the port's two decode paths give identical outputs."""
    _, _, tcfg, tp = bridged
    tcfg = tcfg.replace(use_flash=flash)
    k, v = (torch.from_numpy(a) for a in _pool(tcfg, seed=9))
    table = torch.tensor([[3, 5, 6, 8], [7, 1, 2, 9]], dtype=torch.int32)
    pos = torch.tensor([5, 14])
    x = torch.from_numpy(_x(2, 1, tcfg.d_model, seed=10))
    cap = table.shape[1] * k.shape[1]
    dense = ta.KVCache(k[table.long()].reshape(2, cap, *k.shape[2:]),
                       v[table.long()].reshape(2, cap, *v.shape[2:]))
    y_dense, dense = ta.attention_decode(tp, x, dense, pos, tcfg)
    y_paged, pool = ta.attention_decode_paged(
        tp, x, ta.PagedKVCache(k.clone(), v.clone()), table, pos, tcfg)
    assert torch.equal(y_dense, y_paged)
    assert torch.equal(pool.k[table.long()].reshape(dense.k.shape), dense.k)


@pytest.mark.parametrize("start", [0, 6])
def test_attention_prefill_chunk_paged(bridged, start):
    jcfg, jp, tcfg, tp = bridged
    k, v = _pool(tcfg, seed=11)
    row = np.array([4, 2, 7, 0], np.int32)
    x = _x(1, 5, tcfg.d_model, seed=12)
    jy, jc = ja.attention_prefill_chunk_paged(
        jp, jnp.asarray(x), ja.PagedKVCache(jnp.asarray(k), jnp.asarray(v)),
        jnp.asarray(row), jnp.int32(start), jcfg)
    ty, tc = ta.attention_prefill_chunk_paged(
        tp, torch.from_numpy(x),
        ta.PagedKVCache(torch.from_numpy(k.copy()),
                        torch.from_numpy(v.copy())),
        torch.from_numpy(row), start, tcfg)
    np.testing.assert_allclose(to_np(ty), to_np(jy), atol=ATOL)
    np.testing.assert_allclose(to_np(tc.k), to_np(jc.k), atol=ATOL)
    np.testing.assert_allclose(to_np(tc.v), to_np(jc.v), atol=ATOL)


@pytest.fixture(scope="module")
def one_head():
    """One query head and one kv head of 16 (fp32): long sequences stay
    small enough for the CPU."""
    jmodel, jparams, tmodel, tparams = models(seed=5, num_heads=1,
                                              num_kv_heads=1, head_dim=16)
    jp = {k: {kk: vv[0] for kk, vv in v.items()}
          for k, v in jparams["blocks"]["attn"].items()}
    return jmodel.cfg, jp, tmodel.cfg, _layer(tparams["blocks"]["attn"], 0)


@pytest.mark.parametrize("s,t,chunked", [
    (8192, None, True),    # S % 1024 == 0: the chunked online-softmax route
    (8200, None, False),   # S >= 8192 but ragged: plain _sdpa with the mask
    (1024, 8192, True),    # cross-attention over 8192 keys: not causal
])
def test_attention_fwd_long(one_head, monkeypatch, s, t, chunked):
    """Flash off at S or T >= 8192 routes as the reference's
    ``attention_fwd`` does; both compute in fp32 (the chunked route's sums
    differ in order only), within ATOL."""
    jcfg, jp, tcfg, tp = one_head
    calls = []
    real = ta._sdpa_chunked
    monkeypatch.setattr(ta, "_sdpa_chunked",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    x = _x(1, s, jcfg.d_model, seed=7)
    kv = None if t is None else tuple(
        _x(1, t, 1, tcfg.resolved_head_dim, seed=8 + i) for i in range(2))
    jy = to_np(ja.attention_fwd(
        jp, jnp.asarray(x), jcfg,
        kv=None if kv is None else tuple(map(jnp.asarray, kv))))
    ty = ta.attention_fwd(
        tp, torch.from_numpy(x), tcfg,
        kv=None if kv is None else tuple(map(torch.from_numpy, kv)))
    assert len(calls) == chunked
    np.testing.assert_allclose(to_np(ty), jy, atol=ATOL)
