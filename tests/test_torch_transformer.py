"""The port's trunk against ``repro.models.transformer`` on bridged weights
(fp32), dense (qwen2-1.5b) and MoE (mixtral-8x22b, window 64, prompts past
the window): prefill logits and cache, then eight decode steps over the
contiguous and the paged cache (logits atol 1e-4, greedy tokens identical),
and chunked prefill into the pool."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import models, to_np

S_MAX = 32
BS = 8
MOE = "mixtral-8x22b"
MOE_S_MAX = 96      # past the scaled window (64): the contiguous ring wraps


def _jit(fn, *static):
    """The reference as its engine runs it: jitted."""
    return jax.jit(fn, static_argnums=static)


def _prompt(vocab, n=11, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (1, n))


def _prefill_then_decode(arch, flash, n, s_max):
    jmodel, jp, tmodel, tp = models(seed=1, arch=arch, use_flash=flash)
    toks = _prompt(jmodel.cfg.vocab_size, n)
    jlog, jc = _jit(jmodel.prefill, 2)(jp, {"tokens": jnp.asarray(toks)},
                                       s_max)
    tlog, tc = tmodel.prefill(tp, {"tokens": torch.from_numpy(toks)}, s_max)
    np.testing.assert_allclose(to_np(tlog), to_np(jlog), atol=1e-4)
    np.testing.assert_allclose(to_np(tc.k), to_np(jc.k), atol=1e-5)
    np.testing.assert_allclose(to_np(tc.v), to_np(jc.v), atol=1e-5)
    jtok = int(jnp.argmax(jlog[0, -1]))
    assert int(torch.argmax(tlog[0, -1])) == jtok
    ttok, pos = jtok, toks.shape[1]
    for _ in range(8):
        jlog, jc = _jit(jmodel.decode_step)(
            jp, jnp.asarray([[jtok]], jnp.int32), jc, jnp.int32(pos))
        tlog, tc = tmodel.decode_step(tp, torch.tensor([[ttok]]), tc, pos)
        np.testing.assert_allclose(to_np(tlog), to_np(jlog), atol=1e-4)
        jtok = int(jnp.argmax(jlog[0, -1]))
        ttok = int(torch.argmax(tlog[0, -1]))
        assert ttok == jtok
        pos += 1


@pytest.mark.parametrize("flash", [False, True])
def test_prefill_then_decode(flash):
    _prefill_then_decode("qwen2-1.5b", flash, 11, S_MAX)


@pytest.mark.parametrize("flash", [False, True])
def test_moe_prefill_then_decode(flash):
    _prefill_then_decode(MOE, flash, 70, MOE_S_MAX)


def _paged_prefill_insert_then_decode(arch, flash, lens, s_max):
    """Whole-prompt prefill scattered into the pool, then paged decode at
    two depths in one batch."""
    jmodel, jp, tmodel, tp = models(seed=2, arch=arch, use_flash=flash)
    vocab = jmodel.cfg.vocab_size
    window = jmodel.cfg.sliding_window
    per = (s_max if window is None else min(s_max, window)) // BS
    nb = 2 * per + 1
    jpool = jmodel.init_paged_cache(2, nb, BS)
    tpool = tmodel.init_paged_cache(2, nb, BS)
    table = np.arange(1, nb, dtype=np.int32).reshape(2, per)
    prompts = [_prompt(vocab, lens[0], seed=3),
               _prompt(vocab, lens[1], seed=4)]
    jtoks, ttoks = [], []
    for i, toks in enumerate(prompts):
        jlog, jd = _jit(jmodel.prefill, 2)(jp, {"tokens": jnp.asarray(toks)},
                                        s_max)
        tlog, td = tmodel.prefill(tp, {"tokens": torch.from_numpy(toks)},
                                  s_max)
        jpool = _jit(jmodel.insert_prefill_paged)(jpool, jd,
                                                  jnp.asarray(table[i]), i)
        tpool = tmodel.insert_prefill_paged(tpool, td,
                                            torch.from_numpy(table[i]), i)
        jtoks.append(int(jnp.argmax(jlog[0, -1])))
        ttoks.append(int(torch.argmax(tlog[0, -1])))
    assert ttoks == jtoks
    np.testing.assert_allclose(to_np(tpool.k)[:, 1:], to_np(jpool.k)[:, 1:],
                               atol=1e-5)
    pos = np.array([p.shape[1] for p in prompts])
    for _ in range(8):
        jlog, jpool = _jit(jmodel.decode_step_paged)(
            jp, jnp.asarray(np.array(jtoks)[:, None], jnp.int32), jpool,
            jnp.asarray(table), jnp.asarray(pos, jnp.int32))
        tlog, tpool = tmodel.decode_step_paged(
            tp, torch.tensor(ttoks)[:, None], tpool, torch.from_numpy(table),
            torch.from_numpy(pos))
        np.testing.assert_allclose(to_np(tlog), to_np(jlog), atol=1e-4)
        jtoks = [int(t) for t in jnp.argmax(jlog[:, -1], axis=-1)]
        ttoks = torch.argmax(tlog[:, -1], dim=-1).tolist()
        assert ttoks == jtoks
        pos += 1


@pytest.mark.parametrize("flash", [False, True])
def test_paged_prefill_insert_then_decode(flash):
    _paged_prefill_insert_then_decode("qwen2-1.5b", flash, (11, 5), S_MAX)


@pytest.mark.parametrize("flash", [False, True])
def test_moe_paged_prefill_insert_then_decode(flash):
    _paged_prefill_insert_then_decode(MOE, flash, (70, 5), MOE_S_MAX)


def _prefill_chunk_paged(arch, n, bounds, s_max):
    jmodel, jp, tmodel, tp = models(seed=5, arch=arch)
    toks = _prompt(jmodel.cfg.vocab_size, n, seed=6)
    nb = s_max // BS + 1
    jpool = jmodel.init_paged_cache(1, nb, BS)
    tpool = tmodel.init_paged_cache(1, nb, BS)
    row = np.random.default_rng(0).permutation(np.arange(1, nb)).astype(
        np.int32)
    for start, end in bounds:
        chunk = toks[:, start:end]
        jlog, jpool = _jit(jmodel.prefill_chunk_paged)(
            jp, {"tokens": jnp.asarray(chunk)}, jpool, jnp.asarray(row),
            jnp.int32(start))
        tlog, tpool = tmodel.prefill_chunk_paged(
            tp, {"tokens": torch.from_numpy(chunk)}, tpool,
            torch.from_numpy(row), start)
        np.testing.assert_allclose(to_np(tlog), to_np(jlog), atol=1e-4)
    np.testing.assert_allclose(to_np(tpool.k), to_np(jpool.k), atol=1e-5)
    np.testing.assert_allclose(to_np(tpool.v), to_np(jpool.v), atol=1e-5)


def test_prefill_chunk_paged():
    _prefill_chunk_paged("qwen2-1.5b", 13, ((0, 8), (8, 13)), S_MAX)


def test_moe_prefill_chunk_paged():
    _prefill_chunk_paged(MOE, 80, ((0, 32), (32, 70), (70, 80)), MOE_S_MAX)
