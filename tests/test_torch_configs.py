"""The remaining decoder configs in the port against the JAX package on
bridged weights (fp32, scaled down): qwen3-8b (``qk_norm``) in every mode,
flash on and off; deepseek-coder-33b and mistral-large-123b with their GQA
groups (7 and 12 query heads a kv head, which ``scale_down`` alone would
flatten to 1); Kimi-K2 with top-8 of 16 experts (``scale_down`` caps k at
2); the MoE combine bit for bit; and the launcher's gates.

The trunk, verify and engine cases run the dense parity tests' own
helpers (``test_torch_transformer``, ``test_torch_speculative``,
``test_torch_engine``) on these configs, with their tolerances: logits
1e-4 and caches 1e-5 absolute, verify logits 1e-5; greedy tokens
identical; the combine exact."""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.device import moe_balance as jmb
from repro.models.attention import PagedKVCache as JaxPagedKVCache
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.core.device import moe_balance as tmb
from repro_torch.serving import ServingEngine as TorchEngine

from _torch_parity import models, to_np
from test_torch_engine import MODES, _paged_decode_bit_identical, _serve
from test_torch_engine import _prompts as _engine_prompts
from test_torch_speculative import ATOL as VERIFY_ATOL
from test_torch_speculative import _port_verify, _verify_state
from test_torch_transformer import (S_MAX, _paged_prefill_insert_then_decode,
                                    _prefill_chunk_paged,
                                    _prefill_then_decode)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
SERVE = [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--smoke", "--requests", "4", "--max-new-tokens", "4", "--s-max",
         "64", "--check-paged-equality"]
NEW_ARCHS = ("qwen3-8b", "deepseek-coder-33b", "mistral-large-123b",
             "internvl2-26b", "kimi-k2-1t-a32b")
#: each new decoder's scaled shape: the published GQA group restored at a
#: small width (q heads of 16 wide, 7:1 and 12:1), and Kimi's top-8 over
#: 16 experts
OVER = {"qwen3-8b": {},
        "deepseek-coder-33b": dict(num_heads=14, num_kv_heads=2,
                                   head_dim=16),
        "mistral-large-123b": dict(num_heads=12, num_kv_heads=1,
                                   head_dim=16),
        "kimi-k2-1t-a32b": dict(num_experts=16, num_experts_per_tok=8)}
QWEN3 = "qwen3-8b"
KIMI = "kimi-k2-1t-a32b"


def _bridged(arch, seed, **over):
    return models(seed=seed, arch=arch, **OVER[arch], **over)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_equals_the_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_get_config(arch))


def test_scaled_shapes_keep_what_they_test():
    _, _, model, params = _bridged(QWEN3, 0)
    assert model.cfg.qk_norm
    assert {"q_norm", "k_norm"} <= set(params["blocks"]["attn"])
    for arch, group in (("deepseek-coder-33b", 7),
                        ("mistral-large-123b", 12)):
        cfg = _bridged(arch, 0)[2].cfg
        assert cfg.num_heads // cfg.num_kv_heads == group
    cfg = _bridged(KIMI, 0)[2].cfg
    assert (cfg.num_experts, cfg.num_experts_per_tok) == (16, 8)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("arch", list(OVER))
def test_prefill_then_decode(arch, flash):
    """Prefill logits and cache, then eight greedy decode steps over the
    contiguous cache."""
    _prefill_then_decode(arch, flash, 11, S_MAX, **OVER[arch])


@pytest.mark.parametrize("flash", [False, True])
def test_qwen3_paged_insert_then_decode(flash):
    """Whole-prompt prefills scattered into the pool, then paged decode of
    both at two depths in one batch."""
    _paged_prefill_insert_then_decode(QWEN3, flash, (11, 5), S_MAX)


@pytest.mark.parametrize("flash", [False, True])
def test_qwen3_prefill_chunk_paged(flash):
    """Chunks of one prompt into a permuted block table: logits and the
    pool (chunks take the masked path under either flag, as in the
    reference)."""
    _prefill_chunk_paged(QWEN3, 21, ((0, 8), (8, 13), (13, 21)), S_MAX,
                         use_flash=flash)


@pytest.mark.parametrize("flash", [False, True])
def test_qwen3_verify_paged(flash):
    """``lm_verify_paged``'s all-position logits and the written pool
    against the reference's (rows 0, 2, 3 live; row 1 all-sink)."""
    jmodel, jp, tmodel, tp = _bridged(QWEN3, 7, use_flash=flash)
    k, v, table, pos, tokens = _verify_state(tmodel.cfg)
    want, jcache = jmodel.verify_paged(
        jp, jnp.asarray(tokens), JaxPagedKVCache(jnp.asarray(k),
                                                 jnp.asarray(v)),
        jnp.asarray(table), jnp.asarray(pos))
    got, tcache = _port_verify(tmodel, tp, k, v, table, pos, tokens)
    live = [0, 2, 3]
    np.testing.assert_allclose(to_np(got)[live], to_np(want)[live],
                               atol=VERIFY_ATOL, rtol=0)
    for t, j in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
        np.testing.assert_allclose(to_np(t)[:, 1:], to_np(j)[:, 1:],
                                   atol=VERIFY_ATOL, rtol=0)


ENGINE_CASES = ([(QWEN3, mode, flash) for mode in MODES
                 for flash in (False, True)]
                + [(arch, mode, True) for arch in ("deepseek-coder-33b",
                                                   "mistral-large-123b",
                                                   KIMI)
                   for mode in ("contiguous", "paged")])


@pytest.mark.parametrize("arch,mode,flash", ENGINE_CASES)
def test_engine_tokens_match_reference(arch, mode, flash):
    """The port's engine emits the JAX engine's greedy tokens with the
    same batch metrics (and, with the prefix cache, the same hits)."""
    jmodel, jp, tmodel, tp = _bridged(arch, 8, use_flash=flash)
    prompts = _engine_prompts(jmodel.cfg.vocab_size)
    kw = dict(max_batch=3, s_max=48, block_size=8, **MODES[mode])
    passes = 2 if mode == "paged+cache" else 1   # warm, then adopt
    want, jeng = _serve(JaxEngine(jmodel, jp, **kw), prompts, passes)
    got, teng = _serve(TorchEngine(tmodel, tp, **kw), prompts, passes)
    assert got == want
    assert teng.batcher.metrics == jeng.batcher.metrics
    if mode == "paged+cache":
        assert teng.cache_stats == jeng.cache_stats
        assert teng.cache_stats["hit_tokens"] > 0


def test_kimi_paged_decode_bit_identical_to_contiguous():
    """Top-8 of 16 experts: two prompts decoded in one batch through the
    contiguous cache and through the pool give the same logits, bit for
    bit, at every step (the combine's order is fixed)."""
    _, _, model, params = _bridged(KIMI, 9, use_flash=True)
    _paged_decode_bit_identical(model, params, (13, 6), S_MAX)


@pytest.mark.parametrize("dropless", [True, False])
@pytest.mark.parametrize("k", [1, 2, 8])
def test_combine_bit_identical_to_reference(k, dropless):
    """``combine_expert_outputs`` on the reference's own plan (so the gates
    are the same bits) equals the reference's, bit for bit; a droppy
    capacity drops choices, which add nothing."""
    t, e, d = 64, 32, 48
    rng = np.random.default_rng(k)
    logits = rng.normal(size=(t, e)).astype(np.float32)
    idx, gate, probs = jmb.route_topk(jnp.asarray(logits), k)
    cap = t if dropless else max(1, t * k // e // 2)
    plan = jmb.priority_dispatch(idx, gate, probs, num_experts=e,
                                 capacity=cap)
    assert bool(np.asarray(plan.kept).all()) == dropless
    y = rng.normal(size=(e, cap, d)).astype(np.float32)
    want = np.asarray(jmb.combine_expert_outputs(jnp.asarray(y), plan, t, k))
    tplan = tmb.DispatchPlan(*(torch.from_numpy(np.array(a)) for a in plan))
    got = tmb.combine_expert_outputs(torch.from_numpy(y), tplan, t, k)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_launcher_equality_gate_on_cpu(arch):
    """Paged == contiguous, and the chunk and prefix-cache modes, on the
    launcher's scaled model of each new config."""
    out = subprocess.run(SERVE + ["--arch", arch], env=ENV, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "OK: paged decode == contiguous decode (4 requests)" in out.stdout
    assert "token-exact: True" in out.stdout


def test_launcher_qwen3_with_qwen2_draft():
    """qwen2-1.5b shares qwen3-8b's vocab (151936), so it may draft for it;
    ``paged+spec`` emits the contiguous engine's tokens."""
    out = subprocess.run(SERVE + ["--arch", QWEN3, "--spec-draft",
                                  "qwen2-1.5b", "--max-new-tokens", "12"],
                         env=ENV, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "OK: speculative decode == contiguous decode " \
        "(draft=qwen2-1.5b, k=4)" in out.stdout
