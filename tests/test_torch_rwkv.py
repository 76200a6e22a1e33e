"""The port's RWKV-6 against ``repro.models.ssm`` and ``repro.models.rwkv_lm``
on bridged weights of ``scale_down(rwkv6-3b)`` in fp32 (the constants the
reference initialises, mixes, decay bias and norms, perturbed so that they
count): each module on both WKV routes, prefill logits and states, decode
steps, and the contiguous engine's greedy tokens against the JAX engine's.

Tolerance 1e-4 on fp32 outputs of magnitude ~1: the two frameworks sum the
same products in other orders (matmuls, the associative scan's tree, the
kernel's step order), ~1e-6 relative per sum."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro.models import ssm as jssm
from repro.serving import ServingEngine as JaxEngine
from repro_torch.models import layers as tl
from repro_torch.models import ssm as tssm
from repro_torch.models.transformer import _layer
from repro_torch.serving import ServingEngine as TorchEngine

from _torch_parity import models, to_np

ARCH = "rwkv6-3b"
ATOL = 1e-4
B, T = 2, 37          # T past two of the scaled config's 16-step chunks


@pytest.fixture(scope="module", params=[False, True], ids=["scan", "kernel"])
def bridged(request):
    """(reference model, params, port model, params) with ``use_flash`` off
    (chunked scan) or on (the WKV-6 kernel's route)."""
    return models(seed=3, arch=ARCH, use_flash=request.param)


def _layer0(jp, tp, part):
    return (jax.tree.map(lambda a: a[0], jp["blocks"][part]),
            _layer(tp["blocks"], 0)[part])


def _x(cfg, seed=0, t=T):
    return np.random.default_rng(seed).standard_normal(
        (B, t, cfg.d_model)).astype(np.float32)


def _state(cfg, seed=1):
    """A non-zero (token shift, wkv state) pair."""
    rng = np.random.default_rng(seed)
    h = cfg.d_model // cfg.rwkv_head_size
    n = cfg.rwkv_head_size
    return (rng.standard_normal((B, cfg.d_model)).astype(np.float32),
            rng.standard_normal((B, h, n, n)).astype(np.float32))


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(to_np(got), to_np(want), atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm(dtype):
    """fp32 statistics, cast back before scale and bias: in bf16 both sides
    round the same normalised values (atol: one bf16 ulp at |y| < 4)."""
    rng = np.random.default_rng(0)
    x, scale, bias = (rng.standard_normal(s).astype(np.float32)
                      for s in ((2, 5, 64), (64,), (64,)))
    (jx, js, jb), (tx, ts, tb) = _both([x, scale, bias])
    dt = getattr(torch, dtype)
    got = tl.group_norm({"scale": ts.to(dt), "bias": tb.to(dt)}, tx.to(dt),
                        4, 1e-5)
    want = jl.group_norm({"scale": js.astype(dtype), "bias": jb.astype(dtype)},
                         jx.astype(dtype), 4, 1e-5)
    assert got.dtype == dt
    _close(got, want, atol=1e-5 if dtype == "float32" else 2 ** -5)


def test_rwkv_project(bridged):
    jmodel, jp, _, tp = bridged
    cfg = jmodel.cfg
    jtm, ttm = _layer0(jp, tp, "tm")
    (jx, js), (tx, ts) = _both([_x(cfg), _x(cfg, seed=5)])
    got = tssm._rwkv_project(ttm, tx, ts, cfg)
    want = jssm._rwkv_project(jtm, jx, js, cfg)
    assert got[4].dtype == torch.float32          # w, the decay
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("with_state", [False, True])
def test_time_mix(bridged, with_state):
    """Both routes: with a state and ``use_flash`` the kernel's (its plain
    version here), otherwise the chunked scan, padded to a chunk multiple."""
    jmodel, jp, _, tp = bridged
    cfg = jmodel.cfg
    jtm, ttm = _layer0(jp, tp, "tm")
    (jx,), (tx,) = _both([_x(cfg)])
    jstate = tstate = None
    if with_state:
        jstate, tstate = _both(_state(cfg))
    y, (last, s_end) = tssm.rwkv_time_mix(ttm, tx, cfg, tstate)
    jy, (jlast, js_end) = jssm.rwkv_time_mix(jtm, jx, cfg, jstate)
    _close(y, jy)
    _close(last, jlast, atol=0)
    _close(s_end, js_end)


def test_time_mix_decode(bridged):
    jmodel, jp, _, tp = bridged
    cfg = jmodel.cfg
    jtm, ttm = _layer0(jp, tp, "tm")
    (jx, jprev, js), (tx, tprev, ts) = _both([_x(cfg, t=1), *_state(cfg)])
    y, (last, s) = tssm.rwkv_time_mix_decode(ttm, tx, cfg, (tprev, ts))
    jy, (jlast, js2) = jssm.rwkv_time_mix_decode(jtm, jx, cfg, (jprev, js))
    _close(y, jy)
    _close(last, jlast, atol=0)
    _close(s, js2)


@pytest.mark.parametrize("with_prev", [False, True])
def test_channel_mix(bridged, with_prev):
    jmodel, jp, _, tp = bridged
    cfg = jmodel.cfg
    jcm, tcm = _layer0(jp, tp, "cm")
    (jx, jprev), (tx, tprev) = _both([_x(cfg), _state(cfg)[0]])
    y, last = tssm.rwkv_channel_mix(tcm, tx, cfg,
                                    tprev if with_prev else None)
    jy, jlast = jssm.rwkv_channel_mix(jcm, jx, cfg,
                                      jprev if with_prev else None)
    _close(y, jy)
    _close(last, jlast, atol=0)


def test_prefill_then_decode(bridged):
    """Prefill logits and every layer's state, then 4 greedy decode steps
    (the port's cache is updated in place)."""
    jmodel, jp, tmodel, tp = bridged
    cfg = jmodel.cfg
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, T))
    jlog, jc = jax.jit(jmodel.prefill)(jp, {"tokens": jnp.asarray(toks)})
    tlog, tc = tmodel.prefill(tp, {"tokens": torch.from_numpy(toks)})
    _close(tlog, jlog)
    for got, want in zip(tc, jc):
        assert got.shape == want.shape
        _close(got, want)
    tok = np.array(jnp.argmax(jlog[:, -1], -1))[:, None]
    assert np.array_equal(torch.argmax(tlog[:, -1], -1)[:, None].numpy(),
                          tok)
    step = jax.jit(jmodel.decode_step)
    for i in range(4):
        jlog, jc = step(jp, jnp.asarray(tok, jnp.int32), jc, T + i)
        out, tc2 = tmodel.decode_step(tp, torch.from_numpy(tok), tc, T + i)
        assert tc2 is tc
        _close(out, jlog)
        for got, want in zip(tc, jc):
            _close(got, want)
        tok = np.array(jnp.argmax(jlog[:, -1], -1))[:, None]
        assert np.array_equal(torch.argmax(out[:, -1], -1)[:, None].numpy(),
                              tok)


def test_kernel_route_matches_scan_route():
    """The port's two WKV routes give the same prefill (logits and state)."""
    _, _, scan, params = models(seed=4, arch=ARCH, use_flash=False)
    _, _, kernel, params2 = models(seed=4, arch=ARCH, use_flash=True)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, scan.cfg.vocab_size, (B, 50)))
    log_a, st_a = scan.prefill(params, {"tokens": toks})
    log_b, st_b = kernel.prefill(params2, {"tokens": toks})
    _close(log_a, log_b)
    for a, b in zip(st_a, st_b):
        _close(a, b)


def _prompts(vocab, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(3, 40)))
            for _ in range(n)]


def _serve(eng, prompts):
    reqs = [eng.submit(p, max_new_tokens=5, priority=float(i % 3))
            for i, p in enumerate(prompts)]
    outs = eng.run_until_drained()
    assert all(r.state.name == "DONE" for r in reqs)
    return [outs[r.rid] for r in reqs], eng


def test_engine_tokens_match_reference(bridged):
    """The contiguous engine (the only mode of the family) generates the JAX
    engine's greedy tokens with the same plans; more requests than slots,
    so slots are reused and states overwritten."""
    jmodel, jp, tmodel, tp = bridged
    prompts = _prompts(jmodel.cfg.vocab_size)
    kw = dict(max_batch=2, s_max=48)
    want, jeng = _serve(JaxEngine(jmodel, jp, **kw), prompts)
    got, teng = _serve(TorchEngine(tmodel, tp, **kw), prompts)
    assert teng.kv_mode == "contiguous" and not teng.paged
    assert got == want
    assert teng.batcher.metrics == jeng.batcher.metrics


def test_paged_engine_raises_for_ssm(bridged):
    _, _, tmodel, tp = bridged
    assert not tmodel.supports_paged
    with pytest.raises(ValueError, match="no paged decode path"):
        TorchEngine(tmodel, tp, max_batch=2, s_max=32, kv_mode="paged")
