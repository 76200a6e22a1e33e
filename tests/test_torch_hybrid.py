"""The port's hybrid (Jamba) against ``repro.models.ssm`` (Mamba) and
``repro.models.hybrid`` on bridged weights of ``scale_down(jamba-v0.1-52b)``
in fp32: two superblocks of four layers (attention, then three Mamba
layers; MoE on every second layer), chunks of 4 steps, the constants the
reference initialises (biases, norm scales, Mamba's conv bias and skip)
perturbed so that they count.  Mamba's prefill and decode, the stack's
prefill, contiguous and paged decode (flash and grouped SwiGLU off, and on:
the port runs the kernels' plain versions on the CPU, the reference its
Pallas kernels in interpret mode), the engine's greedy tokens against the
JAX engine's, a stolen mid-prefill request, and the weight bridge.

Tolerance 1e-5 of the compared tensor's scale, max(1, max |reference|):
fp32 values reach ~4 here, and the two frameworks sum the same products
in other orders (the conv states, in_proj outputs of |x| ~4, differ by up
to 1.1e-5 after four decode steps).  Bit-exact where the reference asserts
it: paged decode against contiguous decode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jax_build_model
from repro.models import ssm as jssm
from repro.serving import ServingEngine as JaxEngine
from repro_torch.models import build_model
from repro_torch.models import ssm as tssm
from repro_torch.models.transformer import _layer
from repro_torch.params import from_numpy_params
from repro_torch.serving import ServingEngine as TorchEngine

from _torch_parity import configs, models, to_np

ARCH = "jamba-v0.1-52b"
RTOL_SCALE = 1e-5
#: two superblocks of [attention, Mamba x 3], MoE at layers 1 and 3
OVER = dict(ssm_chunk=4, attn_every=4, num_layers=8)
B = 2


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "kernels"])
def bridged(request):
    """(reference model, params, port model, params) with ``use_flash``
    off or on (flash attention and grouped SwiGLU)."""
    return models(seed=5, arch=ARCH, use_flash=request.param, **OVER)


@pytest.fixture(scope="module")
def plain():
    return models(seed=5, arch=ARCH, **OVER)


def _close(got, want):
    """Within RTOL_SCALE of the reference's scale, elementwise."""
    want = to_np(want)
    atol = RTOL_SCALE * max(1.0, float(np.abs(want).max(initial=0)))
    np.testing.assert_allclose(to_np(got), want, atol=atol, rtol=0)


def _mamba_params(jp, tp, i=1, sb=0):
    """Layer ``i`` of superblock ``sb``'s Mamba parameters, both sides."""
    return (jax.tree.map(lambda a: a[sb], jp["superblocks"]["layers"][i]
                         ["mamba"]),
            _layer(tp["superblocks"], sb)["layers"][i]["mamba"])


def _x(cfg, t, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, t, cfg.d_model)).astype(np.float32)


def _mamba_state(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, cfg.mamba_d_conv - 1, cfg.mamba_d_inner))
            .astype(np.float32),
            rng.standard_normal((B, cfg.mamba_d_inner, cfg.mamba_d_state))
            .astype(np.float32))


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("t", [1, 2, 4, 37])
def test_mamba_fwd(plain, t, with_state):
    """T = 1 and 2 (under d_conv - 1: the conv state keeps part of the one
    passed in), one chunk, and 37 (past nine chunks, padded)."""
    jmodel, jp, _, tp = plain
    cfg = jmodel.cfg
    jm, tm = _mamba_params(jp, tp)
    x = _x(cfg, t)
    jst = tst = None
    if with_state:
        conv, h = _mamba_state(cfg)
        jst = jssm.MambaState(jnp.asarray(conv), jnp.asarray(h))
        tst = tssm.MambaState(torch.from_numpy(conv), torch.from_numpy(h))
    jy, jout = jssm.mamba_fwd(jm, jnp.asarray(x), cfg, jst)
    ty, tout = tssm.mamba_fwd(tm, torch.from_numpy(x), cfg, tst)
    _close(ty, jy)
    assert tout.conv.shape == jout.conv.shape
    assert tout.h.dtype == torch.float32
    _close(tout.conv, jout.conv)
    _close(tout.h, jout.h)


def test_mamba_decode(plain):
    jmodel, jp, _, tp = plain
    cfg = jmodel.cfg
    jm, tm = _mamba_params(jp, tp, i=2)
    conv, h = _mamba_state(cfg)
    x = _x(cfg, 1, seed=4)
    jy, jst = jssm.mamba_decode(jm, jnp.asarray(x), cfg,
                                jssm.MambaState(jnp.asarray(conv),
                                                jnp.asarray(h)))
    state = tssm.MambaState(torch.from_numpy(conv), torch.from_numpy(h))
    ty, tst = tssm.mamba_decode(tm, torch.from_numpy(x), cfg, state)
    _close(ty, jy)
    _close(tst.conv, jst.conv)
    _close(tst.h, jst.h)
    assert np.array_equal(state.h.numpy(), h)         # not modified


@pytest.mark.parametrize("t", [1, 4, 36])
def test_mamba_handoff(plain, t):
    """mamba_fwd over p + [tok] against mamba_fwd over p, then
    mamba_decode of tok on the state it left: the last output and the
    states agree."""
    jmodel, jp, _, tp = plain
    cfg = jmodel.cfg
    _, tm = _mamba_params(jp, tp, i=3)
    x = torch.from_numpy(_x(cfg, t + 1, seed=6))
    y_all, st_all = tssm.mamba_fwd(tm, x, cfg)
    _, st = tssm.mamba_fwd(tm, x[:, :t], cfg)
    y_last, st_next = tssm.mamba_decode(tm, x[:, t:], cfg, st)
    _close(y_last, y_all[:, t:])
    _close(st_next.conv, st_all.conv)
    _close(st_next.h, st_all.h)


def test_mamba_scan_fast_decay():
    """Decays of exp(-30) a step: a chunk's cumulative decay underflows to
    0 in fp32 within 3 steps.  The scan stays finite and matches the
    step-by-step recurrence in fp64."""
    rng = np.random.default_rng(0)
    t, di, ds = 70, 3, 2
    a = np.exp(-rng.uniform(0, 30, (1, t, di, ds))).astype(np.float32)
    a[:, 10:20] = 1.0
    b = rng.standard_normal((1, t, di, ds)).astype(np.float32)
    h0 = rng.standard_normal((1, di, ds)).astype(np.float32)
    hs, h_end = tssm._mamba_scan_chunked(torch.from_numpy(a),
                                         torch.from_numpy(b),
                                         torch.from_numpy(h0), 64)
    h, want = h0.astype(np.float64), []
    for i in range(t):
        h = a[:, i] * h + b[:, i]
        want.append(h)
    assert torch.isfinite(hs).all()
    np.testing.assert_allclose(hs.numpy(), np.stack(want, 1), atol=1e-5)
    np.testing.assert_allclose(h_end.numpy(), want[-1], atol=1e-5)


def _assert_cache_close(tc, jc, paged=False):
    """Every leaf; a pool without its sink block 0 (empty slots' writes
    land there in an order the two frameworks do not share)."""
    lo = 1 if paged else 0
    for got, want in ((tc.kv.k, jc.kv.k), (tc.kv.v, jc.kv.v)):
        assert got.shape == want.shape
        _close(got[:, lo:], np.asarray(want)[:, lo:])
    for got, want in ((tc.conv, jc.conv), (tc.h, jc.h)):
        assert got.shape == want.shape and got.dtype == torch.float32
        _close(got, want)


def _tokens(cfg, t, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, t))


def test_prefill_then_decode(bridged):
    """hybrid_prefill's logits and cache (past one ring wrap: 13 tokens in
    a ring of 8), then 4 greedy hybrid_decode_step steps."""
    jmodel, jp, tmodel, tp = bridged
    cfg = jmodel.cfg
    prefill = jax.jit(jmodel.prefill, static_argnums=2)
    toks = _tokens(cfg, 13)
    jlog, jc = prefill(jp, {"tokens": jnp.asarray(toks)}, 8)
    tlog, tc = tmodel.prefill(tp, {"tokens": torch.from_numpy(toks)}, 8)
    _close(tlog, jlog)
    _assert_cache_close(tc, jc)
    toks = _tokens(cfg, 9)
    jlog, jc = prefill(jp, {"tokens": jnp.asarray(toks)}, 16)
    tlog, tc = tmodel.prefill(tp, {"tokens": torch.from_numpy(toks)}, 16)
    _close(tlog, jlog)
    _assert_cache_close(tc, jc)
    tok = np.array(jnp.argmax(jlog[:, -1], -1))[:, None]
    step = jax.jit(jmodel.decode_step)
    pos = np.array([9, 9])
    for _ in range(4):
        jlog, jc = step(jp, jnp.asarray(tok, jnp.int32), jc,
                        jnp.asarray(pos, jnp.int32))
        out, tc2 = tmodel.decode_step(tp, torch.from_numpy(tok), tc,
                                      torch.from_numpy(pos))
        assert tc2 is tc
        _close(out, jlog)
        _assert_cache_close(tc, jc)
        tok = np.array(jnp.argmax(jlog[:, -1], -1))[:, None]
        assert np.array_equal(torch.argmax(out[:, -1], -1)[:, None].numpy(),
                              tok)
        pos = pos + 1


def _paged_pair(model, params, prompts, cap, bs, jax_side=False):
    """Prefill ``prompts`` (one request each) into slot i of a contiguous
    cache and of a pool of blocks 1.. (block 0 the sink).  Returns
    (dense cache, pool, table, first tokens, positions)."""
    n = len(prompts)
    arr = jnp.asarray if jax_side else torch.from_numpy
    prefill, insert, insert_paged = (
        (jax.jit(model.prefill, static_argnums=2),
         jax.jit(model.insert_prefill), jax.jit(model.insert_prefill_paged))
        if jax_side else (model.prefill, model.insert_prefill,
                          model.insert_prefill_paged))
    dense = model.init_cache(n, cap)
    pool = model.init_paged_cache(n, n * cap // bs + 1, bs)
    table = arr(np.arange(1, n * cap // bs + 1, dtype=np.int32).reshape(
        n, -1))
    toks = []
    for i, p in enumerate(prompts):
        logits, one = prefill(params, {"tokens": arr(p)}, cap)
        dense = insert(dense, one, i)
        pool = insert_paged(pool, one, table[i], i)
        toks.append(int(np.argmax(to_np(logits)[0, -1])))
    return dense, pool, table, toks, [p.shape[1] for p in prompts]


def _prompts2(vocab):
    rng = np.random.default_rng(8)
    return [rng.integers(0, vocab, (1, n)) for n in (11, 3)]


def test_paged_decode_matches_reference(bridged):
    """hybrid_insert_prefill_paged and 4 steps of hybrid_decode_step_paged:
    logits, the pool (without the sink) and the Mamba states."""
    jmodel, jp, tmodel, tp = bridged
    cap, bs = 16, 4
    prompts = _prompts2(jmodel.cfg.vocab_size)
    _, jpool, jtable, toks, pos = _paged_pair(jmodel, jp, prompts, cap, bs,
                                              jax_side=True)
    _, tpool, ttable, ttoks, _ = _paged_pair(tmodel, tp, prompts, cap, bs)
    assert ttoks == toks
    _assert_cache_close(tpool, jpool, paged=True)
    step = jax.jit(jmodel.decode_step_paged)
    tok, pos = np.array(toks)[:, None], np.array(pos)
    for _ in range(4):
        jlog, jpool = step(jp, jnp.asarray(tok, jnp.int32), jpool, jtable,
                           jnp.asarray(pos, jnp.int32))
        tlog, tpool = tmodel.decode_step_paged(
            tp, torch.from_numpy(tok), tpool, ttable, torch.from_numpy(pos))
        _close(tlog, jlog)
        _assert_cache_close(tpool, jpool, paged=True)
        tok = np.array(jnp.argmax(jlog[:, -1], -1))[:, None]
        pos = pos + 1


def test_paged_decode_bit_identical_to_contiguous(bridged):
    """Two prompts prefilled, then decoded in one batch through the
    contiguous cache and through the pool: logits and Mamba states equal
    bit for bit at every step."""
    _, _, model, params = bridged
    cap, bs = 16, 4
    dense, pool, table, toks, pos = _paged_pair(
        model, params, _prompts2(model.cfg.vocab_size), cap, bs)
    tok, pos = torch.tensor(toks)[:, None], torch.tensor(pos)
    for _ in range(6):
        want, dense = model.decode_step(params, tok, dense, pos)
        got, pool = model.decode_step_paged(params, tok, pool, table, pos)
        assert torch.equal(got, want)
        assert torch.equal(pool.conv, dense.conv)
        assert torch.equal(pool.h, dense.h)
        tok = torch.argmax(got[:, -1], dim=-1)[:, None]
        pos = pos + 1


def _random_states(cache, seed=0):
    g = torch.Generator().manual_seed(seed)
    for t in (cache.conv, cache.h):
        t.copy_(torch.randn(t.shape, generator=g))
    return [t.clone() for t in (cache.conv, cache.h)]


@pytest.mark.parametrize("kv_mode", ["contiguous", "paged"])
def test_insert_leaves_neighbour_slots(plain, kv_mode):
    """The engine's insert (hybrid_insert_prefill through the engine's
    hook, or hybrid_insert_prefill_paged) writes slot 1's Mamba states
    (batch axis 2) and leaves slots 0 and 2 as they were."""
    _, _, model, params = plain
    eng = TorchEngine(model, params, max_batch=3, s_max=16, block_size=4,
                      kv_mode=kv_mode)
    before = _random_states(eng.cache)
    kv_before = eng.cache.kv.k.clone()
    toks = torch.from_numpy(_tokens(model.cfg, 6)[:1])
    _, one = model.prefill(params, {"tokens": toks}, 16)
    if kv_mode == "contiguous":
        eng._insert_contiguous(1, one)
        assert torch.equal(eng.cache.kv.k[:, 1], one.kv.k[:, 0])
        assert torch.equal(eng.cache.kv.k[:, [0, 2]], kv_before[:, [0, 2]])
    else:
        eng.alloc.ensure(7, 6)
        eng.cache = model.insert_prefill_paged(
            eng.cache, one, torch.as_tensor(eng.alloc.table_row(7, 4)), 1)
    for got, old, new in zip((eng.cache.conv, eng.cache.h), before,
                             (one.conv, one.h)):
        assert torch.equal(got[:, :, 1], new[:, :, 0])
        assert torch.equal(got[:, :, [0, 2]], old[:, :, [0, 2]])


def _serve(eng, prompts, max_new=5):
    reqs = [eng.submit(p, max_new_tokens=max_new, priority=float(i % 2))
            for i, p in enumerate(prompts)]
    outs = eng.run_until_drained()
    assert all(r.state.name == "DONE" for r in reqs)
    if eng.paged:
        eng.alloc.check()
        assert eng.alloc.num_requests == 0
    return [outs[r.rid] for r in reqs], eng


@pytest.mark.parametrize("kv_mode", ["contiguous", "paged"])
def test_engine_tokens_match_reference(plain, kv_mode):
    """The counterpart of the reference's paged hybrid engine test: prompts
    of 2, 9 and 14 tokens on 2 slots (a slot is reused), the JAX engine's
    tokens and plans, with the port's chunking off (the JAX engine has no
    chunk path for the hybrid and prefills whole).  The port's paged
    engine, which chunks the hybrid (chunks of 8, the Mamba state carried),
    gives the JAX engine's tokens too."""
    jmodel, jp, tmodel, tp = plain
    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, jmodel.cfg.vocab_size, n) for n in (2, 9, 14)]
    kw = dict(max_batch=2, s_max=32, block_size=8, kv_mode=kv_mode,
              prefill_chunk=8)
    want, jeng = _serve(JaxEngine(jmodel, jp, **kw), prompts)
    assert jeng.batcher.prefill_chunk is None
    got, teng = _serve(TorchEngine(tmodel, tp, **dict(kw, prefill_chunk=None)),
                       prompts)
    assert got == want
    assert teng.batcher.metrics == jeng.batcher.metrics
    got, teng = _serve(TorchEngine(tmodel, tp, **kw), prompts)
    assert got == want
    assert teng.batcher.prefill_chunk == (8 if kv_mode == "paged" else None)


def _steal(engine_cls, model, params, prompt):
    """The reference's mid-prefill steal: a parked request with 8 tokens
    'prefilled' is exported, restarts from chunk 0 on a second engine."""
    kw = dict(s_max=32, kv_mode="paged", block_size=8)
    victim = engine_cls(model, params, max_batch=1, **kw)
    req = victim.submit(prompt, 3)
    victim.alloc.ensure(req.rid, 8)
    req.prefilled = 8
    (r, payload), = victim.export_waiting(target_weight=10_000)
    assert r is req and r.prefilled == 0
    assert not (isinstance(payload, dict) and "kv" in payload)
    victim.alloc.check()
    thief = engine_cls(model, params, max_batch=1, **kw)
    thief.submit_request(r, payload)
    outs = thief.run_until_drained()
    ref, _ = _serve(engine_cls(model, params, max_batch=1, **kw), [prompt],
                    max_new=3)
    assert outs[r.rid] == ref[0]
    return outs[r.rid]


def test_midprefill_steal_restarts_from_chunk0(plain):
    """The counterpart of the reference's
    ``test_hybrid_midprefill_steal_restarts_from_chunk0``: the hybrid pool
    exports no KV (its Mamba states cannot travel), the thief restarts from
    chunk 0 and emits the undisturbed tokens, the JAX engines' tokens."""
    jmodel, jp, tmodel, tp = plain
    prompt = np.random.default_rng(25).integers(0, jmodel.cfg.vocab_size, 14)
    assert _steal(TorchEngine, tmodel, tp, prompt) == \
        _steal(JaxEngine, jmodel, jp, prompt)


def _ref_tree(dtype):
    jcfg, tcfg = configs(ARCH, **OVER)
    jcfg, tcfg = (c.replace(dtype=dtype, param_dtype=dtype)
                  for c in (jcfg, tcfg))
    tree = jax.tree.map(np.asarray,
                        jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    return tcfg, tree


def _pairs(tree, port, path=""):
    if isinstance(tree, dict):
        assert isinstance(port, dict) and set(port) == set(tree)
        for k in tree:
            yield from _pairs(tree[k], port[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        assert isinstance(port, list) and len(port) == len(tree)
        for i, (a, b) in enumerate(zip(tree, port)):
            yield from _pairs(a, b, f"{path}/{i}")
    else:
        yield path, tree, port


def test_bridge_hybrid_tree():
    """The reference's bf16 tree: lists of layers under superblocks, leaves
    [n_sb, ...], bf16 leaves bit for bit, Mamba's a_log and d_skip and the
    router fp32 (also under a dtype cast); a wrong leading dim is refused."""
    cfg, tree = _ref_tree("bfloat16")
    port = from_numpy_params(tree, cfg, "cpu")
    assert isinstance(port["superblocks"]["layers"], list)
    n = 0
    for path, want, got in _pairs(tree, port):
        if want.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16, path
            assert np.array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16)), path
            n += 1
        else:
            assert got.dtype == torch.float32, path
            np.testing.assert_array_equal(got.numpy(), want)
    assert n > 20
    cast = from_numpy_params(tree, cfg, "cpu", dtype=torch.bfloat16)
    layers = cast["superblocks"]["layers"]
    for i in (1, 2, 3):
        assert layers[i]["mamba"]["a_log"].dtype == torch.float32
        assert layers[i]["mamba"]["d_skip"].dtype == torch.float32
        assert layers[i]["mamba"]["conv_w"].dtype == torch.bfloat16
    assert layers[1]["moe"]["router"]["w"].dtype == torch.float32
    assert layers[1]["moe"]["router"]["w"].shape[0] == 2
    bad = jax.tree.map(lambda a: a, tree)
    bad["superblocks"]["layers"][2]["mamba"]["a_log"] = \
        tree["superblocks"]["layers"][2]["mamba"]["a_log"][:1]
    with pytest.raises(ValueError, match="superblocks/layers/2/mamba/a_log"):
        from_numpy_params(bad, cfg, "cpu")


def test_init_matches_reference_tree():
    """The port's own init draws the reference's tree: the same structure,
    shapes and dtypes, leaf for leaf (bf16 weights, fp32 A, D and
    router)."""
    cfg, tree = _ref_tree("bfloat16")
    params = build_model(cfg, "cpu").init(0)
    for path, want, got in _pairs(tree, params):
        assert tuple(got.shape) == want.shape, path
        assert str(got.dtype).split(".")[1] == want.dtype.name, path
