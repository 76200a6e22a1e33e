"""Speculative decoding in the port: draft and verify as composed strategies
on the paged engine, against the port's own plain decode and against the
JAX engine on the same weights.

Three families of checks, as in ``tests/test_speculative.py``:

* greedy equivalence: with a self, cross or partial draft the emitted
  stream equals plain decode token for token (fp32), and the allocator's
  invariants hold after every rollback;
* strategy composition: verify outranks request outranks draft in one
  ``StrategyTaskStorage``; drafts are stolen first and shed first; a
  cleared slot drops its spec state;
* parity with the reference: ``lm_verify_paged``'s all-position logits,
  and the engine's tokens and ``spec_stats``, equal the JAX package's
  (the same strategies schedule both).

Pools are compared without the sink block 0 (duplicate-index writes of
inactive rows land there in another order in each framework).
"""
import itertools

import jax
import numpy as np
import pytest
import torch

from repro.models.attention import PagedKVCache as JaxPagedKVCache
from repro.serving import ServingEngine as JaxEngine
from repro.serving import Speculator as JaxSpeculator
from repro_torch.configs import get_config, scale_down
from repro_torch.core.device.request_scheduler import (Request,
                                                       RequestStrategy)
from repro_torch.core.task import FinishRegion, Task
from repro_torch.core.task_storage import StrategyTaskStorage
from repro_torch.models import build_model
from repro_torch.models.attention import PagedKVCache
from repro_torch.params import from_numpy_params
from repro_torch.serving import ServingEngine, Speculator
from repro_torch.serving import speculative
from repro_torch.serving.speculative import (DraftStrategy, VerifyStrategy,
                                             _AdaptiveK,
                                             accept_longest_prefix)

from _torch_parity import models, to_np

#: relative noise (of each leaf's std) that turns the target's weights into
#: a partial draft: some rounds accept some but not all proposals
PARTIAL_NOISE = 0.1
#: all-position verify logits against the reference's (fp32)
ATOL = 1e-5


@pytest.fixture(scope="module")
def bridged():
    return models(seed=7)


@pytest.fixture(scope="module")
def bridged_moe():
    """Scaled mixtral-8x22b: 4 experts, top-2, sliding window 64."""
    return models(seed=7, arch="mixtral-8x22b")


@pytest.fixture(scope="module")
def dense(bridged):
    _, _, model, params = bridged
    return model.cfg, model, params


def _prompts(vocab, n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(4, 14)))
            for _ in range(n)]


def _run(model, params, prompts, max_new=6, spec=None, **kw):
    kw.setdefault("max_batch", 3)
    kw.setdefault("s_max", 48)
    eng = ServingEngine(model, params, speculator=spec, **kw)
    reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    outs = eng.run_until_drained()
    assert all(r.state.name == "DONE" for r in reqs)
    eng.alloc.check()
    return eng, [outs[r.rid] for r in reqs]


# -- accept rule --------------------------------------------------------------

def test_accept_longest_prefix():
    acc, m = accept_longest_prefix([1, 2, 3], [1, 2, 3, 4])
    assert (acc, m) == ([1, 2, 3, 4], 3)       # all drafts + bonus token
    acc, m = accept_longest_prefix([1, 2, 3], [9, 8, 7, 6])
    assert (acc, m) == ([9], 0)                # full reject still emits 1
    acc, m = accept_longest_prefix([1, 2, 3], [1, 9, 7, 6])
    assert (acc, m) == ([1, 9], 1)             # partial + correction
    acc, m = accept_longest_prefix([], [5])
    assert (acc, m) == ([5], 0)


# -- greedy equivalence -------------------------------------------------------

def test_self_draft_bit_identical(dense):
    """Self draft: everything accepted, the stream equals plain decode, and
    concurrent slots' draft chains merged."""
    cfg, model, params = dense
    prompts = _prompts(cfg.vocab_size)
    _, base = _run(model, params, prompts)
    eng, outs = _run(model, params, prompts, spec=Speculator(model, params,
                                                             k=3))
    assert outs == base
    s = eng.spec_stats
    assert s["rounds"] > 0 and s["wasted"] == 0
    assert s["acceptance_rate"] == 1.0
    assert s["merged_drafts"] >= 1


def test_cross_draft_bit_identical(dense):
    """A disagreeing draft (same arch, other weights): rejection, correction
    and KV rollback, and still the plain stream."""
    cfg, model, params = dense
    dparams = model.init(7)
    prompts = _prompts(cfg.vocab_size, seed=1)
    _, base = _run(model, params, prompts, max_new=8)
    eng, outs = _run(model, params, prompts, max_new=8,
                     spec=Speculator(model, dparams, k=3, adaptive=False))
    assert outs == base
    s = eng.spec_stats
    assert s["rounds"] > 0 and s["wasted"] > 0


def test_spec_with_prefix_cache_warm(dense):
    """Speculation over COW-shared prefix blocks: the reserve path forks
    before verify writes, so published blocks stay intact."""
    cfg, model, params = dense
    rng = np.random.default_rng(2)
    shared = rng.integers(0, cfg.vocab_size, 16)
    prompts = [np.concatenate([shared,
                               rng.integers(0, cfg.vocab_size, 5 + i)])
               for i in range(3)]
    kw = dict(prefill_chunk=8, prefix_cache=True)
    _, base = _run(model, params, prompts, **kw)
    eng = ServingEngine(model, params, max_batch=3, s_max=48,
                        speculator=Speculator(model, params, k=3), **kw)
    for p in prompts:
        eng.submit(p, max_new_tokens=6)
    eng.run_until_drained()                     # warm pass publishes
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    outs = eng.run_until_drained()
    assert all(r.state.name == "DONE" for r in reqs)
    assert [outs[r.rid] for r in reqs] == base
    assert eng.cache_stats["hit_tokens"] > 0
    assert eng.spec_stats["rounds"] > 0
    eng.alloc.check()


def test_spec_through_flash_route(dense):
    """``use_flash``: the draft chain and plain decode take the flash
    wrapper (its plain version on the CPU), verify the masked path; every
    request finishes with the plain engine's token count."""
    cfg, model, params = dense
    fmodel = build_model(cfg.replace(use_flash=True), "cpu")
    prompts = _prompts(cfg.vocab_size, n=2, seed=3)
    _, base = _run(fmodel, params, prompts)
    eng, outs = _run(fmodel, params, prompts,
                     spec=Speculator(fmodel, params, k=3))
    assert [len(o) for o in outs] == [len(o) for o in base]
    assert eng.spec_stats["rounds"] > 0


def test_spec_moe_family(bridged_moe):
    _, _, model, params = bridged_moe
    prompts = _prompts(model.cfg.vocab_size, n=2, seed=4)
    _, base = _run(model, params, prompts)
    eng, outs = _run(model, params, prompts,
                     spec=Speculator(model, params, k=3))
    assert outs == base
    assert eng.spec_stats["acceptance_rate"] == 1.0


# -- strategy composition -----------------------------------------------------

def _mk_task(strategy):
    return Task(lambda: None, (), {}, strategy, FinishRegion())


def test_pop_order_verify_request_draft():
    """In one storage: verify (class -1), then the request (class 0), then
    the draft (huge class)."""
    storage = StrategyTaskStorage(0)
    req = Request(prompt_len=4, max_new_tokens=4, priority=0.0)
    storage.push(_mk_task(DraftStrategy("propose", 0, k=4)))
    storage.push(_mk_task(RequestStrategy(req, lambda: 0.0)))
    storage.push(_mk_task(VerifyStrategy(1, [1, 2])))
    order = [type(storage.pop_local().strategy).__name__ for _ in range(3)]
    assert order == ["VerifyStrategy", "RequestStrategy", "DraftStrategy"]
    assert storage.pop_local() is None


def test_steal_order_drafts_before_verifies():
    d = DraftStrategy("propose", 0, k=2)
    v = VerifyStrategy(0, [1])
    assert d.steal_prioritize(v)        # drafts are cheap to lose
    assert not v.steal_prioritize(d)    # verifies are steal-resistant


def test_shed_drafts_pruned_never_verifies():
    pruned = []
    storage = StrategyTaskStorage(0, on_prune=pruned.append)
    d1, d2 = DraftStrategy("propose", 0, k=2), DraftStrategy("warm", 1)
    storage.push(_mk_task(d1))
    storage.push(_mk_task(d2))
    storage.push(_mk_task(VerifyStrategy(2, [5])))
    d1.shed = True
    d2.shed = True
    first = storage.pop_local()
    assert isinstance(first.strategy, VerifyStrategy)
    assert storage.pop_local() is None          # both drafts pruned
    assert len(pruned) == 2


def test_pool_pressure_sheds_drafts_not_correctness(dense):
    """Every block allocated (zero free, zero cached): the round sheds all
    drafts before spending compute; requests decode plain, unchanged."""
    cfg, model, params = dense
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, 8) for _ in range(2)]
    _, base = _run(model, params, prompts, max_new=4)
    eng, outs = _run(model, params, prompts, max_new=4,
                     spec=Speculator(model, params, k=3), max_batch=2,
                     s_max=32, block_size=16, num_blocks=3)
    assert outs == base
    s = eng.spec_stats
    assert s["shed"] > 0 and s["rounds"] == 0


def test_cleared_slot_drops_spec_state(dense):
    """A cleared slot's spec state dies with it; the next round re-warms
    and the output is still exact."""
    cfg, model, params = dense
    prompts = _prompts(cfg.vocab_size, n=1, seed=6)
    _, base = _run(model, params, prompts, max_new=8)
    spec = Speculator(model, params, k=2)
    eng = ServingEngine(model, params, max_batch=3, s_max=48,
                        speculator=spec)
    req = eng.submit(prompts[0], max_new_tokens=8)
    eng.step()                                  # prefill (+ warm)
    eng.step()                                  # first speculation round
    assert spec._state[0].warm
    warms_before = eng.spec_stats["warms"]
    spec.on_clear(0)                            # what _clear_slot invokes
    assert not spec._state[0].warm
    eng.run_until_drained()
    assert req.state.name == "DONE"
    assert eng.outputs[req.rid] == base[0]
    assert eng.spec_stats["warms"] == warms_before + 1   # re-warmed
    eng.alloc.check()


def test_adaptive_k_tracks_acceptance():
    a = _AdaptiveK(4, 1, 8)
    for _ in range(6):
        a.update(1, 4, 4)                       # full acceptance
    assert a.k_for(1) == 8
    for _ in range(10):
        a.update(1, 0, 4)                       # full rejection
    assert a.k_for(1) == 1
    a.drop(1)
    assert a.k_for(1) == 4                      # back to the default


def test_take_record_pops_per_request_totals(dense):
    cfg, model, params = dense
    spec = Speculator(model, params, k=3)
    eng, _ = _run(model, params, _prompts(cfg.vocab_size, n=2, seed=9),
                  max_new=8, spec=spec)
    recs = [spec.take_record(rid) for rid in list(spec._per_req)]
    assert recs and all(d == a > 0 for d, a in recs)   # self draft
    s = eng.spec_stats
    assert sum(d for d, _ in recs) == s["drafted"]
    assert sum(a for _, a in recs) == s["accepted"]
    assert spec.take_record(0) is None and not spec._per_req


# -- validation ---------------------------------------------------------------

def test_speculator_rejects_bad_configs(dense):
    cfg, model, params = dense
    with pytest.raises(ValueError):
        Speculator(model, params, k=0)
    with pytest.raises(ValueError):
        Speculator(model, params, k=4, k_min=5)
    ssm = build_model(scale_down(get_config("rwkv6-3b")), "cpu")
    with pytest.raises(ValueError, match="positional"):
        Speculator(ssm, None)


def test_speculator_rejects_vocab_mismatch(dense):
    cfg, model, params = dense
    dmodel = build_model(scale_down(get_config("qwen2-1.5b"), vocab=1024),
                         "cpu")
    spec = Speculator(dmodel, dmodel.init(0), k=2)
    with pytest.raises(ValueError, match="vocab"):
        ServingEngine(model, params, max_batch=2, s_max=32, speculator=spec)


def test_speculator_rejects_contiguous_engine(dense):
    cfg, model, params = dense
    spec = Speculator(model, params, k=2)
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(model, params, max_batch=2, s_max=32,
                      kv_mode="contiguous", speculator=spec)


# -- verify against the reference and against decode --------------------------

def _verify_state(cfg, seed=0, b=4, c=4, bs=8, nblk=8):
    """A pool of random K/V with per-row tables over distinct blocks, one
    inactive row (all-sink table), mixed positions with pos + c <= cap."""
    rng = np.random.default_rng(seed)
    hd = cfg.resolved_head_dim
    nb = b * nblk + 1
    shape = (cfg.num_layers, nb, bs, cfg.num_kv_heads, hd)
    k = rng.normal(0, 1, shape).astype(np.float32)
    v = rng.normal(0, 1, shape).astype(np.float32)
    table = (1 + np.arange(b * nblk, dtype=np.int32)).reshape(b, nblk)
    table[1] = 0                                # inactive row
    cap = nblk * bs
    pos = np.array([0, 0, 17, cap - c][:b], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (b, c)).astype(np.int32)
    return k, v, table, pos, tokens


def _port_verify(model, params, k, v, table, pos, tokens):
    cache = PagedKVCache(torch.from_numpy(k.copy()),
                         torch.from_numpy(v.copy()))
    return model.verify_paged(params, torch.from_numpy(tokens).long(),
                              cache, torch.from_numpy(table),
                              torch.from_numpy(pos).long())


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mixtral-8x22b"])
def test_verify_paged_matches_reference(arch, bridged, bridged_moe):
    """All-position logits and the written pool against the reference's
    ``lm_verify_paged`` (active rows; pool without the sink)."""
    jmodel, jp, tmodel, tp = bridged if arch == "qwen2-1.5b" \
        else bridged_moe
    k, v, table, pos, tokens = _verify_state(tmodel.cfg)
    want, jcache = jmodel.verify_paged(
        jp, jax.numpy.asarray(tokens),
        JaxPagedKVCache(jax.numpy.asarray(k), jax.numpy.asarray(v)),
        jax.numpy.asarray(table), jax.numpy.asarray(pos))
    got, tcache = _port_verify(tmodel, tp, k, v, table, pos, tokens)
    live = [0, 2, 3]
    assert got.shape == (4, tokens.shape[1], tmodel.cfg.vocab_size)
    np.testing.assert_allclose(to_np(got)[live], to_np(want)[live],
                               atol=ATOL, rtol=0)
    for t, j in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
        np.testing.assert_allclose(to_np(t)[:, 1:], to_np(j)[:, 1:],
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mixtral-8x22b"])
def test_verify_c1_bit_identical_to_decode(arch, bridged, bridged_moe):
    """Verify of one token is the paged decode step, bit for bit: logits
    and the pool (without the sink)."""
    _, _, model, params = bridged if arch == "qwen2-1.5b" else bridged_moe
    k, v, table, pos, tokens = _verify_state(model.cfg, seed=1, c=1)
    got, vcache = _port_verify(model, params, k, v, table, pos, tokens)
    cache = PagedKVCache(torch.from_numpy(k.copy()),
                         torch.from_numpy(v.copy()))
    want, dcache = model.decode_step_paged(
        params, torch.from_numpy(tokens).long(), cache,
        torch.from_numpy(table), torch.from_numpy(pos).long())
    live = [0, 2, 3]
    assert torch.equal(got[live], want[live])
    assert torch.equal(vcache.k[:, 1:], dcache.k[:, 1:])
    assert torch.equal(vcache.v[:, 1:], dcache.v[:, 1:])


def test_verify_rows_match_sequential_decode(bridged):
    """Row i of a c-token verify is the i-th of c sequential decode steps
    (the contract the accept rule rests on), within fp32 rounding."""
    _, _, model, params = bridged
    k, v, table, pos, tokens = _verify_state(model.cfg, seed=2, c=4)
    got, vcache = _port_verify(model, params, k, v, table, pos, tokens)
    cache = PagedKVCache(torch.from_numpy(k.copy()),
                         torch.from_numpy(v.copy()))
    for i in range(tokens.shape[1]):
        step, cache = model.decode_step_paged(
            params, torch.from_numpy(tokens[:, i:i + 1]).long(), cache,
            torch.from_numpy(table), torch.from_numpy(pos + i).long())
        np.testing.assert_allclose(to_np(got[[0, 2, 3], i]),
                                   to_np(step[[0, 2, 3], 0]), atol=ATOL,
                                   rtol=0)
    np.testing.assert_allclose(to_np(vcache.k[:, 1:]),
                               to_np(cache.k[:, 1:]), atol=ATOL, rtol=0)


# -- the engine against the JAX engine -----------------------------------------

def _noisy(tree, scale, rng):
    if isinstance(tree, dict):
        return {k: _noisy(v, scale, rng) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    return a + rng.normal(0, scale * a.std(), a.shape).astype(np.float32)


def _drafts(kind, jp, tp, tcfg, arch):
    """(reference draft params, port draft params) of the same weights."""
    if kind == "self":
        return jp, tp
    if kind == "cross":
        _, jdp, _, tdp = models(seed=8, arch=arch)
        return jdp, tdp
    tree = _noisy(jax.tree.map(np.asarray, jp), PARTIAL_NOISE,
                  np.random.default_rng(3))
    return (jax.tree.map(jax.numpy.asarray, tree),
            from_numpy_params(tree, tcfg, "cpu"))


def _serve(engine_cls, model, params, prompts, spec):
    eng = engine_cls(model, params, max_batch=3, s_max=48, block_size=8,
                     speculator=spec)
    ticks = itertools.count()
    eng.batcher.now = lambda: float(next(ticks))
    reqs = [eng.submit(p, max_new_tokens=10, priority=float(i % 3))
            for i, p in enumerate(prompts)]
    outs = eng.run_until_drained()
    assert all(r.state.name == "DONE" for r in reqs)
    eng.alloc.check()
    return [outs[r.rid] for r in reqs], eng


@pytest.mark.parametrize("draft", ["self", "cross", "partial"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mixtral-8x22b"])
def test_engine_spec_matches_reference(arch, draft, bridged, bridged_moe,
                                       monkeypatch):
    """The port's speculative engine emits its own plain engine's tokens
    and the JAX engine's, with the JAX engine's ``spec_stats`` and metrics:
    the same strategies schedule both.  The partial draft accepts some but
    not all proposals in some round."""
    jmodel, jp, tmodel, tp = bridged if arch == "qwen2-1.5b" \
        else bridged_moe
    jdp, tdp = _drafts(draft, jp, tp, tmodel.cfg, arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tmodel.cfg.vocab_size,
                            int(rng.integers(4, 20))) for _ in range(4)]
    rounds = []

    def record(proposals, target):
        accepted, matched = accept_longest_prefix(proposals, target)
        rounds.append((matched, len(proposals)))
        return accepted, matched
    monkeypatch.setattr(speculative, "accept_longest_prefix", record)
    plain, _ = _serve(ServingEngine, tmodel, tp, prompts, None)
    adaptive = draft != "partial"
    want, jeng = _serve(JaxEngine, jmodel, jp, prompts,
                        JaxSpeculator(jmodel, jdp, k=3, adaptive=adaptive))
    got, teng = _serve(ServingEngine, tmodel, tp, prompts,
                       Speculator(tmodel, tdp, k=3, adaptive=adaptive))
    assert got == plain
    assert got == want
    assert teng.spec_stats == jeng.spec_stats
    assert teng.batcher.metrics == jeng.batcher.metrics
    s = teng.spec_stats
    assert s["rounds"] == len(rounds) > 0
    if draft == "self":
        assert s["acceptance_rate"] == 1.0
    elif draft == "cross":
        assert s["wasted"] > 0
    else:
        assert any(0 < m < k for m, k in rounds), rounds
