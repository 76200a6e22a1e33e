"""The live cluster in the port against the reference: a router over two
engine replicas of one tiny fp32 qwen (weights bridged from the
reference's init), paged with chunked prefill, emits the JAX cluster's
tokens for every request with the same steal and migration counts; a
stolen partially-prefilled request carries its prefix KV; a crash at a
fixed step replays the same requests to the same tokens.  Requests are
matched by submission order (each package's ``Request`` counts its own
rids), and every clock (batchers, router) is an injected counter."""
import itertools

import numpy as np
import pytest
import torch

import repro.cluster as j_cluster
import repro.core.device.request_scheduler as j_rs
from repro.serving import ServingEngine as JaxEngine
import repro_torch.cluster as t_cluster
import repro_torch.core.device.request_scheduler as t_rs
from repro_torch.serving import ServingEngine as TorchEngine

from _torch_parity import models

JAX = (j_cluster, j_rs, JaxEngine)
TORCH = (t_cluster, t_rs, TorchEngine)
CHUNKED = dict(s_max=48, kv_mode="paged", prefill_chunk=8, block_size=8)
#: the telemetry counters that do not read a clock
COUNTS = ("finished", "cancelled", "rejected", "steal_events",
          "requests_migrated", "chunk_migrations", "weight_migrated")


@pytest.fixture(scope="module")
def bridged():
    return models(seed=7)


def _clock():
    ticks = itertools.count()
    return lambda: float(next(ticks))


def _prompts(vocab, n=10, seed=11):
    """Long prompts (several chunks) at even positions, short ones at odd:
    round-robin placement loads replica 0 with the long ones, so replica 1
    runs dry and steals partly-prefilled requests off it."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(30, 41)) if i % 2 == 0
                         else int(rng.integers(3, 8)))
            for i in range(n)]


def _serve(pkg, model, params, prompts, amount, fail_at=None):
    """Route ``prompts`` over two replicas and drain.  Returns the tokens
    per request (submission order), the telemetry counts, the migrations
    (request index, carried KV, prefill resumed at) and the replay count."""
    cluster, rs, engine_cls = pkg
    engines = [engine_cls(model, params, max_batch=2, **CHUNKED)
               for _ in range(2)]
    for eng in engines:
        eng.batcher.now = _clock()
    reps = [cluster.EngineReplica(i, eng) for i, eng in enumerate(engines)]
    order = {}
    moves = []
    for rep in reps:
        def submit(req, tokens=None, migrated=False, _inner=rep.submit):
            _inner(req, tokens, migrated=migrated)
            if migrated:
                moves.append((order[req.rid],
                              isinstance(tokens, dict) and "kv" in tokens,
                              req.prefilled))
        rep.submit = submit
    router = cluster.ClusterRouter(
        reps, policy=cluster.StealPolicy(amount=amount,
                                         placement="round_robin"),
        now=_clock(), debug_invariants=True)
    reqs = []
    for i, p in enumerate(prompts):
        req = rs.Request(prompt_len=len(p), max_new_tokens=4,
                         priority=float(i % 3), arrival=float(i))
        order[req.rid] = i
        router.submit(req, tokens=p)
        reqs.append(req)
    replayed = []
    for step in range(10_000):
        if step == fail_at:
            replayed = [order[r.rid] for r in router.fail_replica(0)]
        router.step()
        if router.drained():
            break
    assert all(r.state.name == "DONE" for r in reqs)
    router.check()
    alive = [eng for i, eng in enumerate(engines) if i not in router._dead]
    for eng in alive:
        eng.alloc.check()
        assert eng.alloc.num_requests == 0
    dead = [eng for eng in engines if eng not in alive]
    tokens = []
    for r in reqs:
        # a survivor's stream, else (finished before the crash) the dead
        # engine's
        owners = [e.outputs[r.rid] for e in alive if r.rid in e.outputs] \
            or [e.outputs[r.rid] for e in dead if r.rid in e.outputs]
        assert len(owners) == 1
        tokens.append(owners[0])
    summary = router.telemetry.summary()
    return (tokens, {k: summary[k] for k in COUNTS}, moves, replayed,
            summary["chaos"]["requests_replayed"])


@pytest.mark.parametrize("amount", ["half_work", "half_count"])
def test_cluster_matches_reference(bridged, amount):
    jmodel, jp, tmodel, tp = bridged
    prompts = _prompts(jmodel.cfg.vocab_size)
    want = _serve(JAX, jmodel, jp, prompts, amount)
    got = _serve(TORCH, tmodel, tp, prompts, amount)
    assert got[0] == want[0]
    assert all(len(t) == 4 for t in got[0])
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert want[1]["steal_events"] > 0 and want[1]["chunk_migrations"] > 0
    # at least one migration carried prefix KV and resumed past chunk 0
    assert any(kv and resumed > 0 for _, kv, resumed in got[2])


@pytest.mark.parametrize("fail_at", [3, 6])
def test_cluster_crash_matches_reference(bridged, fail_at):
    jmodel, jp, tmodel, tp = bridged
    prompts = _prompts(jmodel.cfg.vocab_size)
    want = _serve(JAX, jmodel, jp, prompts, "half_work", fail_at)
    got = _serve(TORCH, tmodel, tp, prompts, "half_work", fail_at)
    assert got[3] == want[3] and len(want[3]) > 0
    assert got[4] == want[4] == len(want[3])
    assert got[0] == want[0]
    assert got[1] == want[1]


# -- the reference's three migration tests, against the JAX engine ----------

def _drain(engine_cls, model, params, prompts, max_new, **kw):
    eng = engine_cls(model, params, **kw)
    eng.batcher.now = _clock()
    reqs = [eng.submit(p, max_new_tokens=max_new, priority=float(i % 2))
            for i, p in enumerate(prompts)]
    outs = eng.run_until_drained()
    assert all(r.state.name == "DONE" for r in reqs)
    eng.alloc.check()
    return [outs[r.rid] for r in reqs]


def _migrate_chunk_request(engine_cls, model, params):
    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(14)
    long_p = rng.integers(0, vocab, 40)
    victim = engine_cls(model, params, max_batch=1, **CHUNKED)
    victim.batcher.now = _clock()
    victim.submit(rng.integers(0, vocab, 4), 2, priority=0.0)
    req = victim.submit(long_p, 3, priority=1.0)
    for _ in range(3):
        victim.step()
    assert req.prefilled > 0 and req.state.name == "WAITING"
    (stolen, payload), = victim.export_waiting(target_weight=10_000)
    assert stolen is req and isinstance(payload, dict) and "kv" in payload
    victim.alloc.check()
    thief = engine_cls(model, params, max_batch=2, **CHUNKED)
    thief.batcher.now = _clock()
    resumed_at = req.prefilled
    thief.submit_request(req, payload)
    assert req.prefilled == resumed_at      # prefix adopted, not recomputed
    outs = thief.run_until_drained()
    thief.alloc.check()
    ref = _drain(engine_cls, model, params, [long_p], 3, max_batch=1,
                 **CHUNKED)
    assert outs[req.rid] == ref[0]
    return outs[req.rid], resumed_at, payload["kv"]


def test_paged_kv_migrates_with_stolen_chunk_request(bridged):
    jmodel, jp, tmodel, tp = bridged
    want, jresumed, jkv = _migrate_chunk_request(JaxEngine, jmodel, jp)
    got, tresumed, tkv = _migrate_chunk_request(TorchEngine, tmodel, tp)
    assert got == want and tresumed == jresumed > 0
    # the payload: [L, blocks, block_size, kvH, hd] device tensors with the
    # reference's values, copied off the victim's pool
    for t, j in zip(tkv, jkv):
        assert isinstance(t, torch.Tensor) and t.shape == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)


def _migrate_preempted(engine_cls, model, params):
    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(21)
    victim = engine_cls(model, params, max_batch=2, num_blocks=9, **CHUNKED)
    thief = engine_cls(model, params, max_batch=2, **CHUNKED)
    for eng in (victim, thief):
        eng.batcher.now = _clock()
    reqs = [victim.submit(rng.integers(0, vocab, 30), 6) for _ in range(2)]
    for _ in range(6):
        victim.step()
    running = [r for r in reqs if r.state.name == "RUNNING"]
    if running:
        victim._preempt_running(running[0])    # force a fold
    stolen = victim.export_waiting(target_weight=10_000)
    for r, payload in stolen:
        thief.submit_request(r, payload)
    outs = thief.run_until_drained()
    victim.run_until_drained()
    streams = []
    for r in reqs:
        stream = outs.get(r.rid) or victim.outputs.get(r.rid)
        assert r.state.name == "DONE" and len(stream) == 6
        streams.append(stream)
    return streams, [reqs.index(r) for r, _ in stolen], \
        [sorted(p) if isinstance(p, dict) else "tokens" for _, p in stolen]


def test_preempted_request_migrates_with_emitted_tokens(bridged):
    jmodel, jp, tmodel, tp = bridged
    want = _migrate_preempted(JaxEngine, jmodel, jp)
    got = _migrate_preempted(TorchEngine, tmodel, tp)
    assert got == want
    assert any(isinstance(p, list) and "outputs" in p for p in want[2])


def _import_from_larger_ring(engine_cls, model, params):
    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(22)
    kw = dict(kv_mode="paged", prefill_chunk=8, block_size=8)
    victim = engine_cls(model, params, max_batch=1, s_max=48, **kw)
    victim.batcher.now = _clock()
    victim.submit(rng.integers(0, vocab, 4), 2, priority=0.0)
    big = victim.submit(rng.integers(0, vocab, 40), 3, priority=1.0)
    for _ in range(4):
        victim.step()
    assert big.prefilled > 0 and big.state.name == "WAITING"
    (r, payload), = victim.export_waiting(target_weight=10_000)
    assert "kv" in payload
    # the 40-token prompt exceeds the thief's 32-token ring: served
    # degraded (the ring-aligning wrap), its prefix recomputed
    thief = engine_cls(model, params, max_batch=1, s_max=32, **kw)
    thief.batcher.now = _clock()
    thief.submit_request(r, payload, migrated=True)
    assert thief.batcher.metrics["wrapped_oversize"] == 1
    assert r.prefilled == 0
    outs = thief.run_until_drained()
    assert r.state.name == "DONE" and len(outs[r.rid]) == 3
    thief.alloc.check()
    return outs[r.rid]


def test_kv_import_from_larger_ring_recomputes(bridged):
    jmodel, jp, tmodel, tp = bridged
    assert _import_from_larger_ring(TorchEngine, tmodel, tp) == \
        _import_from_larger_ring(JaxEngine, jmodel, jp)


@pytest.mark.parametrize("guard", ["block_size", "pool_full"])
def test_kv_import_guards_recompute(bridged, guard):
    """A prefix in another block size, or one the thief's pool cannot
    allocate, is recomputed: the thief serves the request to the tokens of
    an undisturbed run."""
    _, _, model, params = bridged
    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(14)
    long_p = rng.integers(0, vocab, 40)
    victim = TorchEngine(model, params, max_batch=1, **CHUNKED)
    victim.batcher.now = _clock()
    victim.submit(rng.integers(0, vocab, 4), 2, priority=0.0)
    req = victim.submit(long_p, 3, priority=1.0)
    for _ in range(3):
        victim.step()
    (_, payload), = victim.export_waiting(target_weight=10_000)
    assert "kv" in payload and req.prefilled > 0
    if guard == "block_size":
        thief = TorchEngine(model, params, max_batch=2,
                            **dict(CHUNKED, block_size=16))
    else:
        thief = TorchEngine(model, params, max_batch=2, **CHUNKED)
        thief.alloc.ensure(-1, thief.alloc.free_tokens)   # a full pool
    thief.batcher.now = _clock()
    thief.submit_request(req, payload)
    assert req.prefilled == 0
    if guard == "pool_full":
        thief.alloc.release(-1)
    outs = thief.run_until_drained()
    thief.alloc.check()
    ref = _drain(TorchEngine, model, params, [long_p], 3, max_batch=1,
                 **CHUNKED)
    assert outs[req.rid] == ref[0]
