"""The port's serving engine and scheduler copy against the reference's: the
same prompts, priorities and injected clock give the same tokens per
request in every KV mode, dense and MoE, and the same batch plans; the MoE
model's paged decode is bit-identical to its contiguous decode."""
import itertools

import numpy as np
import pytest
import torch

from repro.core.device import request_scheduler as jrs
from repro.serving import ServingEngine as JaxEngine
from repro_torch.core.device import request_scheduler as trs
from repro_torch.serving import ServingEngine as TorchEngine

from _torch_parity import models

MODES = {
    "contiguous": dict(kv_mode="contiguous"),
    "paged": dict(kv_mode="paged"),
    "paged+chunked": dict(kv_mode="paged", prefill_chunk=8),
    "paged+cache": dict(kv_mode="paged", prefill_chunk=8, prefix_cache=True),
}


@pytest.fixture(scope="module")
def bridged():
    return models(seed=7)


@pytest.fixture(scope="module")
def bridged_moe():
    """Scaled mixtral-8x22b: 4 experts, top-2, sliding window 64."""
    return models(seed=7, arch="mixtral-8x22b")


def _prompts(vocab, n=6, seed=0):
    """Half share a 16-token prefix (the prefix-cache shape), half cold."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 16)
    out = []
    for i in range(n):
        tail = rng.integers(0, vocab, int(rng.integers(3, 20)))
        out.append(np.concatenate([prefix, tail]) if i % 2 == 0 else tail)
    return out


def _clock():
    ticks = itertools.count()
    return lambda: float(next(ticks))


def _serve(eng, prompts, passes):
    eng.batcher.now = _clock()
    for _ in range(passes):
        reqs = [eng.submit(p, max_new_tokens=5, priority=float(i % 3))
                for i, p in enumerate(prompts)]
        outs = eng.run_until_drained()
        assert all(r.state.name == "DONE" for r in reqs)
        if eng.paged:
            eng.alloc.check()
    return [outs[r.rid] for r in reqs], eng


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_tokens_match_reference(bridged, mode):
    jmodel, jp, tmodel, tp = bridged
    prompts = _prompts(jmodel.cfg.vocab_size)
    kw = dict(max_batch=3, s_max=48, block_size=8, **MODES[mode])
    passes = 2 if mode == "paged+cache" else 1   # warm, then adopt
    want, jeng = _serve(JaxEngine(jmodel, jp, **kw), prompts, passes)
    got, teng = _serve(TorchEngine(tmodel, tp, **kw), prompts, passes)
    assert got == want
    assert teng.batcher.metrics == jeng.batcher.metrics
    if mode == "paged+cache":
        assert teng.cache_stats == jeng.cache_stats
        assert teng.cache_stats["hit_tokens"] > 0


def _long_prompts(vocab, n=4, seed=1):
    """Prompts past the scaled window (64), half with a shared prefix."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 16)
    out = []
    for i in range(n):
        tail = rng.integers(0, vocab, int(rng.integers(50, 80)))
        out.append(np.concatenate([prefix, tail]) if i % 2 == 0 else tail)
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_moe_engine_tokens_match_reference(bridged_moe, mode):
    jmodel, jp, tmodel, tp = bridged_moe
    prompts = _long_prompts(jmodel.cfg.vocab_size)
    assert max(map(len, prompts)) > jmodel.cfg.sliding_window
    kw = dict(max_batch=3, s_max=128, block_size=8, **MODES[mode])
    passes = 2 if mode == "paged+cache" else 1
    want, jeng = _serve(JaxEngine(jmodel, jp, **kw), prompts, passes)
    got, teng = _serve(TorchEngine(tmodel, tp, **kw), prompts, passes)
    assert got == want
    assert teng.batcher.metrics == jeng.batcher.metrics
    if mode == "paged+cache":
        assert teng.cache_stats == jeng.cache_stats


def test_moe_paged_decode_bit_identical_to_contiguous(bridged_moe):
    """Two prompts (one past the window) prefilled, then decoded in one
    batch through the contiguous cache and through the pool: the logits
    are equal bit for bit at every step."""
    _, _, model, params = bridged_moe
    _paged_decode_bit_identical(model, params, (75, 9),
                                model.cfg.sliding_window)


def _paged_decode_bit_identical(model, params, lens, cap, bs=8):
    """Prompts of ``lens`` tokens prefilled into a contiguous cache of
    ``cap`` slots and into the pool, then six greedy steps decoded in one
    batch through each: the logits are equal bit for bit at every step."""
    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, vocab, (1, n)) for n in lens]
    dense = model.init_cache(2, cap)
    pool = model.init_paged_cache(2, 2 * cap // bs + 1, bs)
    table = torch.arange(1, 2 * cap // bs + 1, dtype=torch.int32).reshape(
        2, -1)
    toks = []
    for i, p in enumerate(prompts):
        logits, one = model.prefill(params, {"tokens": torch.from_numpy(p)},
                                    cap)
        dense.k[:, i] = one.k[:, 0]
        dense.v[:, i] = one.v[:, 0]
        pool = model.insert_prefill_paged(pool, one, table[i], i)
        toks.append(int(torch.argmax(logits[0, -1])))
    tok = torch.tensor(toks)[:, None]
    pos = torch.tensor([p.shape[1] for p in prompts])
    for _ in range(6):
        want, dense = model.decode_step(params, tok, dense, pos)
        got, pool = model.decode_step_paged(params, tok, pool, table, pos)
        assert torch.equal(got, want)
        tok = torch.argmax(got[:, -1], dim=-1)[:, None]
        pos = pos + 1


def _steal_and_serve(engine_cls, model, params, prompts):
    """Victim exports two waiting requests; the thief serves them."""
    kw = dict(max_batch=2, s_max=48, block_size=8)
    victim, thief = engine_cls(model, params, **kw), \
        engine_cls(model, params, **kw)
    for eng in (victim, thief):
        eng.batcher.now = _clock()
    reqs = [victim.submit(p, max_new_tokens=4) for p in prompts]
    stolen = victim.export_waiting(count=2)
    for req, payload in stolen:
        thief.submit_request(req, payload)
    outs = {**victim.run_until_drained(), **thief.run_until_drained()}
    victim.alloc.check()
    thief.alloc.check()
    return [outs[r.rid] for r in reqs], [r.rid for r, _ in stolen], reqs


def test_steal_between_engines_matches_reference(bridged):
    jmodel, jp, tmodel, tp = bridged
    prompts = _prompts(jmodel.cfg.vocab_size, n=4, seed=5)
    want, jstolen, jreqs = _steal_and_serve(JaxEngine, jmodel, jp, prompts)
    got, tstolen, treqs = _steal_and_serve(TorchEngine, tmodel, tp, prompts)
    assert got == want
    assert [next(i for i, r in enumerate(treqs) if r.rid == rid)
            for rid in tstolen] == \
        [next(i for i, r in enumerate(jreqs) if r.rid == rid)
         for rid in jstolen]
    assert len(tstolen) == 2


def _plans(rs, seed=3):
    """Drive one seeded request stream through a batcher, executing plans
    the way the engine does; returns every plan as request indices."""
    rng = np.random.default_rng(seed)
    clock = _clock()
    b = rs.ContinuousBatcher(max_batch=3, prefill_token_budget=24,
                             now=clock, prefill_chunk=8)
    reqs = []
    for i in range(12):
        dl = 30.0 if i == 5 else None     # expires while waiting: pruned
        reqs.append(rs.Request(prompt_len=int(rng.integers(1, 30)),
                               max_new_tokens=int(rng.integers(1, 6)),
                               priority=float(rng.integers(0, 3)),
                               deadline=dl, arrival=float(i)))
    idx = {r.rid: i for i, r in enumerate(reqs)}
    plans = []
    for step in range(60):
        if step < len(reqs):
            b.submit(reqs[step])
        if step == 7:
            reqs[9].cancel()
        plan = b.plan_step()
        plans.append(([idx[r.rid] for r in plan.prefill],
                      [plan.prefill_chunks[r.rid] for r in plan.prefill],
                      [idx[r.rid] for r in plan.evicted],
                      [idx[r.rid] for r in plan.admitted],
                      sorted(idx[r.rid] for r in plan.decode)))
        b.complete_decode(plan.decode)
        for r in plan.prefill:
            if b.complete_prefill_chunk(r, plan.prefill_chunks[r.rid]):
                r.generated += 1
    return plans, b.metrics


def test_scheduler_copy_plans_match_reference():
    want, want_metrics = _plans(jrs)
    got, got_metrics = _plans(trs)
    assert got == want
    assert got_metrics == want_metrics
    assert want_metrics["evicted_dead"] >= 1
    assert want_metrics["prefill_chunks"] > 12     # long prompts chunked
