"""Jamba's published equations on the port's serving path, on the CPU at a
tiny size in fp32: the port's hybrid with ``mamba_inner_norm`` and
``moe_renormalize=False`` (the two port-only fields the benchmark's hybrid
family sets) against the benchmark's plain reference
(``bench/reference/hybrid.py``, torch only) on the same seeded weights
(``bench/families/hybrid.py``'s tree and distributions); the chunked
hybrid prefill that carries each request's Mamba state, against the whole
prompt and through the engine; the engine's staged states; the router's
flag; the spans.

Two periods of four layers (attention at offset 2, MoE on every second
layer), d_model 64, 4 experts, d_conv 4, d_state 8, scan chunks of at most
5 (``models/ssm.py::_scan_chunk``: 4 over the prompt of 23, 2 over a
chunk of 7).
Tolerance: 1e-5 of the compared tensor's scale, max(1, max |reference|):
both sides compute in fp32 and sum the same products in other orders (the
port's chunked scan against the reference's loop over positions, the
engine's paged attention against the reference's dense one); they read
within 6e-6 of logits of ~5 here."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench.families import hybrid as family
from bench.harness.weights import make_weights
from repro_torch import trace
from repro_torch.configs import get_config
from repro_torch.core.device.moe_balance import route_topk
from repro_torch.kernels.moe_dispatch import moe_route
from repro_torch.models import build_model
from repro_torch.models.ssm import _scan_chunk
from repro_torch.serving import ServingEngine

ROOT = Path(__file__).resolve().parents[1]
RTOL_SCALE = 1e-5
PROMPT = 23            # divided neither by the chunks of 7 nor by its scan chunk
#: a chunk of 1, one under d_conv - 1 (the conv state keeps part of the
#: one passed in), and one that divides neither the prompt nor its scan chunk
CHUNKS = (1, 2, 7)


def _tiny_config() -> dict:
    cfg = json.loads((ROOT / "bench" / "configs" /
                      "jamba2-mini-l16.json").read_text())
    return dict(cfg, hidden_size=64, intermediate_size=96,
                num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                num_hidden_layers=8, vocab_size=128, num_experts=4,
                mamba_dt_rank=8, mamba_d_state=8, torch_dtype="float32",
                attn_layer_period=4, attn_layer_offset=2)


@pytest.fixture(scope="module")
def tiny():
    """(model, weights, sizes): the port's hybrid with the family's fields
    on the family's seeded weights."""
    conf = _tiny_config()
    kw = dict(family.port_fields(conf), ssm_chunk=5)
    cfg = get_config(conf["arch"]).replace(param_dtype=kw["dtype"],
                                           moe_dropless=True, **kw)
    assert cfg.mamba_inner_norm and not cfg.moe_renormalize
    sizes = family.sizes_of(conf)
    return build_model(cfg, "cpu"), make_weights(family, sizes, 3, "cpu"), \
        sizes


def _close(got, want):
    atol = RTOL_SCALE * max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, atol=atol, rtol=0)


def _tokens(n, seed=0):
    return np.random.default_rng(seed).integers(0, 128, n)


def test_forward_matches_plain_reference(tiny):
    model, w, sizes = tiny
    toks = torch.as_tensor(_tokens(40))
    got = model.forward(w, {"tokens": toks[None]}).logits[0]
    want = family.forward_logits(w, sizes, [toks], [0])[0]
    _close(got, want)


def _chunks(model, w, toks, chunk, block=8, s_max=32):
    """The prompt through ``prefill_chunk_paged`` in chunks of ``chunk``:
    (last logits, the carried state, the pool)."""
    cache = model.init_paged_cache(1, s_max // block + 1, block)
    row = torch.arange(1, s_max // block + 1)
    state = model.init_chunk_state()
    for start in range(0, toks.shape[1], chunk):
        logits, cache = model.prefill_chunk_paged(
            w, {"tokens": toks[:, start:start + chunk],
                "mamba_state": state}, cache, row, start)
    return logits, state, cache


@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_prefill_equals_whole_prompt(tiny, chunk):
    """The last logits and every Mamba layer's conv and h states of a
    prompt prefilled in chunks against the whole prompt's prefill."""
    model, w, _ = tiny
    toks = torch.as_tensor(_tokens(PROMPT))[None]
    whole, dense = model.prefill(w, {"tokens": toks}, 32)
    logits, state, _ = _chunks(model, w, toks, chunk)
    _close(logits, whole)
    _close(state.conv, dense.conv)
    _close(state.h, dense.h)


def _recording(eng) -> dict:
    """Record the logits of the engine's chunk calls (last position) and
    decode calls (every row)."""
    got = {"chunk": [], "decode": []}
    chunk, decode = eng._prefill_chunk, eng._decode

    def prefill_chunk(*args):
        logits, cache = chunk(*args)
        got["chunk"].append(logits[0, -1].clone())
        return logits, cache

    def step(*args):
        logits, cache = decode(*args)
        got["decode"].append(logits[:, -1].clone())
        return logits, cache
    eng._prefill_chunk, eng._decode = prefill_chunk, step
    return got


@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_prefill_then_decode_matches_reference(tiny, chunk):
    """One request through the paged engine in chunks of ``chunk``, then
    decode: the logits of its last chunk and of every decode step against
    the reference's full forward over the prompt and the tokens it
    emitted."""
    model, w, sizes = tiny
    eng = ServingEngine(model, w, kv_mode="paged", max_batch=1, s_max=32,
                        block_size=8, prefill_chunk=chunk,
                        prefill_token_budget=chunk)
    got = _recording(eng)
    prompt = _tokens(PROMPT, seed=1)
    req = eng.submit(prompt, 6)
    out = eng.run_until_drained()[req.rid]
    assert len(got["chunk"]) == -(-PROMPT // chunk) and len(out) == 6
    seq = torch.as_tensor(np.concatenate([prompt, out[:-1]]))
    want = family.forward_logits(w, sizes, [seq], [PROMPT - 1])[0]
    mine = torch.stack([got["chunk"][-1]] + [r[0] for r in got["decode"]])
    _close(mine, want)
    assert eng.io_stats["mamba_states_staged"] == 1
    assert eng.io_stats["mamba_states_committed"] == 1


def _engine(model, w, **kw):
    args = dict(kv_mode="paged", max_batch=2, s_max=32, block_size=8,
                prefill_chunk=4, prefill_token_budget=4)
    return ServingEngine(model, w, **dict(args, **kw))


def _drained(eng):
    assert not eng._staged and eng.io_stats["mamba_staged_bytes"] == 0
    eng.alloc.check()
    assert eng.alloc.num_requests == 0


def test_midprefill_request_leaves_decode_rows(tiny):
    """A request prefilling in chunks beside a decoding one: the decoding
    request's tokens are those it gets alone, and the prefilling one's are
    its own alone; each staged state is committed, none left."""
    model, w, _ = tiny
    a, b = _tokens(5, seed=2), _tokens(22, seed=3)
    alone = []
    for p in (a, b):
        eng = _engine(model, w)
        r = eng.submit(p, 10)
        alone.append(eng.run_until_drained()[r.rid])
    eng = _engine(model, w)
    ra = eng.submit(a, 10)
    eng.step()
    eng.step()
    rb = eng.submit(b, 10)
    midway = False
    while eng.batcher.waiting_count or any(eng.slot_req):
        eng.step()
        if rb.rid in eng._staged and eng.slot_req[0] is ra:
            midway = True       # a decode step ran with b's state staged
    assert midway
    assert [eng.outputs[ra.rid], eng.outputs[rb.rid]] == alone
    io = eng.io_stats
    assert io["mamba_states_staged"] == io["mamba_states_committed"] == 2
    _drained(eng)


def test_staged_state_freed_on_prune_and_preemption(tiny):
    """A request cancelled mid-prefill is pruned and its staged state
    freed; one preempted mid-prefill by a more urgent request for its
    blocks loses its staged state, restarts from chunk 0 and emits what it
    emits alone."""
    model, w, _ = tiny
    nbytes = sum(x.numel() * x.element_size()
                 for x in model.init_chunk_state())
    eng = _engine(model, w)
    r = eng.submit(_tokens(20, seed=4), 4)
    eng.step()
    assert r.prefilled == 4 and eng.io_stats["mamba_staged_bytes"] == nbytes
    r.cancel()
    eng.step()
    assert eng.batcher.metrics["evicted_dead"] == 1
    assert eng.io_stats["mamba_states_committed"] == 0
    _drained(eng)

    low, high = _tokens(12, seed=5), _tokens(10, seed=6)
    solo = _engine(model, w, max_batch=1, s_max=16, block_size=4)
    alone = solo.submit(low, 3)
    want = solo.run_until_drained()[alone.rid]
    eng = _engine(model, w, s_max=16, block_size=4, num_blocks=5)
    rb = eng.submit(low, 3, priority=2.0)
    eng.step()
    eng.step()
    assert rb.prefilled == 8 and eng.io_stats["mamba_staged_bytes"] == nbytes
    eng.submit(high, 3, priority=0.0)
    eng.run_until_drained()
    io = eng.io_stats
    assert eng.batcher.metrics["preempted"] == 1
    # b staged twice (its restart from chunk 0), the urgent request once
    assert io["mamba_states_staged"] == 3
    assert io["mamba_states_committed"] == 2
    assert eng.outputs[rb.rid] == want
    _drained(eng)


def test_hybrid_takes_no_prefix_cache(tiny):
    model, w, _ = tiny
    assert not model.supports_prefix_cache
    assert not model.supports_speculation
    assert not _engine(model, w, prefix_cache=True).prefix_cache


@pytest.mark.parametrize("renormalize", [True, False])
def test_moe_route_flag_equals_route_topk(renormalize):
    """``moe_route``'s plain form keeps or renormalises the top-k gates as
    ``route_topk`` does; without renormalising they are the softmax's own
    top-k probabilities, summing below 1."""
    logits = torch.randn(9, 16, generator=torch.Generator().manual_seed(0))
    r = moe_route(logits, 2, renormalize=renormalize)
    idx, gate, probs = route_topk(logits, 2, renormalize=renormalize)
    assert torch.equal(r.expert_idx, idx) and torch.equal(r.gate, gate)
    assert torch.equal(r.probs, probs)
    top = torch.gather(probs, 1, idx.long())
    if renormalize:
        torch.testing.assert_close(gate.sum(-1), torch.ones(9))
    else:
        assert torch.equal(gate, top) and bool((gate.sum(-1) < 1).all())


@pytest.mark.parametrize("t,cap,want", [(512, 64, 16), (3072, 64, 41),
                                        (8192, 64, 64), (23, 5, 4),
                                        (7, 5, 2), (1, 64, 1)])
def test_scan_chunk_issues_fewest_launches(t, cap, want):
    """The scan chunk ``mamba_fwd`` takes for ``t`` steps: of 1..cap the
    one with the fewest launches, 2 (c - 1) + ceil(t / c), the largest of
    equals."""
    def launches(c):
        return 2 * (c - 1) + -(-t // c)
    assert _scan_chunk(t, cap) == want
    assert launches(want) == min(launches(c) for c in range(1, cap + 1))


def test_spans_only_when_tracing(tiny):
    """Off, nothing is recorded; on, the hybrid's steps open the model's
    spans, each Mamba layer its own (inside the model's step; the scan
    inside ``mamba.prefill``) and the commit its span."""
    model, w, _ = tiny
    trace.take()
    eng = _engine(model, w)
    eng.submit(_tokens(9, seed=7), 3)
    eng.run_until_drained()
    assert trace.take() == []
    eng = _engine(model, w)
    eng.submit(_tokens(9, seed=7), 3)
    trace.enable()
    try:
        eng.run_until_drained()
    finally:
        trace.disable()
    spans = trace.take()
    names = [s.name for s in spans]
    assert set(names) <= set(trace.NAMES)
    for name in ("model.decode", "model.prefill_chunk", "model.unembed",
                 "mamba.decode", "mamba.prefill", "mamba.scan",
                 "hybrid.state_commit"):
        assert name in names, name
    parent = {s.name: spans[s.parent].name for s in spans
              if s.parent is not None}
    assert parent["mamba.prefill"] == "model.prefill_chunk"
    assert parent["mamba.decode"] == "model.decode"
    assert parent["mamba.scan"] == "mamba.prefill"
    # 6 Mamba layers a call: chunks of 4, 4 and 1, then 2 decode steps
    assert names.count("mamba.prefill") == 3 * 6
    assert names.count("mamba.decode") == 2 * 6
    assert {s.attrs["tokens"] for s in spans
            if s.name == "mamba.prefill"} == {4, 1}
