"""The port's span recorder (``repro_torch.trace``) and the engine's
``io_stats`` on a tiny paged Mixtral-family engine with chunked prefill:
tracing off records nothing and changes no token or count, on it records
the step's tree of spans, the counters match a hand count, the spans reach
a running profiler, and a wrapper on ``moe.grouped_swiglu`` still sees
every call."""
import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.configs import get_config, scale_down
from repro_torch.models import build_model, moe
from repro_torch.serving import ServingEngine


@pytest.fixture(autouse=True)
def _tracing_off():
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


@pytest.fixture(scope="module")
def tiny():
    cfg = scale_down(get_config("mixtral-8x22b")).replace(
        dtype="float32", param_dtype="float32")
    model = build_model(cfg, "cpu")
    return model, model.init(0)


def _engine(model, params):
    """Two requests: A (12 tokens, 3 new, priority 0) and B (4 tokens, 2
    new); one 8-token chunk of budget a step, blocks of 8, a ring of 64."""
    eng = ServingEngine(model, params, max_batch=2, s_max=64, block_size=8,
                        prefill_chunk=8, prefill_token_budget=8,
                        kv_mode="paged")
    rng = np.random.default_rng(0)
    vocab = model.cfg.vocab_size
    eng.reqs = [eng.submit(rng.integers(0, vocab, 12), 3, priority=0.0),
                eng.submit(rng.integers(0, vocab, 4), 2, priority=1.0)]
    return eng


def _steps(eng):
    """Each step's spans (tracing as it is set)."""
    out = []
    for _ in range(10):
        eng.step()
        out.append(trace.take())
    return out


def test_off_records_nothing_and_changes_nothing(tiny):
    assert trace.span("engine.step") is trace.span("moe.route")
    off = _engine(*tiny)
    assert not any(_steps(off))
    trace.enable()
    on = _engine(*tiny)
    spans = _steps(on)
    assert sum(map(len, spans)) > 0
    assert list(on.outputs.values()) == list(off.outputs.values())
    assert [len(v) for v in off.outputs.values()] == [3, 2]
    assert on.batcher.metrics == off.batcher.metrics
    assert on.io_stats == off.io_stats


def _children(spans, i):
    return [s.name for s in spans if s.parent == i]


def test_a_step_gives_the_tree(tiny):
    eng = _engine(*tiny)
    eng.step()                      # A's first chunk
    trace.enable()
    eng.step()                      # A's last chunk, B whole, both decoded
    trace.disable()
    spans = trace.take()
    assert {s.name for s in spans} <= set(trace.NAMES)
    assert spans[0].name == "engine.step" and spans[0].parent is None
    assert spans[0].attrs == {"decoded": 2, "prefill_tokens": 8}
    assert all(s.parent is not None for s in spans[1:])
    for s in spans:
        assert s.start <= s.end
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start <= s.start and s.end <= p.end
    top = _children(spans, 0)
    assert top == ["engine.plan", "engine.prefill", "engine.prefill",
                   "engine.kv_blocks", "engine.upload", "engine.upload",
                   "engine.upload", "model.decode", "engine.read",
                   "engine.emit"]
    layers = eng.model.cfg.num_layers
    attn = ["attn.qkv", "attn.kv_write", "attn.gather", "attn.core",
            "attn.out"]
    ffn = ["moe.route", "moe.dispatch", "moe.experts", "moe.combine"]
    prefills = [i for i, s in enumerate(spans) if s.name == "engine.prefill"]
    a, b = (r.rid for r in eng.reqs)
    assert [spans[i].attrs for i in prefills] == [
        {"rid": a, "start": 8, "tokens": 4},
        {"rid": b, "start": 0, "tokens": 4}]
    for i in prefills:
        assert _children(spans, i) == ["engine.upload", "engine.upload",
                                       "model.prefill_chunk", "engine.read"]
    models = [i for i, s in enumerate(spans) if s.name.startswith("model.")
              and s.name != "model.unembed"]
    assert [spans[i].name for i in models] == [
        "model.prefill_chunk", "model.prefill_chunk", "model.decode"]
    assert spans[models[2]].parent == 0
    for i in models:
        assert _children(spans, i) == (attn + ffn) * layers \
            + ["model.unembed"]
    gathers = [s for s in spans if s.name == "attn.gather"]
    # decode: 2 rows x 64 positions of K and V; a chunk: 1 row
    kv = eng.model.cfg.num_kv_heads * eng.model.cfg.resolved_head_dim * 4
    assert [g.attrs["bytes"] for g in gathers] == \
        [2 * 64 * kv] * (2 * layers) + [2 * 2 * 64 * kv] * layers
    uploads = [s.attrs["bytes"] for s in spans if s.name == "engine.upload"]
    assert uploads == [32, 32, 32, 32, 16, 16, 64]


def test_io_stats_hand_count(tiny):
    eng = _engine(*tiny)
    eng.run_until_drained()
    # step 1: A's chunk 0-8: 8 int64 tokens (64 B) and A's table row of 8
    #   int32 blocks (32 B);
    # step 2: A's chunk 8-12 (32 + 32 B) and its first token read; B whole
    #   (32 + 32 B) and read; decode of 2 rows: positions and last tokens
    #   (16 + 16 B), the table, dirty (2 x 8 int32, 64 B), and the argmax
    #   read; live KV: A at 12 (13 tokens), B at 4 (5), of 2 x 64;
    # step 3: B is done; A decoded alone at 13 (14 live), the table dirty
    #   again (B's row cleared): 16 + 16 + 64 B and a read.
    assert eng.io_stats == {"h2d_copies": 12, "h2d_bytes": 416,
                            "d2h_reads": 4, "kv_live_tokens": 32,
                            "kv_view_tokens": 256}
    assert [len(v) for v in eng.outputs.values()] == [3, 2]


def test_spans_reach_the_profiler(tiny):
    from torch.profiler import ProfilerActivity, profile
    eng = _engine(*tiny)
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.step()
        eng.step()
    recorded = {s.name for s in trace.take()}
    seen = {e.name for e in prof.events()}
    assert len(recorded) > 15
    assert recorded <= seen
    # without a profiler the recorder opens no profiler range
    assert not torch.autograd._profiler_enabled()


def test_grouped_swiglu_wrapper_sees_every_call(tiny, monkeypatch):
    model, params = tiny
    model = build_model(model.cfg.replace(use_flash=True), "cpu")
    calls = []
    orig = moe.grouped_swiglu

    def grouped_swiglu(x, w_gate, w_up, w_down, load=None):
        calls.append(tuple(x.shape))
        return orig(x, w_gate, w_up, w_down, load)

    monkeypatch.setattr(moe, "grouped_swiglu", grouped_swiglu)
    eng = _engine(model, params)
    trace.enable()
    eng.run_until_drained()
    spans = trace.take()
    experts = [s for s in spans if s.name == "moe.experts"]
    assert len(calls) == len(experts) > 0
    models = [s for s in spans if s.name.startswith("model.")
              and s.name != "model.unembed"]
    assert len(experts) == len(models) * model.cfg.num_layers
