"""The traffic generator: deterministic per seed; every seed the same
requests in another order; class shares, rates and bursts within sampling
error."""
import json
from collections import Counter

import numpy as np
import pytest

from bench.harness.registry import BENCH_DIR
from bench.harness.traffic import draw_length, schedule

MIXES = ("chat", "longdoc")
SEGMENTS = [(0.0, 10.0), (10.0, 55.0), (55.0, 95.0)]


def _mix(name):
    return json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())


def _key(a):
    return (a.cls, a.priority, a.prompt_len, a.max_new)


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_schedule(mix):
    one = schedule(_mix(mix), 3.0, SEGMENTS, 2**31 + 11, 32768)
    two = schedule(_mix(mix), 3.0, SEGMENTS, 2**31 + 11, 32768)
    assert [(a.due, _key(a)) for a in one] == [(a.due, _key(a)) for a in two]
    assert all(np.array_equal(a.tokens, b.tokens) for a, b in zip(one, two))
    assert all(a.tokens.dtype == np.int32 and len(a.tokens) == a.prompt_len
               and a.tokens.min() >= 0 and a.tokens.max() < 32768
               for a in one)


def _blocks(arrivals, block):
    """The requests of each block of each segment, as a multiset."""
    out = Counter()
    for a in arrivals:
        s = next(i for i, (lo, hi) in enumerate(SEGMENTS) if lo <= a.due < hi)
        out[(s, int((a.due - SEGMENTS[s][0]) // block), _key(a))] += 1
    return out


@pytest.mark.parametrize("mix", MIXES)
def test_seeds_keep_the_work_and_draw_the_trace(mix):
    m = _mix(mix)
    block = m.get("block_s", 5.0)
    a = schedule(m, 3.0, SEGMENTS, 1, 32768)
    b = schedule(m, 3.0, SEGMENTS, 2**31 + 2, 32768)
    # the same requests in every block of every segment ...
    assert _blocks(a, block) == _blocks(b, block)
    # ... at other times and in another order
    assert len({x.due for x in a} & {x.due for x in b}) == 0
    assert [_key(x) for x in a] != [_key(x) for x in b]
    assert not any(np.array_equal(x.tokens, y.tokens) for x, y in zip(a, b))


@pytest.mark.parametrize("mix", MIXES)
def test_shares_and_rate(mix):
    m = _mix(mix)
    rate, horizon = 4.0, 3000.0
    arr = schedule(m, rate, [(0.0, horizon)], 7, 32768)
    by = Counter(a.cls for a in arr)
    for cls in m["classes"]:
        size = cls["arrival"].get("size", 1)
        events = rate * cls["share"] / size * horizon
        assert abs(by[cls["name"]] / size - events) < 4 * events ** 0.5
    n = len(arr)
    assert abs(n - rate * horizon) < 4 * (rate * horizon * 2) ** 0.5
    assert all(0 <= a.due < horizon for a in arr)
    assert [a.due for a in arr] == sorted(a.due for a in arr)


def test_documents_arrive_in_bursts_of_four():
    arr = schedule(_mix("longdoc"), 3.0, SEGMENTS, 5, 32768)
    docs = Counter(a.due for a in arr if a.cls == "document")
    assert docs and set(docs.values()) == {4}


@pytest.mark.parametrize("mix", MIXES)
def test_lengths_within_bounds(mix):
    m = _mix(mix)
    rng = np.random.default_rng(0)
    for cls in m["classes"]:
        for key in ("prompt", "output"):
            spec = cls[key]
            x = draw_length(rng, spec, 20000)
            assert x.min() >= spec["min"] and x.max() <= spec["max"]
            if spec["dist"] == "lognormal":
                assert abs(np.median(x) / spec["median"] - 1) < 0.05
            if spec["dist"] == "loguniform":
                mid = (spec["min"] * spec["max"]) ** 0.5
                assert abs(np.median(x) / mid - 1) < 0.05
