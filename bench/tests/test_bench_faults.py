"""The comparison fails what it must, at a tiny size on the CPU, under
each cell's own limits: the control (the reference computed in float8 in
the program's place), and a run of the harness, its look for a card
skipped, with the program broken underneath:

* a decode step that returns its state unchanged (the KV it computed is
  never written to the pool);
* half of the batch left out (the rows of the second half of the decode
  batch take the first row's logits);
* a token altered where it is produced (each decode row's best logit
  moved to the next token id).

The fourth fault, the exchange between chips left out, cannot happen in
these cells: each runs on one chip, with no collective.
"""
import json

import pytest
import torch

from bench.harness import compare, runner
from bench.harness.registry import load_cell
from bench.tests._tiny import (ROOT, TINY_DENSE, TINY_MIX, TINY_MOE, _dump,
                               add_cell, add_config, tiny_cell, tiny_tree)

#: each real cell, and its tiny twin: the same family at a size whose
#: rounding reads like the cell's (4096 tokens of vocabulary; the MoE twin
#: 8 layers of 8 experts, top-2)
TWINS = {"mixtral-8x22b-l8.chat": "twin-moe.chat"}
#: the planted faults run on the smallest cells of each family, at a rate
#: that keeps their four slots full (half the batch is then always in use,
#: as most of the real cell's 32 slots are: its sampled requests held slots
#: up to 18-31 on the H100)
SMALL = {"mixtral-8x22b-l8.chat": "tiny-moe.chat"}
FULL_RATE = 40.0
_SIZES = {"vocab_size": 4096, "hidden_size": 128, "intermediate_size": 256}
#: few requests with long outputs: some hundreds of served tokens at a load
#: a busy CPU still serves
_MIX = {**TINY_MIX, "name": "twinmix", "classes": [
    {**c, "prompt": {"dist": "uniform", "min": 16, "max": 128},
     "output": {"dist": "uniform", "min": 32, "max": 64}}
    for c in TINY_MIX["classes"]]}


def _compare(cell):
    path = ROOT / "bench" / "workloads" / f"{cell}.json"
    return json.loads(path.read_text())["compare"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tiny_tree(tmp_path_factory.mktemp("faults") / "checkout")
    add_config(root, dict(TINY_MOE, name="twin-moe", num_hidden_layers=8,
                          num_local_experts=8, **_SIZES))
    add_config(root, dict(TINY_DENSE, name="twin-dense", num_hidden_layers=4,
                          **_SIZES))
    _dump(root / "bench" / "traffic" / "twinmix.json", _MIX)
    for name in ("twin-moe", "twin-dense"):
        add_cell(root, tiny_cell(f"{name}.chat", name, traffic="twinmix",
                                 rate_per_s=2.0, compare={
                                     "served": 256, "limits": {}}))
    return root


def _tiny(tree, real, twins=TWINS):
    cell = load_cell(twins[real], tree)
    spec = _compare(real)
    cell.workload = dict(cell.workload, compare=dict(
        cell.workload["compare"], limits=spec["limits"],
        requests=spec.get("requests", 1)))
    return cell


def _stale(orig):
    from repro_torch.models.attention import PagedKVCache

    def step(params, token, cache, table, pos, cfg):
        scratch = PagedKVCache(cache.k.clone(), cache.v.clone())
        return orig(params, token, scratch, table, pos, cfg)[0], cache
    return step


def _half_batch(orig):
    def step(*args):
        logits, cache = orig(*args)
        logits = logits.clone()
        logits[logits.shape[0] // 2:] = logits[:1]
        return logits, cache
    return step


def _altered(orig):
    def step(*args):
        logits, cache = orig(*args)
        best = logits[:, -1].argmax(-1)
        logits = logits.clone()
        nxt = (best + 1) % logits.shape[-1]
        logits[torch.arange(len(best)), -1, nxt] = logits[:, -1].max(-1) \
            .values + 1.0
        return logits, cache
    return step


@pytest.mark.parametrize("real", list(TWINS))
def test_sound_run_is_correct(tree, real):
    out = runner.run_cell(_tiny(tree, real), 21, 4.0, False, "cpu",
                          log=lambda s: None)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [_stale, _half_batch, _altered])
@pytest.mark.parametrize("real", list(TWINS))
def test_fault_is_not_correct(tree, real, fault, monkeypatch):
    from repro_torch.models import transformer
    monkeypatch.setattr(transformer, "lm_decode_step_paged",
                        fault(transformer.lm_decode_step_paged))
    cell = _tiny(tree, real, SMALL)
    cell.workload = dict(cell.workload, rate_per_s=FULL_RATE)
    out = runner.run_cell(cell, 22, 2.0, False, "cpu", log=lambda s: None)
    assert all(c["value"] is not None for c in out["checks"].values())
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("real", list(TWINS))
def test_control_is_not_correct(tree, real):
    out = runner.run_cell(_tiny(tree, real), 23, 4.0, False, "cpu",
                          log=lambda s: None, control=True)
    assert out["numbers"]["served_tokens"] >= 200
    assert out["control"]["served_tokens"] == out["numbers"]["served_tokens"]
    assert not compare.judge(out["control"], _compare(real)["limits"])[0], \
        out["control"]


def test_sample_holds_enough_requests_and_the_upper_half():
    from bench.harness.openloop import ReqRecord
    from bench.harness.traffic import Arrival

    def req(i, prompt, n, slot):
        r = ReqRecord(Arrival(0.0, "c", 0.0, prompt, n, None), 0.0,
                      rid=i, max_new=n, n_out=n)
        r.slot = slot
        return r
    # the longest and most others in the lower half of 32 slots
    reqs = [req(0, 3000, 300, 0)] + [req(i, 100, 200, i % 8)
                                     for i in range(1, 40)] \
        + [req(40, 100, 20, 20)]
    for seed in range(20):
        s = compare.draw_sample(reqs, seed, 384, 8, 16)
        assert s[0].rid == 0 and len(s) == 8
        assert any(r.slot >= 16 for r in s)
        assert len({r.rid for r in s}) == len(s)
