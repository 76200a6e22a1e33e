"""The one traffic generator: open-loop arrivals of request classes, read
from a mix's data file (``bench/traffic/<mix>.json``).

A mix lists classes.  Each class has a share of the requests, a priority
(lower is more urgent), an arrival process and two length distributions:

* ``"arrival": {"process": "poisson"}``: requests arrive one at a time;
* ``"arrival": {"process": "burst", "size": n}``: requests arrive ``n`` at
  a time, the bursts Poisson-spaced;
* lengths: ``{"dist": "lognormal", "median", "sigma", "min", "max"}``,
  ``{"dist": "uniform", "min", "max"}`` (whole numbers, both ends in) or
  ``{"dist": "loguniform", "min", "max"}``.

The seed draws the arrivals and the lengths' order, and the work stays
the same: the run is cut into segments (the lead-in, the window, the tail
after it) and each segment into blocks of ``block_s`` seconds (the mix's
key; 5 s where it has none).  In each block and class the mix's own
``base_seed`` fixes how many requests arrive and the multiset of their
lengths; the run's seed draws their arrival times, uniform in the block
(a Poisson process given its count), which request of the block takes
which lengths, and the tokens.  So every seed offers the same requests in
every block, at other times and in another order.  (On one H100, lengths
permuted over whole segments spread the longdoc cell's time to first
token by 29 % over six seeds, against ~1 % between two runs of one seed:
blocks keep each few seconds' load the same.)

Frozen copy: the distributions follow ``bench/traffic`` as written against
the port at commit 55bfaa9; later changes to the program do not change it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["Arrival", "schedule", "draw_length"]

#: the blocks' length where the mix gives none (seconds)
BLOCK_S = 5.0


@dataclass
class Arrival:
    due: float          # seconds after the traffic's start
    cls: str
    priority: float
    prompt_len: int
    max_new: int
    tokens: np.ndarray  # int32 [prompt_len]


def draw_length(rng: np.random.Generator, spec: dict, n: int) -> np.ndarray:
    lo, hi = int(spec["min"]), int(spec["max"])
    kind = spec["dist"]
    if kind == "lognormal":
        x = spec["median"] * np.exp(spec["sigma"] * rng.standard_normal(n))
    elif kind == "uniform":
        x = rng.integers(lo, hi + 1, n)
    elif kind == "loguniform":
        x = np.exp(rng.uniform(np.log(lo), np.log(hi + 1), n))
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return np.clip(np.floor(x), lo, hi).astype(np.int64)


def _blocks(start: float, end: float, block: float):
    edges = list(np.arange(start, end, block)) + [end]
    return list(zip(edges, edges[1:]))


def schedule(mix: dict, rate: float, segments: Sequence[Tuple[float, float]],
             seed: int, vocab: int) -> List[Arrival]:
    """Every request of ``mix`` at ``rate`` requests a second (all classes
    together) over ``segments``, sorted by due time."""
    run = np.random.default_rng(int(seed))
    block_s = float(mix.get("block_s", BLOCK_S))
    out: List[Arrival] = []
    for s, (start, end) in enumerate(segments):
        for b, (lo, hi) in enumerate(_blocks(start, end, block_s)):
            for c, cls in enumerate(mix["classes"]):
                base = np.random.default_rng([int(mix["base_seed"]), s, b, c])
                arrival = cls.get("arrival", {"process": "poisson"})
                if arrival["process"] not in ("poisson", "burst"):
                    raise ValueError(f"unknown arrival process "
                                     f"{arrival['process']!r}")
                size = int(arrival.get("size", 1)) \
                    if arrival["process"] == "burst" else 1
                events = int(base.poisson(rate * cls["share"] / size
                                          * (hi - lo)))
                n = events * size
                prompts = draw_length(base, cls["prompt"], n)
                outputs = draw_length(base, cls["output"], n)
                times = np.repeat(run.uniform(lo, hi, events), size)
                order = run.permutation(n)
                for i in range(n):
                    out.append(Arrival(float(times[i]), cls["name"],
                                       float(cls["priority"]),
                                       int(prompts[order[i]]),
                                       int(outputs[order[i]]), None))
    out.sort(key=lambda a: a.due)
    for a in out:
        a.tokens = run.integers(0, vocab, a.prompt_len, dtype=np.int32)
    return out
