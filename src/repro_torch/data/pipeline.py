# Copied from src/repro/data/pipeline.py; only the imports may differ.
"""Deterministic synthetic data pipeline with checkpointable state.

Each host materializes only its own shard of every global batch (indexed by
``host_id``/``num_hosts``); the stream is a pure function of (seed, step),
so restarts resume exactly and elastic re-sharding (different num_hosts)
replays the same global token stream.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["SyntheticCorpus", "DataPipeline"]


class SyntheticCorpus:
    """Zipf-distributed tokens in lognormal-length documents — enough
    structure for loss curves to move and packing to matter."""

    def __init__(self, vocab_size: int, seed: int = 0,
                 mean_doc_len: float = 512.0):
        self.vocab_size = vocab_size
        self.seed = seed
        self.mean_doc_len = mean_doc_len

    def document(self, doc_id: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed << 32) ^ doc_id)
        ln = int(np.clip(rng.lognormal(np.log(self.mean_doc_len), 0.6),
                         8, 16 * self.mean_doc_len))
        # Zipf-ish via pareto ranks (bounded by vocab)
        ranks = rng.pareto(1.1, ln).astype(np.int64) % self.vocab_size
        return ranks

    def doc_lengths(self, first: int, count: int) -> np.ndarray:
        return np.array([len(self.document(i))
                         for i in range(first, first + count)])


@dataclass
class PipelineState:
    step: int = 0
    next_doc: int = 0

    def to_dict(self) -> Dict:
        return {"step": self.step, "next_doc": self.next_doc}

    @classmethod
    def from_dict(cls, d: Dict) -> "PipelineState":
        return cls(step=int(d["step"]), next_doc=int(d["next_doc"]))


class DataPipeline:
    """Yields {tokens, labels} host-shards of the global batch."""

    def __init__(self, corpus: SyntheticCorpus, global_batch: int,
                 seq_len: int, host_id: int = 0, num_hosts: int = 1,
                 state: Optional[PipelineState] = None):
        assert global_batch % num_hosts == 0
        self.corpus = corpus
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.state = state or PipelineState()

    @property
    def host_batch(self) -> int:
        return self.global_batch // self.num_hosts

    def _row(self, step: int, row: int) -> np.ndarray:
        """Row = concatenated docs, deterministic in (step, row)."""
        rng = np.random.default_rng(
            (self.corpus.seed << 40) ^ (step << 20) ^ row)
        out = np.empty(self.seq_len + 1, np.int64)
        filled = 0
        doc_id = int(rng.integers(0, 1 << 31))
        while filled <= self.seq_len:
            doc = self.corpus.document(doc_id)
            take = min(len(doc), self.seq_len + 1 - filled)
            out[filled:filled + take] = doc[:take]
            filled += take
            doc_id += 1
        return out

    def next_batch(self) -> Dict[str, np.ndarray]:
        step = self.state.step
        rows = [self._row(step, self.host_id * self.host_batch + r)
                for r in range(self.host_batch)]
        arr = np.stack(rows)
        self.state.step += 1
        return {"tokens": arr[:, :-1].astype(np.int32),
                "labels": arr[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()
