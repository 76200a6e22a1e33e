"""Strategy-weighted sequence packing: the PyTorch counterpart of
``repro/data/packing.py``.

Documents are tasks; their token counts are transitive weights.  Packing
rows greedily (first-fit-decreasing) fills fixed-length rows, and rows are
then assigned to data-parallel shards with the steal-half-work balancer
(``greedy_weighted_partition``) so every shard gets near-equal *work*, not
just an equal row count — mixed-length corpora otherwise leave stragglers,
which at pod scale means idle chips every step.  The balancer runs on a
CPU tensor: the rows' fill is host bookkeeping.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..core.device.weighted_partition import greedy_weighted_partition

__all__ = ["pack_documents", "packing_efficiency"]


def pack_documents(doc_lengths: Sequence[int], seq_len: int,
                   num_shards: int = 1):
    """Pack docs (given by length) into rows of ``seq_len`` tokens.

    Returns (rows, shard_of_row): rows is a list of lists of doc indices;
    docs longer than seq_len are split into seq_len pieces beforehand.
    """
    pieces: List[Tuple[int, int]] = []   # (doc_id, length)
    for i, ln in enumerate(doc_lengths):
        ln = int(ln)
        while ln > seq_len:
            pieces.append((i, seq_len))
            ln -= seq_len
        if ln > 0:
            pieces.append((i, ln))
    # first-fit-decreasing
    order = sorted(range(len(pieces)), key=lambda j: -pieces[j][1])
    rows: List[List[int]] = []
    row_free: List[int] = []
    row_docs: List[List[Tuple[int, int]]] = []
    for j in order:
        doc, ln = pieces[j]
        placed = False
        for r in range(len(rows)):
            if row_free[r] >= ln:
                row_docs[r].append((doc, ln))
                row_free[r] -= ln
                placed = True
                break
        if not placed:
            row_docs.append([(doc, ln)])
            row_free.append(seq_len - ln)
            rows.append([])
    # shard rows by *work* (= filled tokens): steal-half-work assignment
    fill = np.array([seq_len - f for f in row_free], np.float64)
    if num_shards > 1 and len(fill):
        shard = greedy_weighted_partition(
            torch.as_tensor(fill, dtype=torch.float32), num_shards).numpy()
    else:
        shard = np.zeros(len(fill), np.int32)
    return row_docs, shard


def packing_efficiency(row_docs, seq_len: int) -> float:
    if not row_docs:
        return 1.0
    filled = sum(ln for row in row_docs for _, ln in row)
    return filled / (len(row_docs) * seq_len)
