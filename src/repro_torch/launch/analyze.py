"""Whole-step cost from small traced variants.

The PyTorch counterpart of ``repro/launch/analyze.py``.  The reference
compiles small unrolled variants because ``cost_analysis()`` does not
multiply loop bodies by their trip counts.  The port traces every layer of
a step in Python, so a full trace already counts every layer; but a full
trace of a deep model at 32k tokens runs for minutes, and the same linear
model gives the whole step from two or four short traces, exactly for a
homogeneous stack:

    cost(L, µ) = f0 + fl·L  +  µ · (g0 + gl·L)

where L counts layer-periods (a Jamba superblock is one period), µ is the
gradient-accumulation factor, f is per-step-fixed (optimizer update,
embedding tables...) and g is per-microbatch (fwd+bwd).  Four traces pin
the four coefficients:

    A = cost(1 period, µ=1)     B = cost(2 periods, µ=1)
    C = cost(1 period, µ=2)     D = cost(2 periods, µ=2)

Serve steps have no µ: two traces (A, B) suffice.  Every number comes from
``hlo_stats.TraceCounter`` over those traces — no hand FLOP counting.  The
remat recompute is included (the backward of a checkpointed layer runs its
forward again).
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

from ..configs.base import ModelConfig
from .input_specs import ShapeCell, train_microbatches

__all__ = ["analyze_cell", "model_flops"]

_ANALYSIS_CHUNK = 1024     # coarser SSM chunking for the short traces


def _layer_period(cfg: ModelConfig) -> int:
    return cfg.attn_every or 1


def _with_periods(cfg: ModelConfig, periods: int, seq: int) -> ModelConfig:
    period = _layer_period(cfg)
    kw = dict(num_layers=periods * period, unroll_scans=True,
              ssm_chunk=min(_ANALYSIS_CHUNK, seq))
    if cfg.num_encoder_layers:
        kw["num_encoder_layers"] = periods * period
    return cfg.replace(**kw)


def _cost_of(record: Dict) -> Dict[str, float]:
    coll = record["collective_bytes"]
    return {"flops": record["flops"],
            "bytes": record["bytes_accessed"],
            "coll_bytes": float(coll["total"]),
            "coll_detail": coll}


def _compile_cost(cfg: ModelConfig, cell: ShapeCell, mesh,
                  batch_rows: int, n_micro: int,
                  fsdp: Optional[Tuple[str, ...]],
                  layout: str = "tp") -> Dict[str, float]:
    """One traced point (the reference compiles it; nothing is compiled
    here)."""
    from .dryrun import build_step, trace_step
    fn, args = build_step(cfg, cell, mesh, fsdp, layout, batch_rows,
                          n_micro)
    return _cost_of(trace_step(fn, args))


def analyze_cell(cfg: ModelConfig, cell: ShapeCell, mesh,
                 fsdp: Optional[Tuple[str, ...]],
                 n_micro: Optional[int] = None,
                 layout: str = "tp") -> Dict:
    """Extrapolated whole-step cost for (cfg, cell) on ``mesh`` (a mesh of
    the running fake world)."""
    t0 = time.time()
    period = _layer_period(cfg)
    n_periods = cfg.num_layers // period
    assert n_periods >= 1

    if cell.kind == "train":
        n_micro = n_micro or train_microbatches(cfg, cell)
        rows_per_micro = max(1, cell.global_batch // n_micro)
        a = _compile_cost(_with_periods(cfg, 1, cell.seq_len), cell, mesh,
                          rows_per_micro, 1, fsdp, layout)
        b = _compile_cost(_with_periods(cfg, 2, cell.seq_len), cell, mesh,
                          rows_per_micro, 1, fsdp, layout)
        c = _compile_cost(_with_periods(cfg, 1, cell.seq_len), cell, mesh,
                          2 * rows_per_micro, 2, fsdp, layout)
        d = _compile_cost(_with_periods(cfg, 2, cell.seq_len), cell, mesh,
                          2 * rows_per_micro, 2, fsdp, layout)
        total = {}
        for k in ("flops", "bytes", "coll_bytes"):
            gl = d[k] - b[k] - c[k] + a[k]
            g0 = c[k] - a[k] - gl
            fl = b[k] - a[k] - gl
            f0 = a[k] - fl - g0 - gl
            # clamp: whole-step cost can never be below the 1-period point
            total[k] = max(f0 + fl * n_periods
                           + n_micro * (g0 + gl * n_periods), a[k], 0.0)
        detail = {"A": a, "B": b, "C": c, "D": d,
                  "n_micro": n_micro, "rows_per_micro": rows_per_micro}
    else:
        a = _compile_cost(_with_periods(cfg, 1, cell.seq_len), cell, mesh,
                          cell.global_batch, 1, fsdp, layout)
        b = _compile_cost(_with_periods(cfg, 2, cell.seq_len), cell, mesh,
                          cell.global_batch, 1, fsdp, layout)
        total = {}
        for k in ("flops", "bytes", "coll_bytes"):
            per = b[k] - a[k]
            total[k] = max(a[k] - per + per * n_periods, a[k], 0.0)
        detail = {"A": a, "B": b}
    total["analysis_s"] = round(time.time() - t0, 1)
    total["collective_kinds"] = {
        k: v for k, v in detail["A"]["coll_detail"].items()
        if k != "total" and v > 0}
    return {"extrapolated": total, "points": {
        k: {kk: vv for kk, vv in v.items() if kk != "coll_detail"}
        for k, v in detail.items() if isinstance(v, dict)},
        "n_micro": detail.get("n_micro", 1)}


def model_flops(cfg: ModelConfig, cell: ShapeCell) -> float:
    """MODEL_FLOPS = 6·N_active·D for train, 2·N_active·D for inference —
    the 'useful work' yardstick for the traced-FLOPs ratio."""
    # active params per token (matmul params only, embeddings excluded)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    attn = d * hd * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)
    period = _layer_period(cfg) or 1
    n_attn_per_period = 1 if cfg.attn_every else period
    n_mamba = (period - 1) if cfg.attn_every else 0
    di, ds = cfg.mamba_d_inner, cfg.mamba_d_state
    mamba = (d * 2 * di + di * (cfg.resolved_dt_rank + 2 * ds)
             + cfg.resolved_dt_rank * di + di * ds + di * d)
    if cfg.family == "ssm":                      # rwkv6
        attn = 5 * d * d                          # r,k,v,g,o projections
        n_attn_per_period, n_mamba = 1, 0
    if cfg.num_experts:
        ff_active = 3 * d * cfg.resolved_moe_d_ff * cfg.num_experts_per_tok
        n_moe = period // cfg.moe_layer_period
        n_dense_ff = period - n_moe if cfg.attn_every else 0
        ff = ff_active * n_moe + 3 * d * cfg.d_ff * n_dense_ff
    else:
        ff = 3 * d * cfg.d_ff * period
    per_period = attn * n_attn_per_period + mamba * n_mamba + ff
    n_periods = cfg.num_layers // period
    n_active = per_period * n_periods + d * cfg.vocab_size  # + lm head
    if cfg.num_encoder_layers:
        n_active += (attn * 2 + 3 * d * cfg.d_ff) * cfg.num_encoder_layers
    seq = cell.seq_len
    if cfg.num_encoder_layers:
        seq = seq // 2        # half source (encoder), half target tokens
    head = d * cfg.vocab_size
    trunk = n_active - head
    if cell.kind == "train":
        tokens = seq * cell.global_batch
        return 6.0 * n_active * tokens
    if cell.kind == "prefill":
        tokens = seq * cell.global_batch
        # the head only runs at the last position during prefill
        return 2.0 * (trunk * tokens + head * cell.global_batch)
    return 2.0 * n_active * cell.global_batch    # decode: 1 token/seq
