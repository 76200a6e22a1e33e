"""One run of one cell: set-up, lead-in, window, drain, the comparison
that decides ``correct``, the metrics, and the result's last line.

Set-up (``setup_s``) runs from the process's start until the window
opens: imports, the weights made on the device from the seed, the engine
and its KV pool, a warm-up request through the chunk and decode paths, and
the lead-in of the cell's own traffic.  Everything of the architecture
(its sizes, weights, reference and counts) comes from the cell's family.
"""
from __future__ import annotations

import gc
import os
import sys
import time
from collections import deque
from typing import Optional

import torch

from . import compare
from .openloop import Records, drive
from .registry import Cell
from .traffic import schedule
from .weights import make_weights

__all__ = ["port_config", "setup", "serve",
           "release", "run_cell", "process_start", "foreign_modules",
           "FORBIDDEN"]

#: how long a traced run's drain waits for the first tokens of the
#: window's requests before its slices begin regardless (seconds)
FIRST_WAIT_S = 10.0

#: top-level module names that may not be loaded once the window closes:
#: JAX and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

def process_start() -> float:
    """The process's start on the monotonic clock (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.monotonic() - (uptime - start_ticks
                               / os.sysconf("SC_CLK_TCK"))


def foreign_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def port_config(family, config: dict):
    """The port's ``ModelConfig`` for the file: its registered
    architecture with every field the family reads from the file, the
    hand-written kernels on, dropless MoE dispatch (every token to its k
    experts)."""
    from repro_torch.configs import get_config
    kw = family.port_fields(config)
    kw["param_dtype"] = kw["dtype"]
    return get_config(config["arch"]).replace(use_flash=True,
                                              moe_dropless=True, **kw)


def _warm_up(eng, settings: dict, vocab: int) -> None:
    """One request through two chunks and a few decode steps: loads (and
    in a fresh checkout builds) the kernels before the lead-in."""
    n = (settings.get("prefill_chunk") or 64) + 17
    eng.submit(torch.randint(0, vocab, (n,)).numpy(), 3)
    eng.run_until_drained()


def _synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def serve(cell: Cell, model, weights, sizes: dict, seed: int,
          seconds: float, trace: bool, lead: float, cap: float):
    """Lead-in, window and drain of the cell's traffic through a fresh
    engine.  Returns (records, engine)."""
    w = cell.workload
    dev = model.device
    t_engine = time.monotonic()
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(model, weights, kv_mode="paged", **w["engine"])
    _synchronize(dev)
    t_warm = time.monotonic()
    _warm_up(eng, w["engine"], sizes["vocab_size"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    segments = [(0.0, lead), (lead, lead + seconds),
                (lead + seconds, lead + seconds + cap)]
    arrivals = deque(schedule(cell.traffic, float(w["rate_per_s"]),
                              segments, seed, sizes["vocab_size"]))
    rec = Records(sizes=sizes)
    tracer = step = None
    _synchronize(dev)
    rec.t0 = time.monotonic()
    rec.marks = {"engine": t_engine, "warm_up": t_warm, "lead_in": rec.t0}
    rec.window_open = rec.t0 + lead
    rec.window_close = rec.window_open + seconds
    if trace:
        from .tracing import Tracer
        tracer = Tracer(eng, rec, cell.family, sizes, start=None,
                        slices=[("span", float(w["span_s"])),
                                ("a", float(w["profile_a_s"])),
                                ("b", float(w["profile_b_s"])),
                                ("program", float(w["program_span_s"]))])
        step = tracer.step
    window = None       # the window's requests, once it has closed

    def tick(now: float) -> None:
        # the slices run in the drain, where traffic still arrives, once
        # every request due in the window has its first token (or after
        # ``FIRST_WAIT_S``): the window itself runs as an untraced run does
        if tracer is None:
            return
        if tracer.start is None and window is not None and (
                now >= rec.window_close + FIRST_WAIT_S
                or all(r.first is not None for r in window)):
            tracer.start = rec.traced_from = now
        tracer.on_tick(now)

    drive(eng, arrivals, rec, stop_at=rec.window_open, step=step,
          on_tick=tick)
    drive(eng, arrivals, rec, stop_at=rec.window_close, step=step,
          on_tick=tick)
    rec.waiting_at_close = eng.batcher.waiting_count
    window = [r for r in rec.window_requests() if not r.rejected]
    drive(eng, arrivals, rec, stop_at=rec.window_close + cap,
          until=lambda: all(r.done for r in window) and (
              tracer is None or tracer.finished),
          step=step, on_tick=tick)
    rec.end = time.monotonic()
    if tracer is not None:
        tracer.finish()
    _synchronize(dev)
    return rec, eng


def setup(cell: Cell, seed: int, device: str):
    """(model, weights, sizes) of the cell, the weights from ``seed``."""
    from repro_torch.models import build_model
    sizes = cell.family.sizes_of(cell.config)
    model = build_model(port_config(cell.family, cell.config), device)
    torch.manual_seed(int(seed) % (1 << 63))
    return model, make_weights(cell.family, sizes, seed, model.device), \
        sizes


def release() -> None:
    """Return the memory of dropped objects (an engine's KV pool) to the
    device."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             log=print, control: bool = False) -> dict:
    """One run; returns the result object of the last line, with every
    number of the comparison under ``numbers`` and, with ``control``, the
    control's under ``control`` (which a run of the benchmark leaves
    out)."""
    t_start = process_start() if t_start is None else t_start
    w = cell.workload
    t_setup = time.monotonic()
    model, weights, sizes = setup(cell, seed, device)
    dev = model.device
    _synchronize(dev)
    rec, eng = serve(cell, model, weights, sizes, seed, seconds, trace,
                     float(w["lead_in_s"]), float(w["drain_cap_s"]))
    rec.setup_s = rec.window_open - t_start
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    # the comparison, once the program's state is freed
    window = rec.window_requests()
    spec = w["compare"]
    sample = compare.draw_sample(window, seed, int(spec["served"]),
                                 int(spec.get("requests", 1)),
                                 int(w["engine"]["max_batch"]) // 2)
    outputs = eng.outputs
    del eng
    release()
    found = ctrl = {}
    if sample:
        seqs, rows, served = compare.reference_inputs(sample, outputs, dev)
        ref = cell.family.forward_logits(weights, sizes, seqs, rows)
        found = compare.gap_numbers(ref, served)
        if control:
            ctrl = compare.control_numbers(cell.family, weights, sizes,
                                           seqs, rows, ref)
        del ref
    correct, checks = compare.judge(found, spec["limits"])

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.read(rec)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    failed = sum(1 for r in window if not r.done)
    by_class = {}
    for r in window:
        c = by_class.setdefault(r.arrival.cls, [0, 0])
        c[0] += 1
        c[1] += r.done
    lag = sorted(r.submitted - r.due for r in rec.requests
                 if r.submitted is not None)
    m = dict(start=t_start, weights=t_setup, **rec.marks,
             window=rec.window_open)
    keys = list(m)
    log("set-up (s): " + ", ".join(
        f"{a} {m[b] - m[a]:.3f}" for a, b in zip(keys, keys[1:])))
    log(f"requests in the window by class (due, done): {by_class}; "
        f"generator lag p50 {lag[len(lag) // 2] if lag else 0:.6f} s, "
        f"max {lag[-1] if lag else 0:.6f} s; steps {len(rec.steps)}; "
        f"memory peak {peak} bytes; sample {len(sample)} requests "
        f"(highest slot {max((r.slot for r in sample), default=-1)}), "
        f"{found.get('served_tokens', 0)} served tokens")
    # last, once the reference, the control and the metric readers (the
    # family's and the readers' files among them) have run
    foreign = foreign_modules()
    if foreign:
        raise SystemExit(f"modules of JAX or the JAX package loaded: "
                         f"{', '.join(foreign)}")
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": len(window), "failed": failed,
           "metrics": metrics, "device": device_info}
    prof = rec.profile
    if trace and prof:
        device_info["busy_s"] = prof["busy_s"]
        device_info["window_s"] = prof["window_s"]
        out["breakdown"] = {"device_ops": prof["device_ops"],
                            "idle_gaps": prof.get("idle_gaps", [])}
    out["numbers"] = found
    if control:
        out["control"] = ctrl
    out["checks"] = checks
    return out
