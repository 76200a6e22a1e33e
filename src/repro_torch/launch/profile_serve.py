"""Where the serving path's time goes on the card: ``torch.profiler`` over
(a) a window of decode steps of the serving engine with every slot busy
(the paged engine, or the contiguous one for a family without a paged
path, such as RWKV-6) and (b) whole-prompt prefills, for a full-width model
with random weights at the serving shape of ``chip_smoke.py``'s main paths.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --out build/profile.json
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch mixtral-8x22b --layers 8 --out build/profile_mixtral.json
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch rwkv6-3b --out build/profile_rwkv.json

``--layers`` cuts the depth (the widths stay as published): full
Mixtral-8x22B needs ~281 GB, so one card holds 8 of its 56 layers.

Prints one JSON object with, per window: host wall time (taken without the
profiler, on the same calls just before), device busy time (the sum of
kernel times: the engine runs on one stream, so kernels do not overlap), the
device's idle share of the wall time, kernel launches, and the kernels that
take the most device time.  Needs a CUDA device: device metrics are never
taken on the CPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..configs import get_config
from ..device import resolve_device
from ..models import build_model
from ..serving import ServingEngine

MAX_BATCH, S_MAX, PROMPT_LEN = 8, 2048, 1024
STEPS = 10        # decode steps per window
PREFILLS = 3      # prefills per window
TOP = 12          # kernels listed per window


def _summary(prof, wall_s: float, prof_wall_s: float, units: int) -> dict:
    """Per-unit (step or prefill) device time by kernel from ``prof``;
    ``wall_s`` is the same window run without the profiler."""
    rows = []
    for evt in prof.key_averages():
        dev_ms = (getattr(evt, "self_device_time_total", 0)
                  or getattr(evt, "device_time_total", 0)) / 1e3
        if evt.device_type == torch.autograd.DeviceType.CUDA and dev_ms > 0:
            rows.append((dev_ms, evt.count, evt.key))
    busy = sum(r[0] for r in rows)
    if busy == 0:
        raise RuntimeError("the profiler saw no device time")
    rows.sort(reverse=True)
    return {
        "units": units,
        "wall_ms": wall_s * 1e3 / units,
        "profiled_wall_ms": prof_wall_s * 1e3 / units,
        "device_busy_ms": busy / units,
        "idle_share": 1.0 - busy / (wall_s * 1e3),
        "kernel_launches": sum(r[1] for r in rows) / units,
        "top": [{"kernel": k[:120], "calls": n / units, "ms": ms / units,
                 "share_of_busy": ms / busy} for ms, n, k in rows[:TOP]],
    }


def _timed(fn, units: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(units):
        fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _window(fn, units: int) -> tuple[dict, profile]:
    """Run ``units`` calls unprofiled (host wall time), then ``units`` more
    under the profiler (device time by kernel)."""
    wall = _timed(fn, units)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall = _timed(fn, units)
    return _summary(prof, wall, prof_wall, units), prof


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (default: the "
                         "config's own)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the JSON and a Chrome trace of the "
                         "decode window next to it")
    args = ap.parse_args(argv)

    device = resolve_device("cuda")
    cfg = get_config(args.arch).replace(use_flash=True)
    if args.layers is not None:
        cfg = cfg.replace(num_layers=args.layers)
    model = build_model(cfg, device)
    params = model.init(args.seed)
    rng = np.random.default_rng(args.seed)
    eng = ServingEngine(model, params, max_batch=MAX_BATCH, s_max=S_MAX,
                        kv_mode="auto")
    budget = 2 * STEPS + 4 * MAX_BATCH   # outlasts admission and windows
    for _ in range(MAX_BATCH):
        eng.submit(rng.integers(0, cfg.vocab_size,
                                int(rng.integers(64, PROMPT_LEN + 1))),
                   max_new_tokens=budget)
    while eng.batcher.waiting_count or None in eng.slot_req:
        eng.step()                      # admit and prefill every slot
    eng.step()                          # warm the decode path
    decode, prof = _window(eng.step, STEPS)

    prompt = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (1, PROMPT_LEN)), device=device)
    model.prefill(params, {"tokens": prompt}, S_MAX)    # warm-up
    prefill, _ = _window(
        lambda: model.prefill(params, {"tokens": prompt}, S_MAX), PREFILLS)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    out = {"device": card.splitlines()[0].strip(), "arch": cfg.name,
           "layers": cfg.num_layers, "kv_mode": eng.kv_mode,
           "max_batch": MAX_BATCH, "s_max": S_MAX, "decode_step": decode,
           "prefill": dict(prefill, prompt_len=PROMPT_LEN)}
    print(json.dumps(out))
    if args.out:
        path = Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=1))
        prof.export_chrome_trace(str(path.with_suffix(".trace.json")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
