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
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch jamba-v0.1-52b --layers 16 --out build/profile_jamba.json
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch qwen3-8b --out build/profile_qwen3.json
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch kimi-k2-1t-a32b --layers 1 --out build/profile_kimi.json
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch seamless-m4t-medium --out build/profile_seamless.json

``--layers`` cuts the depth (the widths stay as published): full
Mixtral-8x22B needs ~281 GB, so one card holds 8 of its 56 layers; full
Jamba ~104 GB, so one card holds 2 of its 4 superblocks (16 of 32 layers;
the hybrid's depth must be a multiple of its superblock, ``attn_every``);
mistral-large-123b 22 of its 88 layers and kimi-k2-1t-a32b 1 of its 61
(17.05B parameters a layer).

The encoder-decoder (``seamless-m4t-medium``, whole) has no engine path
(no ``init_cache``, as in the reference): its windows time
``make_prefill_step`` (B = 8 sources of 1024 frames, 16 target tokens,
s_max 256) and steps of ``make_decode_step`` at a scalar position.

Prints one JSON object with, per window: host wall time (taken without the
profiler, on the same calls just before), device busy time (the sum of
kernel times: the engine runs on one stream, so kernels do not overlap), the
device's idle share of the wall time, kernel launches, and the kernels that
take the most device time, and each hand-written kernel's share of the busy
time (by kernel name).  For the hybrid it adds the plain Mamba scan's and
the whole Mamba layer's device time at the prefill's shape, measured alone,
and their share of the prefill's busy time over all the Mamba layers.
Needs a CUDA device: device metrics are never taken on the CPU.
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
from ..kernels.mamba_scan.ref import scan_chunk, scan_chunked
from ..models import build_model, ssm
from ..models.transformer import _layer
from ..serving import ServingEngine
from ..train import make_decode_step, make_prefill_step

MAX_BATCH, S_MAX, PROMPT_LEN = 8, 2048, 1024
STEPS = 10        # decode steps per window
PREFILLS = 3      # prefills per window
TOP = 12          # kernels listed per window
#: the encoder-decoder's windows: source frames, target prompt tokens and
#: the self-attention cache's capacity (``chip_smoke.py``'s phase 11)
ENCDEC_SRC, ENCDEC_PROMPT, ENCDEC_S_MAX = 1024, 16, 256
#: the hand-written kernels, by a substring of their CUDA function names
KERNELS = {"flash_attention": "flash_", "grouped_swiglu": "gmm_",
           "wkv6": "wkv6_", "prefix_scan": "prefix_scan_"}


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
        "kernel_share": {name: sum(ms for ms, _, k in rows if tag in k) / busy
                         for name, tag in KERNELS.items()},
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


def _mamba_windows(cfg, params, device) -> dict:
    """The hybrid's Mamba layer at the prefill's shape (one prompt of
    PROMPT_LEN tokens), timed alone: the plain scan (``ref.scan_chunked``
    on fp32 decays and inputs [1, T, d_inner, d_state]) and the whole
    ``mamba_fwd``.  Their device ms per call, and per prefill over every
    Mamba layer (attn_every - 1 a superblock)."""
    n_mamba = cfg.num_layers // cfg.attn_every * (cfg.attn_every - 1)
    layers = _layer(params["superblocks"], 0)["layers"]
    mp = next(layer["mamba"] for layer in layers if "mamba" in layer)
    g = torch.Generator(device=device).manual_seed(0)
    shape = (1, PROMPT_LEN, cfg.mamba_d_inner, cfg.mamba_d_state)
    decay = torch.rand(shape, generator=g, device=device)
    inp = torch.randn(shape, generator=g, device=device)
    h0 = torch.zeros(shape[:1] + shape[2:], device=device)
    x = torch.randn(1, PROMPT_LEN, cfg.d_model, generator=g,
                    device=device).to(mp["in_proj"]["w"].dtype)
    chunk = scan_chunk(PROMPT_LEN, cfg.ssm_chunk)
    scan, _ = _window(lambda: scan_chunked(decay, inp, h0, chunk),
                      PREFILLS)
    layer, _ = _window(lambda: ssm.mamba_fwd(mp, x, cfg), PREFILLS)
    return {"mamba_layers": n_mamba, "scan": scan, "mamba_fwd": layer,
            "scan_ms_per_prefill": scan["device_busy_ms"] * n_mamba,
            "mamba_ms_per_prefill": layer["device_busy_ms"] * n_mamba}


def _encdec_windows(model, params, rng, seed) -> tuple[dict, dict,
                                                      profile]:
    """(prefill window, decode window, the decode window's profile) of
    the encoder-decoder through the step functions."""
    cfg, device = model.cfg, model.device
    g = torch.Generator(device=device).manual_seed(seed)
    batch = {"src_embeds": torch.randn(
                 MAX_BATCH, ENCDEC_SRC, cfg.audio_embed_dim, generator=g,
                 device=device).to(params["embed"]["table"].dtype),
             "tokens": torch.as_tensor(rng.integers(
                 0, cfg.vocab_size, (MAX_BATCH, ENCDEC_PROMPT)),
                 device=device)}
    prefill_step = make_prefill_step(model, ENCDEC_S_MAX)
    decode_step = make_decode_step(model)
    logits, cache = prefill_step(params, batch)          # warm-up
    prefill, _ = _window(lambda: prefill_step(params, batch), PREFILLS)
    state = {"token": torch.argmax(logits[:, -1], -1)[:, None].int(),
             "cache": cache, "pos": ENCDEC_PROMPT}

    def step():
        state["token"], _, state["cache"] = decode_step(
            params, state["token"], state["cache"], state["pos"])
        state["pos"] += 1

    step()                                               # warm-up
    decode, prof = _window(step, STEPS)
    return dict(prefill, prompt_len=ENCDEC_PROMPT,
                src_frames=ENCDEC_SRC), decode, prof


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

    cfg = get_config(args.arch).replace(use_flash=True)
    if args.layers is not None:
        if cfg.attn_every and args.layers % cfg.attn_every:
            ap.error(f"--layers {args.layers}: {cfg.name} stacks "
                     f"superblocks of {cfg.attn_every} layers")
        cfg = cfg.replace(num_layers=args.layers)
    device = resolve_device("cuda")
    model = build_model(cfg, device)
    params = model.init(args.seed)
    rng = np.random.default_rng(args.seed)
    if cfg.family == "encdec":
        prefill, decode, prof = _encdec_windows(model, params, rng,
                                                args.seed)
        kv_mode, s_max = "step functions", ENCDEC_S_MAX
    else:
        eng = ServingEngine(model, params, max_batch=MAX_BATCH, s_max=S_MAX,
                            kv_mode="auto")
        budget = 2 * STEPS + 4 * MAX_BATCH  # outlasts admission and windows
        for _ in range(MAX_BATCH):
            eng.submit(rng.integers(0, cfg.vocab_size,
                                    int(rng.integers(64, PROMPT_LEN + 1))),
                       max_new_tokens=budget)
        while eng.batcher.waiting_count or None in eng.slot_req:
            eng.step()                  # admit and prefill every slot
        eng.step()                      # warm the decode path
        decode, prof = _window(eng.step, STEPS)

        prompt = torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (1, PROMPT_LEN)), device=device)
        model.prefill(params, {"tokens": prompt}, S_MAX)    # warm-up
        prefill, _ = _window(
            lambda: model.prefill(params, {"tokens": prompt}, S_MAX),
            PREFILLS)
        prefill = dict(prefill, prompt_len=PROMPT_LEN)
        kv_mode, s_max = eng.kv_mode, S_MAX

    mamba = None
    if cfg.family == "hybrid":
        mamba = _mamba_windows(cfg, params, device)
        for key in ("scan", "mamba"):
            mamba[f"{key}_share_of_prefill_busy"] = (
                mamba[f"{key}_ms_per_prefill"] / prefill["device_busy_ms"])

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    out = {"device": card.splitlines()[0].strip(), "arch": cfg.name,
           "layers": cfg.num_layers, "kv_mode": kv_mode,
           "max_batch": MAX_BATCH, "s_max": s_max, "decode_step": decode,
           "prefill": prefill}
    if mamba is not None:
        out["mamba"] = mamba
    print(json.dumps(out))
    if args.out:
        path = Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=1))
        prof.export_chrome_trace(str(path.with_suffix(".trace.json")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
