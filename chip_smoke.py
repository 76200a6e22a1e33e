#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
H100, run from the root of a checkout:

    python3 chip_smoke.py

Phases (each prints a line; any failure raises and the exit code is not 0):

1. device: CUDA present with capability (9, 0); the card's name and power
   limit from nvidia-smi; TF32 off.
2. build: nvcc builds the flash-attention library from ``csrc/``.
3. kernels: the hand-written kernel against its plain PyTorch version at
   the main path's shapes (prefill and decode, bf16 and fp32, a window with
   a bottom-right q_offset, a kv_valid = 0 row), within the stated
   tolerances; the kernel's, the plain version's and SDPA's times (CUDA
   events, median over launches, L2 flushed before each), and the bound.
4. main path: full-width qwen2-1.5b (28 layers, random bf16 weights from
   --seed) served by the paged ``ServingEngine``: 16 requests, prompts of
   64-1024 tokens, 32 new tokens each; every request done, the allocator's
   invariants hold, logits finite, and flash attention launched in both
   prefill and decode.
5. paged == contiguous: the same model generates identical tokens through
   both KV layouts.

The line before the last is the kernels' JSON record; the last is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import build, ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_plain)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

#: H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and FLOP/s
#: by input type (bf16 on the tensor cores, fp32 outside them)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
KERNEL = dict(name="flash_attention", route="cuda",
              source="src/repro_torch/kernels/flash_attention/csrc/"
                     "flash_attention.cu",
              replaces="src/repro/kernels/flash_attention/kernel.py:102")


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs a Hopper card (9, 0), got {cap}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    # float32 matmuls in full float32 (not TF32) for the fp32 comparisons
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)}, capability {cap}, "
          f"torch {torch.__version__}, cuda {torch.version.cuda}")
    return smi.splitlines()[0]


def phase_build() -> None:
    path, seconds, log = build.build_library()
    (path.parent / "flash_attention.build.log").write_text(log)
    regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
            if "registers" in ln]
    print(f"build: {path.name} in {seconds} s; ptxas: {regs}")
    build.load_library()


def _time_ms(fn, reps: int = 15, warmup: int = 3) -> float:
    """Median device time of one call, with L2 flushed before each."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _visible(b, s, t, causal, window, q_offset, kv_valid):
    """[B, S, T] bool: the kernel's mask on this case's data."""
    i = q_offset + torch.arange(s, device="cuda")[:, None]
    j = torch.arange(t, device="cuda")[None, :]
    m = torch.ones(s, t, dtype=torch.bool, device="cuda")
    if causal:
        m &= j <= i
    if window is not None:
        m &= i - j < window
    m = m.expand(b, s, t)
    if kv_valid is not None:
        m = m & (j < kv_valid[:, None, None])
    return m


def _bound(q, k, causal, window, q_offset, kv_valid):
    """Least time for this case's work: bytes (q and o once, the K/V rows
    some query may see once) and FLOPs (QK^T and PV over visible pairs)."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    vis = _visible(b, s, t, causal, window, q_offset, kv_valid)
    elt = q.element_size()
    kv_rows = int(vis.any(dim=1).sum())
    nbytes = 2 * q.numel() * elt + 2 * kv_rows * hkv * d * elt
    flops = 4 * d * h * int(vis.sum())
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_kernels(seed: int) -> list:
    g = torch.Generator(device="cuda").manual_seed(seed)
    cases = [
        # name, dtype, B, S, T, causal, window, q_offset, kv_valid
        ("prefill", torch.bfloat16, 1, 1024, 1024, True, None, 0, None),
        ("decode", torch.bfloat16, 8, 1, 2048, False, None, 0,
         [1, 2048, 7, 300, 1024, 2047, 64, 1500]),
        ("window_q_offset", torch.bfloat16, 2, 256, 1024, True, 384, 768,
         None),
        ("decode_kv_valid_0", torch.bfloat16, 8, 1, 2048, False, None, 0,
         [0, 2048, 7, 300, 0, 2047, 64, 1500]),
        ("prefill", torch.float32, 1, 1024, 1024, True, None, 0, None),
        ("decode", torch.float32, 8, 1, 2048, False, None, 0,
         [1, 2048, 7, 300, 1024, 2047, 64, 1500]),
    ]
    h, hkv, d = 12, 2, 128
    rows = []
    for name, dt, b, s, t, causal, window, q_offset, valid in cases:
        q = torch.randn(b, s, h, d, generator=g, device="cuda").to(dt)
        k = torch.randn(b, t, hkv, d, generator=g, device="cuda").to(dt)
        v = torch.randn(b, t, hkv, d, generator=g, device="cuda").to(dt)
        kv_valid = None if valid is None else torch.tensor(
            valid, dtype=torch.int32, device="cuda")
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        got = ops.flash_attention(q, k, v, kv_valid, **kw)
        torch.cuda.synchronize()
        want = flash_attention_plain(q, k, v, kv_valid, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not err <= TOL[dt]:
            raise AssertionError(f"flash_attention {name} {dt}: max error "
                                 f"{err} > {TOL[dt]}")
        if valid is not None:
            dead = kv_valid == 0
            if dead.any() and not torch.all(got[dead] == 0):
                raise AssertionError(f"{name}: kv_valid = 0 row is not 0")
        # SDPA in its own layout, with the same mask, as the yardstick
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = None
        if not (causal and window is None and q_offset == 0 and s == t):
            mask = _visible(b, s, t, causal, window, q_offset,
                            kv_valid)[:, None]
        scale = d ** -0.5
        bound_ms, bound_by = _bound(q, k, causal, window, q_offset, kv_valid)
        ms = _time_ms(lambda: ops.flash_attention(q, k, v, kv_valid, **kw))
        rows.append(dict(
            KERNEL, case=f"{name}/{str(dt).split('.')[1]}",
            shape=dict(B=b, S=s, T=t, H=h, Hkv=hkv, d=d), max_abs_err=err,
            max_err=err, tol=TOL[dt], ms=ms, kernel_ms=ms,
            plain_ms=_time_ms(lambda: flash_attention_plain(
                q, k, v, kv_valid, **kw)),
            library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=mask is None,
                scale=scale, enable_gqa=True)),
            bound_ms=bound_ms, bound_by=bound_by))
        print(f"kernel {rows[-1]['case']}: max_err {err} (tol {TOL[dt]}), "
              f"{ms} ms, plain {rows[-1]['plain_ms']} ms, sdpa "
              f"{rows[-1]['library_ms']} ms, bound {bound_ms} ms "
              f"({bound_by})")
    return rows


def _prompts(rng, n, vocab):
    return [rng.integers(0, vocab, int(rng.integers(64, 1025)))
            for _ in range(n)]


class _Phase:
    """Wraps an engine call: device-synchronized seconds, calls, flash
    launches inside it, and a finite-logits check."""

    def __init__(self, fn):
        self.fn, self.seconds, self.calls, self.launches = fn, 0.0, 0, 0

    def __call__(self, *args):
        n0, t0 = ops.flash_attention.launches, time.perf_counter()
        logits, cache = self.fn(*args)
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite logits")
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        self.launches += ops.flash_attention.launches - n0
        return logits, cache


def phase_main_path(model, params, prompts) -> dict:
    eng = ServingEngine(model, params, max_batch=8, s_max=2048,
                        block_size=16, kv_mode="paged")
    prefill, decode = _Phase(eng._prefill), _Phase(eng._decode)
    eng._prefill, eng._decode = prefill, decode
    reqs = [eng.submit(p, max_new_tokens=32, priority=float(i % 3))
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.flash_attention.launches = 0
    t0 = time.perf_counter()
    outs = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.flash_attention.launches
    if not all(r.state.name == "DONE" for r in reqs):
        raise AssertionError("not every request finished")
    eng.alloc.check()
    if prefill.launches == 0 or decode.launches == 0 \
            or launches != prefill.launches + decode.launches:
        raise AssertionError(f"flash launches: prefill {prefill.launches}, "
                             f"decode {decode.launches}, total {launches}")
    tokens = sum(len(outs[r.rid]) for r in reqs)
    if tokens != 32 * len(reqs):
        raise AssertionError(f"{tokens} tokens for {len(reqs)} requests")
    stats = dict(requests=len(reqs), tokens=tokens, wall_s=wall,
                 tokens_per_s=tokens / wall, prefill_s=prefill.seconds,
                 prefill_calls=prefill.calls,
                 decode_steps=decode.calls,
                 decode_step_ms=decode.seconds / decode.calls * 1e3,
                 flash_launches=launches,
                 flash_launches_prefill=prefill.launches,
                 flash_launches_decode=decode.launches,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                 prompt_tokens=int(sum(len(p) for p in prompts)))
    print("main path: " + json.dumps(stats))
    return stats


def phase_paged_equals_contiguous(model, params, prompts) -> None:
    results = {}
    for mode in ("contiguous", "paged"):
        eng = ServingEngine(model, params, max_batch=8, s_max=2048,
                            block_size=16, kv_mode=mode)
        reqs = [eng.submit(p, max_new_tokens=16, priority=float(i % 3))
                for i, p in enumerate(prompts)]
        outs = eng.run_until_drained()
        if not all(r.state.name == "DONE" for r in reqs):
            raise AssertionError(f"{mode}: not every request finished")
        results[mode] = [outs[r.rid] for r in reqs]
    if results["paged"] != results["contiguous"]:
        raise AssertionError("paged and contiguous tokens differ")
    print(f"paged == contiguous: {len(prompts)} requests, "
          f"{sum(map(len, results['paged']))} identical tokens")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    smi = phase_device()
    phase_build()
    rows = phase_kernels(args.seed)
    cfg = get_config("qwen2-1.5b").replace(use_flash=True)
    model = build_model(cfg, "cuda")
    t0 = time.perf_counter()
    params = model.init(args.seed)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    print(f"model: {cfg.name} L={cfg.num_layers} d={cfg.d_model} "
          f"heads={cfg.num_heads}/{cfg.num_kv_heads} hd={cfg.head_dim} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} {cfg.dtype}, {n_params} "
          f"params, init {time.perf_counter() - t0} s")
    prompts = _prompts(np.random.default_rng(args.seed), 16, cfg.vocab_size)
    stats = phase_main_path(model, params, prompts)
    for row in rows:
        row["launches"] = stats["flash_launches"]
    phase_paged_equals_contiguous(model, params, prompts[:4])
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
