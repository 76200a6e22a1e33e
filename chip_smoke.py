#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
H100, run from the root of a checkout:

    python3 chip_smoke.py

Phases (each prints a line; any failure raises and the exit code is not 0):

1. device: CUDA present with capability (9, 0); the card's name and power
   limit from nvidia-smi; TF32 off.
2. build: nvcc builds the flash-attention, grouped-SwiGLU, WKV-6 and
   prefix-scan libraries from ``csrc/``, all at once; build seconds and
   ptxas registers and spills.
3. kernels: each hand-written kernel against its plain PyTorch version at
   the main paths' shapes, within the stated tolerances; the kernel's, the
   plain version's and the library yardstick's times (CUDA events, median
   over launches, L2 flushed before each), and the bound; the kernel's
   device time, and the yardstick's where there is one (torch.profiler: the
   kernels a call launches, without the host's gaps).
   - flash attention at qwen2-1.5b's heads (12/2): prefill and decode,
     bf16 and fp32, a window with a bottom-right q_offset, a kv_valid = 0
     row; at Mixtral-8x22B's heads (48/8): a 512-token prefill with its
     4096 window and a decode over the 1024-slot paged view, mixed kv_valid;
     then the split route's edges (T not a multiple of the chunk, T under
     one chunk, kv_valid 0, 1 and T in one batch, S = 2..4 causal with a
     q_offset, a window that empties the early chunks, g = 1, 6, 8, fp32);
     each row names the kernel that ran (``mma``: bf16 prefill on the
     tensor cores; ``fma``: fp32 prefill on the CUDA cores; ``split``:
     decode, S <= 4, split-KV with GQA packing, and its plan), is run twice
     for the same bits, and adds the kernel's and the plain version's error
     against attention in fp64 (bf16 prefill: a few heads; every split
     row: every batch row and head, held row by row to twice the plain
     version's error plus FP64_ULPS ulps at the row's scale); then
     a latency probe of the mma kernel (one kv head a query head, 64 rows,
     1024 columns) at one CTA, one CTA an SM and two;
   - grouped SwiGLU at Mixtral-8x22B's widths: decode (C = 8, the load of a
     real routing of 8 tokens), prefill at C = 512 and C = 1024 (real
     routings, ~128 and ~256 rows per expert), an empty expert (exact
     zeros), a small fp32 case, decode at C = 16, loads of 0, 1 and C rows,
     and D, F multiples of 8 but not 16 at a small shape; kernel and plain
     version each also against the function computed in fp64 on a few rows
     per expert; device times of the kernel and of cuBLAS bmm;
   - WKV-6 at rwkv6-3b's heads (H = 40, N = 64): the bf16 prefill at
     T = 1024, a ragged T = 77 with a non-zero s0, fp32 at B = 2, T = 256,
     one chunk (T = 64, the shortest main-path prompt) and a chunk and a
     step (T = 65), and T = 1024 under extreme decays (w = exp(-exp(x)) up
     to x = 5, whole steps at exactly 0 and 1); every row run twice for the
     same bits; kernel and plain version each also against the recurrence
     in fp64 on a few heads; the kernel's device time;
   - the prefix scan: kernel_bench's (4, 1024) and (8, 8192), R = N = 4096
     in fp32, int32 (exact) and bf16 (one tile a row), and rows that the
     look-back chains: four of 2^22, one of 2^20 + 13 (ragged), one of 2^24
     in fp32 and in int32; every row run twice, with the largest difference
     between the two runs (int32: none); torch.cumsum as the yardstick.
4. main path 1: full-width qwen2-1.5b (28 layers, random bf16 weights from
   --seed) served by the paged ``ServingEngine``: 16 requests, prompts of
   64-1024 tokens, 32 new tokens each; every request done, the allocator's
   invariants hold, logits finite, and flash attention launched in both
   prefill and decode.  Then paged == contiguous on 4 requests.  Then the
   speculative paths (``phase_spec``) on 8 of those prompts, 32 new tokens:
   the plain paged engine, a self draft (k = 4) and a cross draft (the
   same config from --seed + 1, k = 4, adaptive), each served with the
   counts set to 0 just before it and read just after; every request done
   with 32 tokens, ``alloc.check()``, rounds > 0, the self draft's
   acceptance >= 0.9, the cross draft's wasted > 0, flash attention
   launched once a layer in every draft step and never in a verify call;
   draft, verify and plain-decode seconds and calls, launches by phase and
   the share of tokens equal to the plain engine's are printed.  Then the
   verify probe (``phase_verify_probe``): 8 slots at mixed positions,
   ``verify_paged`` on 5 tokens against 5 sequential paged decode steps,
   per row the relative logit difference and argmax agreement (reported).
4b. the greedy contract (``phase_spec_exact``): qwen2-1.5b at full width,
   4 of 28 layers, fp32, flash off, 4 requests, 16 new tokens: the plain
   engine and a self, a cross and a partial draft (the target's weights
   with seeded noise, giving a round with 0 < matched < k) must emit
   identical tokens (a difference passes only as a recorded tie: a top-2
   gap under 1e-5 of the largest |logit|); the self draft accepts all.
   Then the verify probe in fp32, within 1e-4 of the largest |logit|.
5. main path 2: full-width Mixtral-8x22B cut to 8 of its 56 layers (random
   bf16 weights from --seed), served the same way: 8 requests, prompts of
   64-512 tokens, 16 new tokens each; both kernels launched in both
   prefill and decode.  Then paged == contiguous on 4 requests.  Then
   ``phase_spec`` with the plain engine and a self draft (k = 4, fixed):
   the checks above (the self draft's acceptance >= 0.6: see
   MOE_SELF_ACCEPT_MIN), and grouped SwiGLU launched once a layer in every
   verify call with its dispatch reaching C = B (k + 1) = 40 rows (the
   128-row tile); the grouped-SwiGLU device time of each verify and plain
   decode call (CUDA events) is printed.  Then the verify probe at
   Mixtral's widths: bf16 (reported), and fp32 with 2 of its 56 layers
   through the kernels (fp32 grouped SwiGLU, flash's split decode), within
   1e-4 of the largest |logit|.
6. main path 3: full rwkv6-3b (32 layers, random bf16 weights from --seed)
   served by the contiguous ``ServingEngine`` (the family has no paged
   path): 8 requests, prompts of 64-1024 tokens, 32 new tokens each; WKV-6
   launched once a layer in every prefill and never in decode (decode is
   the plain recurrence, as in the reference).  Then, in place of paged ==
   contiguous: the state hand-off (prefill(p + [t]) against prefill(p) then
   decode_step(t), in bf16 within the reference's bound of 0.25 on the
   logits) and the kernel route against the chunked scan (in fp32 within
   1e-3; in bf16 each route as far from the fp32 logits as the other), on
   4 prompts.

7. the prefix scan's own path (it is on no serving path: the reference
   runs it from its benchmarks and tests only): its public wrapper driven
   at the inputs the reference's benchmarks give it, each held against
   its plain version.

Every kernel launch of a path is counted by its wrapper, with the counts
set to 0 just before the path and read just after.  ``launches`` counts
wrapper calls that launched the kernel route: a flash decode (the split
pass and, with several splits, the combine pass) and a grouped SwiGLU (its
two phases) each count once.  ``kernel_launches`` counts the kernels those
calls launched.

Two lines before the last is the JSON record of the kernels and of the
speculative phases (``spec``); then the card's name and power limit; the
last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.device.moe_balance import (  # noqa: E402
    gather_expert_inputs, priority_dispatch, route_topk)
from repro_torch.kernels.flash_attention import build, ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_plain)
from repro_torch.kernels.moe_gmm import build as gmm_build  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as gmm_ops  # noqa: E402
from repro_torch.kernels.moe_gmm.ref import (  # noqa: E402
    grouped_swiglu_plain)
from repro_torch.kernels.prefix_scan import build as scan_build  # noqa: E402
from repro_torch.kernels.prefix_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.prefix_scan.ref import (  # noqa: E402
    acc_dtype, prefix_scan_plain)
from repro_torch.kernels.wkv6 import build as wkv_build  # noqa: E402
from repro_torch.kernels.wkv6 import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.wkv6.ref import wkv6_plain  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.attention import PagedKVCache  # noqa: E402
from repro_torch.serving import ServingEngine, Speculator  # noqa: E402
from repro_torch.serving import speculative  # noqa: E402

#: H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and FLOP/s
#: by input type (bf16 on the tensor cores, fp32 outside them)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
#: a split-decode row's allowance against fp64, beyond twice the plain
#: version's error: ulps of the dtype at the row's largest |value|.  In
#: bf16 both round the output (half an ulp) and little else shows; in fp32
#: the T-term sums and exps leave both 6-22 ulps from fp64 (H100 80GB HBM3)
#: and another summation order may differ by that much
FP64_ULPS = {torch.bfloat16: 1, torch.float32: 16}
KERNEL = dict(name="flash_attention", route="cuda",
              source="src/repro_torch/kernels/flash_attention/csrc/"
                     "flash_attention.cu",
              replaces="src/repro/kernels/flash_attention/kernel.py:102")
GMM_KERNEL = dict(name="grouped_swiglu", route="cuda",
                  source="src/repro_torch/kernels/moe_gmm/csrc/moe_gmm.cu",
                  replaces="src/repro/kernels/moe_gmm/kernel.py:53")
WKV_KERNEL = dict(name="wkv6", route="cuda",
                  source="src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
                  replaces="src/repro/kernels/wkv6/kernel.py:67")
SCAN_KERNEL = dict(name="prefix_scan", route="cuda",
                   source="src/repro_torch/kernels/prefix_scan/csrc/"
                          "prefix_scan.cu",
                   replaces="src/repro/kernels/prefix_scan/kernel.py:46")
#: each kernel's launch counters (plain integers on its wrapper): calls
#: that launched it, and, where a call launches more than one kernel, the
#: kernels launched
COUNTERS = {"flash_attention": ops.flash_attention,
            "grouped_swiglu": gmm_ops.grouped_swiglu,
            "wkv6": wkv_ops.wkv6,
            "prefix_scan": scan_ops.prefix_scan}
#: max |logit| difference the reference allows its bf16 path between two
#: computations of the same logits (tests/test_models.py)
BF16_LOGIT_TOL = 0.25
#: the prefix scan's own path: no serving path runs it
SCAN_PATH = "prefix-scan benchmarks"
#: the WKV routes (kernel and chunked scan) in fp32 at full depth: the same
#: fp32 products summed in other orders, ~1e-4 apart
ROUTE_TOL_FP32 = 1e-3
#: speculative decoding: the draft depth; the self draft's least acceptance
#: in bf16 (verify on the masked path, draft and decode on the split
#: kernel, whose roundings differ: qwen2-1.5b's logits by ~2 % of the
#: largest |logit|, so near-ties flip).  Mixtral's is lower: a rounding
#: difference that flips a token's top-2 experts moves its output far more,
#: and verify's dispatch takes the 128-row tile where decode takes the
#: 16-row one; 0.764 on an H100 80GB HBM3 at 700 W (the qwen bound failed
#: there).  The fp32 verify probe's bound on |verify - sequential decode|
#: relative to the row's largest |logit|; a top-2 logit gap under TIE_REL
#: of the largest |logit| is a tie; the partial draft's noise scales (of
#: each leaf's std), tried in order
SPEC_K = 4
SELF_ACCEPT_MIN = 0.9
MOE_SELF_ACCEPT_MIN = 0.6
PROBE_TOL_FP32 = 1e-4
TIE_REL = 1e-5
PARTIAL_NOISE = (0.05, 0.1, 0.2, 0.4)


def _zero_counts() -> None:
    for counter in COUNTERS.values():
        counter.launches = 0
        if hasattr(counter, "kernel_launches"):
            counter.kernel_launches = 0


def _kernel_launches() -> dict:
    """The kernels each wrapper launched: its own count where a call can
    launch more than one, else its count of calls."""
    return {k: getattr(c, "kernel_launches", c.launches)
            for k, c in COUNTERS.items()}


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
    """Every library at once: one nvcc each, started together."""
    libs = {"flash_attention": build.LIBRARY, "moe_gmm": gmm_build.LIBRARY,
            "wkv6": wkv_build.LIBRARY, "prefix_scan": scan_build.LIBRARY}
    with ThreadPoolExecutor(len(libs)) as pool:
        futures = {name: pool.submit(lib.build) for name, lib in libs.items()}
        built = {name: f.result() for name, f in futures.items()}
    for name, (path, seconds, log) in built.items():
        (path.parent / f"{name}.build.log").write_text(log)
        regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                if "registers" in ln]
        spills = [ln.strip() for ln in log.splitlines() if "spill" in ln
                  and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        print(f"build: {path.name} in {seconds} s; ptxas: {regs}; "
              f"spills: {spills or 'none'}")
        libs[name].load()


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


def _device_ms(fn, reps: int = 20, tries: int = 3) -> float:
    """Device time of one call: the time of every kernel (and memset) it
    launches, from torch.profiler over ``reps`` calls (L2 warm), without
    the host's launch gaps that a timed single call can include.  Now and
    then the profiler returns a window with no device events at all (once
    in three runs on the H100, on a window of torch.cumsum calls); such a
    window is taken again, ``tries`` times in all, before this fails."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum((getattr(e, "self_device_time_total", 0)
                  or getattr(e, "device_time_total", 0))
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / reps / 1e3
    raise RuntimeError(f"the profiler saw no device time in {tries} windows")


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


def _attn_fp64(q, k, v, kv_valid, causal, window, q_offset, batch=1,
               heads=4):
    """Attention in fp64 for the first ``batch`` batch rows and ``heads``
    query heads (a fully masked row is 0, as in the kernel):
    [batch, S, heads, d]."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    vis = _visible(b, s, t, causal, window, q_offset, kv_valid)
    kv = torch.arange(heads, device="cuda") // (h // hkv)
    outs = []
    for bb in range(batch):
        qd = q[bb, :, :heads].double().transpose(0, 1)      # heads, S, d
        kd, vd = (x[bb][:, kv].double().transpose(0, 1) for x in (k, v))
        logits = qd @ kd.transpose(1, 2) * d ** -0.5        # heads, S, T
        p = torch.softmax(logits.masked_fill(~vis[bb], float("-inf")), -1)
        outs.append((torch.nan_to_num(p) @ vd).transpose(0, 1))
    return torch.stack(outs)


def _row_errs(got, want, exact):
    """Each output row's (batch, query, head) max error against fp64, for
    the kernel and for the plain version, and the kernel's largest error
    over its row's allowance: twice the plain version's error plus
    FP64_ULPS ulps of the dtype at the row's largest |value|.  Long rows
    average to values of ~sqrt(e / T), under the absolute tolerance: a
    fault that biases them shows here.  A row over 1 fails the case."""
    ek = (got.double() - exact).abs().amax(-1)
    ep = (want.double() - exact).abs().amax(-1)
    scale = exact.abs().amax(-1)
    ulp = torch.ldexp(torch.full_like(scale, torch.finfo(got.dtype).eps
                                      * FP64_ULPS[got.dtype]),
                      torch.frexp(scale).exponent - 1)
    allow = 2 * ep + torch.where(scale > 0, ulp, 0)
    over = torch.where(allow > 0, ek / allow,
                       torch.where(ek > 0, float("inf"), 0.0))
    return ek.max().item(), ep.max().item(), over.max().item()


def phase_flash_probe() -> None:
    """The mma kernel's latency: one query tile of 64 rows over 1024
    columns (16 kv tiles, no mask) for 1 head, one head an SM and two
    (non-causal bf16, d = 128, one kv head a query head)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    probe = {}
    for heads in (1, sms, 2 * sms):
        q = torch.randn(1, 64, heads, 128, generator=g,
                        device="cuda").bfloat16()
        k = torch.randn(1, 1024, heads, 128, generator=g,
                        device="cuda").bfloat16()
        probe[f"ctas_{heads}"] = _device_ms(
            lambda: ops.flash_attention(q, k, k, causal=False))
    print("flash latency probe (device ms): " + json.dumps(probe))


def phase_kernels(seed: int) -> list:
    """flash_attention against its plain version at each main path's
    shapes: qwen2-1.5b's 12/2 heads and Mixtral-8x22B's 48/8 heads (whose
    prefill passes the 4096 window, decode the paged view of s_max 1024)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qwen, mixtral = "qwen2-1.5b", "mixtral-8x22b"
    cases = [
        # path, name, dtype, B, S, T, H, Hkv, causal, window, q_offset,
        # kv_valid
        (qwen, "prefill", torch.bfloat16, 1, 1024, 1024, 12, 2, True, None,
         0, None),
        (qwen, "decode", torch.bfloat16, 8, 1, 2048, 12, 2, False, None, 0,
         [1, 2048, 7, 300, 1024, 2047, 64, 1500]),
        (qwen, "window_q_offset", torch.bfloat16, 2, 256, 1024, 12, 2, True,
         384, 768, None),
        (qwen, "decode_kv_valid_0", torch.bfloat16, 8, 1, 2048, 12, 2, False,
         None, 0, [0, 2048, 7, 300, 0, 2047, 64, 1500]),
        (qwen, "prefill", torch.float32, 1, 1024, 1024, 12, 2, True, None, 0,
         None),
        (qwen, "decode", torch.float32, 8, 1, 2048, 12, 2, False, None, 0,
         [1, 2048, 7, 300, 1024, 2047, 64, 1500]),
        (mixtral, "mixtral_prefill", torch.bfloat16, 1, 512, 512, 48, 8,
         True, 4096, 0, None),
        (mixtral, "mixtral_decode", torch.bfloat16, 8, 1, 1024, 48, 8, False,
         None, 0, [65, 1024, 130, 513, 1, 300, 700, 529]),
        # the split route's edges: T not a multiple of the chunk with
        # kv_valid 0, 1 and T in one batch; T under one chunk; S = 2..4
        # with causal and a bottom-right q_offset; a window that leaves the
        # early chunks empty; g = H / Hkv of 1, 6 and 8
        (qwen, "split_ragged_T_kv_valid_0_1_T", torch.bfloat16, 4, 1, 1000,
         12, 2, False, None, 0, [0, 1, 1000, 517]),
        (qwen, "split_T_under_one_chunk", torch.bfloat16, 8, 1, 50, 12, 2,
         False, None, 0, [50, 1, 0, 25, 50, 49, 2, 33]),
        (qwen, "split_S2_causal", torch.bfloat16, 8, 2, 2048, 12, 2, True,
         None, 2046, [2048, 1024, 2, 1, 700, 2048, 3, 1500]),
        (mixtral, "split_S4_causal", torch.bfloat16, 4, 4, 1024, 48, 8, True,
         None, 1020, [1024, 4, 513, 900]),
        (qwen, "split_S3_g8", torch.bfloat16, 4, 3, 1024, 64, 8, True, None,
         1021, None),
        (qwen, "split_g1", torch.bfloat16, 8, 1, 2048, 8, 8, False, None, 0,
         [1, 2048, 7, 300, 1024, 2047, 64, 1500]),
        (qwen, "split_window", torch.bfloat16, 8, 1, 2048, 12, 2, False, 300,
         2047, None),
        (qwen, "split_S4_causal", torch.float32, 4, 4, 1024, 12, 2, True,
         None, 1020, [1024, 4, 513, 0]),
    ]
    d = 128
    rows = []
    for (path, name, dt, b, s, t, h, hkv, causal, window, q_offset,
         valid) in cases:
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
        route = ops.kernel_route(dt, s)
        if route != ("split" if s <= 4 else
                     "mma" if dt == torch.bfloat16 else "fma"):
            raise AssertionError(f"flash_attention {name}: route {route}")
        # no atomics and a plan fixed by the shapes: the same bits again
        if not torch.equal(got, ops.flash_attention(q, k, v, kv_valid, **kw)):
            raise AssertionError(f"flash_attention {name}: two calls differ")
        plan = ops.decode_plan(b, hkv, t) if route == "split" else None
        err64 = plain_err64 = row_over = None
        if route == "mma":
            exact = _attn_fp64(q, k, v, kv_valid, causal, window, q_offset)
            err64, plain_err64 = (
                (out[:1, :, :exact.shape[2]].double() - exact).abs().max()
                .item() for out in (got, want))
            del exact
        elif route == "split":
            exact = _attn_fp64(q, k, v, kv_valid, causal, window, q_offset,
                               batch=b, heads=h)
            err64, plain_err64, row_over = _row_errs(got, want, exact)
            del exact
            if not row_over <= 1:
                raise AssertionError(
                    f"flash_attention {name} {dt}: a row's error against "
                    f"fp64 is {row_over} times its allowance (kernel "
                    f"{err64}, plain {plain_err64})")
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

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=mask is None,
                scale=scale, enable_gqa=True)
        rows.append(dict(
            KERNEL, case=f"{name}/{str(dt).split('.')[1]}", path=path,
            shape=dict(B=b, S=s, T=t, H=h, Hkv=hkv, d=d, window=window,
                       q_offset=q_offset, kv_valid=valid),
            kernel_route=route,
            decode_plan=None if plan is None else plan._asdict(),
            max_abs_err=err, max_err=err, tol=TOL[dt], err_fp64=err64,
            plain_err_fp64=plain_err64, fp64_row_over_allowance=row_over,
            ms=ms, kernel_ms=ms,
            plain_ms=_time_ms(lambda: flash_attention_plain(
                q, k, v, kv_valid, **kw)),
            library_ms=_time_ms(sdpa),
            device_ms=_device_ms(lambda: ops.flash_attention(
                q, k, v, kv_valid, **kw)),
            library_device_ms=_device_ms(sdpa),
            bound_ms=bound_ms, bound_by=bound_by))
        print(f"kernel {rows[-1]['case']} ({path}, B={b} S={s} T={t} "
              f"H={h}/{hkv}, {route}"
              f"{'' if plan is None else f', {plan.splits} x {plan.chunk}'}): "
              f"max_err {err} (tol {TOL[dt]}; against fp64: kernel {err64}, "
              f"plain {plain_err64}, worst row {row_over} of its "
              f"allowance), {ms} ms, plain "
              f"{rows[-1]['plain_ms']} ms, sdpa {rows[-1]['library_ms']} ms; "
              f"device {rows[-1]['device_ms']} ms, sdpa "
              f"{rows[-1]['library_device_ms']} ms; bound {bound_ms} ms "
              f"({bound_by})")
    return rows


def _routed(g, n, e, d, dtype):
    """A real dropless routing of n random tokens over e experts: the
    dispatch buffer [e, n, d] and the plan's load."""
    x = torch.randn(n, d, generator=g, device="cuda").to(dtype)
    router = torch.randn(d, e, generator=g, device="cuda") / d ** 0.5
    idx, gate, probs = route_topk(x.float() @ router, 2)
    plan = priority_dispatch(idx, gate, probs, num_experts=e, capacity=n,
                             resteal=True)
    return gather_expert_inputs(x, plan, 2), plan.load


def _gmm_bound(x, f, load):
    """Least time for this case's work: FLOPs on the kept rows and bytes of
    the loaded experts' weights, the kept rows read and the output written."""
    e, c, d = x.shape
    loads = load.tolist()
    elt = x.element_size()
    rows = sum(loads)
    nbytes = (sum(1 for n in loads if n > 0) * 3 * d * f + rows * d
              + e * c * d) * elt
    flops = 6 * rows * d * f
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[x.dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _gmm_library(x, wg, wu, wd):
    """The yardstick: the same function composed of cuBLAS batched GEMMs on
    the dense buffer (no single PyTorch call computes it)."""
    h = (F.silu(torch.bmm(x, wg).float())
         * torch.bmm(x, wu).float()).to(x.dtype)
    return torch.bmm(h, wd)


def _fp64_err(x, wg, wu, wd, outs, rows=8):
    """Max error of each of ``outs`` against the function computed in fp64
    on the first ``rows`` rows of every expert (h rounded to x's type, the
    function's own rounding point): a yardstick independent of both."""
    errs = [0.0] * len(outs)
    for e in range(x.shape[0]):
        xe = x[e, :rows].double()
        h = (F.silu(xe @ wg[e].double()) * (xe @ wu[e].double())).to(
            x.dtype).double()
        y = h @ wd[e].double()
        for i, out in enumerate(outs):
            errs[i] = max(errs[i], (out[e, :rows].double() - y).abs().max()
                          .item())
        del xe, h, y
    return errs


def phase_gmm_kernel(seed: int) -> list:
    """grouped_swiglu against its plain version at Mixtral-8x22B's widths
    (E = 8, D = 6144, F = 16384) and at a small fp32 shape."""
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    e, d, f = 8, 6144, 16384

    def weights(e, d, f, dt):
        return [(torch.randn(s, generator=g, device="cuda") / s[1] ** 0.5
                 ).to(dt) for s in ((e, d, f), (e, d, f), (e, f, d))]

    w = weights(e, d, f, torch.bfloat16)
    decode_x, decode_load = _routed(g, 8, e, d, torch.bfloat16)
    empty_x, empty_load = decode_x.clone(), decode_load.clone()
    empty_x[0], empty_load[0] = 0, 0          # expert 0 receives nothing
    cases = [("decode", decode_x, decode_load, w),
             ("prefill_512", *_routed(g, 512, e, d, torch.bfloat16), w),
             ("prefill", *_routed(g, 1024, e, d, torch.bfloat16), w),
             ("empty_expert", empty_x, empty_load, w)]
    small_w = weights(4, 256, 512, torch.float32)
    small_x, small_load = _routed(g, 64, 4, 256, torch.float32)
    cases.append(("small", small_x, small_load, small_w))
    # the tensor-core path's edges: a decode slab of 16 rows (a real routing
    # of 16 tokens); loads of 0, 1 and C rows; D and F multiples of 8 but not
    # of 16 (the k edge inside a k-step), on the prefill tile
    cases.append(("decode_C16", *_routed(g, 16, e, d, torch.bfloat16), w))
    edge_load = torch.tensor([0, 1, 16, 0, 16, 1, 5, 16], dtype=torch.int32,
                             device="cuda")
    edge_x = torch.randn(e, 16, d, generator=g, device="cuda").bfloat16()
    edge_x[torch.arange(16, device="cuda")[None, :] >= edge_load[:, None]] = 0
    cases.append(("load_0_1_C", edge_x, edge_load, w))
    odd_load = torch.tensor([0, 1, 40], dtype=torch.int32, device="cuda")
    odd_x = torch.randn(3, 40, 264, generator=g, device="cuda").bfloat16()
    odd_x[torch.arange(40, device="cuda")[None, :] >= odd_load[:, None]] = 0
    cases.append(("D264_F520", odd_x, odd_load,
                  weights(3, 264, 520, torch.bfloat16)))
    rows = []
    for name, x, load, (wg, wu, wd) in cases:
        got = gmm_ops.grouped_swiglu(x, wg, wu, wd, load)
        torch.cuda.synchronize()
        want = grouped_swiglu_plain(x, wg, wu, wd, load)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL[x.dtype]
        if not err <= tol:
            raise AssertionError(f"grouped_swiglu {name}: max error {err} "
                                 f"> {tol}")
        dead = (torch.arange(x.shape[1], device="cuda")[None, :]
                >= load[:, None])
        if not torch.all(got[dead] == 0):
            raise AssertionError(f"grouped_swiglu {name}: rows beyond the "
                                 "load are not 0")
        if name == "empty_expert" and not torch.all(got[0] == 0):
            raise AssertionError("grouped_swiglu: the empty expert is not 0")
        err64, plain_err64 = _fp64_err(x, wg, wu, wd, (got, want))
        bound_ms, bound_by = _gmm_bound(x, wg.shape[2], load)
        ms = _time_ms(lambda: gmm_ops.grouped_swiglu(x, wg, wu, wd, load))
        rows.append(dict(
            GMM_KERNEL, case=f"{name}/{str(x.dtype).split('.')[1]}",
            path="mixtral-8x22b",
            shape=dict(E=x.shape[0], C=x.shape[1], D=x.shape[2],
                       F=wg.shape[2], load=load.tolist()),
            max_abs_err=err, max_err=err, tol=tol, ms=ms, kernel_ms=ms,
            err_fp64=err64, plain_err_fp64=plain_err64,
            bitwise_equal=bool(torch.equal(got, want)),
            plain_ms=_time_ms(lambda: grouped_swiglu_plain(x, wg, wu, wd,
                                                           load)),
            library_ms=_time_ms(lambda: _gmm_library(x, wg, wu, wd)),
            library="torch.bmm x3 (cuBLAS) + silu*mul cast",
            device_ms=_device_ms(lambda: gmm_ops.grouped_swiglu(
                x, wg, wu, wd, load), reps=5),
            library_device_ms=_device_ms(
                lambda: _gmm_library(x, wg, wu, wd), reps=5),
            bound_ms=bound_ms, bound_by=bound_by))
        print(f"kernel grouped_swiglu {rows[-1]['case']} E={x.shape[0]} "
              f"C={x.shape[1]} D={x.shape[2]} F={wg.shape[2]}: max_err {err} "
              f"(tol {tol}; against fp64: kernel {err64}, plain "
              f"{plain_err64}; bitwise equal {rows[-1]['bitwise_equal']}), "
              f"{ms} ms, plain {rows[-1]['plain_ms']} ms, "
              f"bmm {rows[-1]['library_ms']} ms; device "
              f"{rows[-1]['device_ms']} ms, bmm "
              f"{rows[-1]['library_device_ms']} ms; bound {bound_ms} ms "
              f"({bound_by}), load {load.tolist()}")
    del cases, w, small_w, edge_x, odd_x
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def _wkv_fp64(r, k, v, w, u, s0, heads):
    """The recurrence in fp64 for batch row 0 and ``heads``: (y, s_end)."""
    sl = (0, slice(None), heads)
    rd, kd, vd, wd = (a[sl].double() for a in (r, k, v, w))   # [T, h, N]
    ud = u[heads].double()
    s = s0[0, heads].double().clone()                         # [h, N, N]
    ys = torch.empty_like(rd)
    for t in range(rd.shape[0]):
        ys[t] = (torch.einsum("hk,hkv->hv", rd[t], s)
                 + (rd[t] * ud * kd[t]).sum(-1, keepdim=True) * vd[t])
        s = wd[t][..., None] * s + kd[t][..., None] * vd[t][:, None, :]
    return ys, s


def _within(got, want, rtol, atol=1e-4):
    """Elementwise |got - want| <= rtol |want| + atol."""
    return bool(torch.all((got.float() - want.float()).abs()
                          <= rtol * want.float().abs() + atol))


def _extreme_decay(b, t, h, n, g):
    """w = exp(-exp(x)), x ~ U(-6, 5) (fp32 w underflows to 0 past
    x ~ 4.6), with whole steps at exactly 0 and exactly 1."""
    w = torch.exp(-torch.exp(
        torch.rand(b, t, h, n, generator=g, device="cuda") * 11 - 6))
    w[:, 5:9] = 0
    w[:, 300:340] = 1
    w[:, 700] = 0
    return w


def phase_wkv6_kernel(seed: int) -> list:
    """wkv6 against its plain version at rwkv6-3b's heads (H = 40,
    N = 64).  Tolerances: y within one ulp of its type relative to the
    plain version's y (2^-7 relative for bf16, whose rounding point may fall
    either side of the two fp32 sums; 1e-4 for fp32), s_end (fp32) within
    1e-4 relative; each with 1e-4 absolute.  Every row runs twice and must
    give the same bits (each chunk takes its state from its predecessor, in
    a fixed order of operations)."""
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    h, n = 40, 64
    cases = [("prefill", torch.bfloat16, 1, 1024, False, False),
             ("ragged_s0", torch.bfloat16, 1, 77, True, False),
             ("fp32", torch.float32, 2, 256, True, False),
             ("one_chunk", torch.bfloat16, 1, 64, True, False),
             ("chunk_and_one", torch.bfloat16, 1, 65, True, False),
             ("fast_decay", torch.bfloat16, 1, 1024, True, True)]
    rows = []
    for name, dt, b, t, nonzero_s0, extreme in cases:
        r, k, v = (torch.randn(b, t, h, n, generator=g, device="cuda").to(dt)
                   for _ in range(3))
        w = _extreme_decay(b, t, h, n, g) if extreme else \
            0.45 + 0.5 * torch.sigmoid(
                torch.randn(b, t, h, n, generator=g, device="cuda"))
        u = 0.1 * torch.randn(h, n, generator=g, device="cuda")
        # the main path hands the kernel a zero state, not None
        s0 = torch.randn(b, h, n, n, generator=g, device="cuda") \
            if nonzero_s0 else torch.zeros(b, h, n, n, device="cuda")
        y, s = wkv_ops.wkv6(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        y2, s2 = wkv_ops.wkv6(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        same_bits = bool(torch.equal(y, y2) and torch.equal(s, s2))
        want_y, want_s = wkv6_plain(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        rtol = 2 ** -7 if dt == torch.bfloat16 else 1e-4
        err = (y.float() - want_y.float()).abs().max().item()
        s_err = (s - want_s).abs().max().item()
        if not (torch.isfinite(y).all() and torch.isfinite(s).all()
                and _within(y, want_y, rtol) and _within(s, want_s, 1e-4)):
            raise AssertionError(f"wkv6 {name}: y error {err}, s_end error "
                                 f"{s_err} beyond rtol {rtol} / 1e-4")
        if not same_bits:
            raise AssertionError(f"wkv6 {name}: a second call gave other "
                                 "bits")
        heads = slice(0, 4)
        y64, s64 = _wkv_fp64(r, k, v, w, u, s0, heads)
        errs64 = [(out[0, :, heads].double() - y64).abs().max().item()
                  for out in (y, want_y)]
        serrs64 = [(out[0, heads].double() - s64).abs().max().item()
                   for out in (s, want_s)]
        elt = r.element_size()
        nbytes = (4 * b * t * h * n * elt + 4 * b * t * h * n + 4 * h * n
                  + 2 * 4 * b * h * n * n)
        flops = b * t * h * (5 * n * n + 5 * n)
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
        ms = _time_ms(lambda: wkv_ops.wkv6(r, k, v, w, u, s0))
        rows.append(dict(
            WKV_KERNEL, case=f"{name}/{str(dt).split('.')[1]}",
            path="rwkv6-3b", shape=dict(B=b, T=t, H=h, N=n,
                                        s0="random" if nonzero_s0 else "0",
                                        decay="extreme" if extreme
                                        else "(0.45, 0.95)"),
            chunks=wkv_ops.wkv6_plan(b, t, h, n).chunks,
            max_abs_err=err, max_err=err, s_end_err=s_err,
            bitwise_equal=same_bits,
            tol=dict(y_rtol=rtol, s_end_rtol=1e-4, atol=1e-4),
            err_fp64=errs64[0], plain_err_fp64=errs64[1],
            s_end_err_fp64=serrs64[0], plain_s_end_err_fp64=serrs64[1],
            ms=ms, kernel_ms=ms,
            plain_ms=_time_ms(lambda: wkv6_plain(r, k, v, w, u, s0), reps=5,
                              warmup=1),
            library_ms=None,
            library="none: no single PyTorch call computes WKV-6",
            device_ms=_device_ms(lambda: wkv_ops.wkv6(r, k, v, w, u, s0)),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations"))
        print(f"kernel wkv6 {rows[-1]['case']} B={b} T={t}: y err {err}, "
              f"s_end err {s_err} (rtol {rtol}; against fp64 on 4 heads: "
              f"kernel {errs64[0]} / {serrs64[0]}, plain {errs64[1]} / "
              f"{serrs64[1]}; bitwise equal {same_bits}), {ms} ms, plain "
              f"{rows[-1]['plain_ms']} ms, "
              f"device {rows[-1]['device_ms']} ms, "
              f"bound {rows[-1]['bound_ms']} ms ({rows[-1]['bound_by']})")
    return rows


def phase_scan_kernel(seed: int) -> list:
    """prefix_scan against its plain version.  Tolerances: int32 exact;
    floats within 1e-6 of the row's sum of |x| (the same sums in another
    order, fp32), bf16 also within one bf16 ulp of the output (2^-7
    relative: each output is rounded to bf16).  Each case runs twice: a
    float carry's grouping follows the look-back's timing, so floats may
    differ in the last bits between runs; int32 may not."""
    g = torch.Generator(device="cuda").manual_seed(seed + 3)
    cases = [("bench_small", torch.float32, 4, 1024),
             ("bench_large", torch.float32, 8, 8192),
             ("many_rows", torch.float32, 4096, 4096),
             ("many_rows", torch.int32, 4096, 4096),
             ("many_rows", torch.bfloat16, 4096, 4096),
             ("few_long_rows", torch.float32, 4, 1 << 22),
             ("ragged_long_row", torch.float32, 1, (1 << 20) + 13),
             ("one_long_row", torch.float32, 1, 1 << 24),
             ("one_long_row", torch.int32, 1, 1 << 24)]
    rows = []
    for name, dt, r, n in cases:
        if dt == torch.int32:
            x = torch.randint(-50, 51, (r, n), generator=g, device="cuda",
                              dtype=torch.int32)
        else:
            x = torch.randn(r, n, generator=g, device="cuda").to(dt)
        got = scan_ops.prefix_scan(x)
        again = scan_ops.prefix_scan(x)
        torch.cuda.synchronize()
        want = prefix_scan_plain(x)
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs().max().item()
        rerun_diff = (got.double() - again.double()).abs().max().item()
        if dt == torch.int32 and not torch.equal(got, again):
            raise AssertionError(f"prefix_scan {name} int32: two runs differ "
                                 f"by {rerun_diff}")
        plan = scan_ops.scan_plan(r, n)
        err64 = plain_err64 = None
        if dt == torch.int32:
            ok, tol = torch.equal(got, want), "exact"
        else:
            bound = 1e-6 * x.float().abs().sum(-1, keepdim=True)
            rtol = 2 ** -7 if dt == torch.bfloat16 else 0.0
            ok = _within(got, want, rtol, bound)
            tol = dict(atol="1e-6 * row sum |x|", rtol=rtol)
            exact = torch.cumsum(x.double(), -1)
            err64, plain_err64 = ((out.double() - exact).abs().max().item()
                                  for out in (got, want))
            del exact
        if not ok:
            raise AssertionError(f"prefix_scan {name} {dt}: max error {err}")
        acc = acc_dtype(dt)
        nbytes = 2 * x.numel() * x.element_size()
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        # one add per element on the CUDA cores (int32 counted at the fp32
        # rate; the adds never bind here)
        t_ops = x.numel() / PEAK_FLOPS[torch.float32] * 1e3
        ms = _time_ms(lambda: scan_ops.prefix_scan(x))
        rows.append(dict(
            SCAN_KERNEL, case=f"{name}/{str(dt).split('.')[1]}",
            path=SCAN_PATH,
            shape=dict(R=r, N=n), tile=f"{plan.block}x{plan.items}",
            tiles_per_row=plan.tiles_per_row, max_abs_err=err, max_err=err,
            rerun_diff=rerun_diff, tol=tol,
            err_fp64=err64, plain_err_fp64=plain_err64, ms=ms, kernel_ms=ms,
            plain_ms=_time_ms(lambda: prefix_scan_plain(x)),
            library_ms=_time_ms(lambda: torch.cumsum(x, -1, dtype=acc)),
            library=f"torch.cumsum(x, -1, dtype={acc})",
            device_ms=_device_ms(lambda: scan_ops.prefix_scan(x)),
            library_device_ms=_device_ms(
                lambda: torch.cumsum(x, -1, dtype=acc)),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations"))
        print(f"kernel prefix_scan {rows[-1]['case']} R={r} N={n} "
              f"({plan.tiles_per_row} tiles of {rows[-1]['tile']} a row): "
              f"max_err {err} ({tol}; against fp64: kernel {err64}, plain "
              f"{plain_err64}; between two runs {rerun_diff}), {ms} ms, "
              f"plain {rows[-1]['plain_ms']} ms, "
              f"cumsum {rows[-1]['library_ms']} ms; device "
              f"{rows[-1]['device_ms']} ms, cumsum "
              f"{rows[-1]['library_device_ms']} ms; bound "
              f"{rows[-1]['bound_ms']} ms ({rows[-1]['bound_by']})")
        del x, got, again, want
    torch.cuda.empty_cache()
    return rows


def phase_scan_path(seed: int) -> dict:
    """The prefix scan's path: ``prefix_scan`` on kernel_bench's fp32
    (4, 1024) and (8, 8192) and beyond_paper's int32 arange(2^14) as
    (4, 4096); int32 exact, fp32 within 1e-6 of the row's sum of |x|."""
    g = torch.Generator(device="cuda").manual_seed(seed + 4)
    inputs = [torch.randn(4, 1024, generator=g, device="cuda"),
              torch.randn(8, 8192, generator=g, device="cuda"),
              torch.arange(1 << 14, dtype=torch.int32,
                           device="cuda").reshape(4, -1)]
    _zero_counts()
    outs = [scan_ops.prefix_scan(x) for x in inputs]
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in COUNTERS.items()}
    if launches != dict(dict.fromkeys(COUNTERS, 0),
                        prefix_scan=len(inputs)):
        raise AssertionError(f"prefix-scan path launches: {launches}")
    for x, out in zip(inputs, outs):
        want = prefix_scan_plain(x)
        ok = torch.equal(out, want) if x.dtype == torch.int32 else _within(
            out, want, 0.0, 1e-6 * x.abs().sum(-1, keepdim=True))
        if not ok:
            raise AssertionError(f"prefix-scan path {tuple(x.shape)} "
                                 f"{x.dtype}: wrong")
    stats = dict(arch=SCAN_PATH, inputs=[[*x.shape, str(x.dtype)]
                                         for x in inputs],
                 launches=launches)
    print("scan path: " + json.dumps(stats))
    return stats


def _prompts(rng, n, vocab, longest=1024):
    return [rng.integers(0, vocab, int(rng.integers(64, longest + 1)))
            for _ in range(n)]


class _Phase:
    """Wraps an engine call: device-synchronized seconds, calls, each
    kernel's launches (wrapper calls and kernels) inside it, and a
    finite-logits check.  While it runs, ``_Phase.current`` holds its
    ``name`` (read by ``_GmmTimer``)."""

    current = None

    def __init__(self, fn, name=None):
        self.fn, self.name, self.seconds, self.calls = fn, name, 0.0, 0
        self.launches = dict.fromkeys(COUNTERS, 0)
        self.kernel_launches = dict.fromkeys(COUNTERS, 0)

    def __call__(self, *args):
        n0 = {k: c.launches for k, c in COUNTERS.items()}
        k0 = _kernel_launches()
        t0 = time.perf_counter()
        _Phase.current = self.name
        logits, cache = self.fn(*args)
        _Phase.current = None
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite logits")
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        k1 = _kernel_launches()
        for k, c in COUNTERS.items():
            self.launches[k] += c.launches - n0[k]
            self.kernel_launches[k] += k1[k] - k0[k]
        return logits, cache


def phase_main_path(model, params, prompts, *, s_max, max_new, kv_mode,
                    kernels) -> dict:
    """Serve ``prompts`` through the engine in ``kv_mode``.  ``kernels``
    maps a kernel to (in prefill, in decode): where True it must be
    launched once a layer in every call, where False never."""
    eng = ServingEngine(model, params, max_batch=8, s_max=s_max,
                        block_size=16, kv_mode=kv_mode)
    prefill, decode = _Phase(eng._prefill), _Phase(eng._decode)
    eng._prefill, eng._decode = prefill, decode
    reqs = [eng.submit(p, max_new_tokens=max_new, priority=float(i % 3))
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    outs = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in COUNTERS.items()}
    kernel_launches = _kernel_launches()
    if not all(r.state.name == "DONE" for r in reqs):
        raise AssertionError("not every request finished")
    if eng.paged:
        eng.alloc.check()
    layers = model.cfg.num_layers
    for k, (in_prefill, in_decode) in kernels.items():
        p_n, d_n = prefill.launches[k], decode.launches[k]
        want = (layers * prefill.calls * in_prefill,
                layers * decode.calls * in_decode)
        if (p_n, d_n) != want or want == (0, 0) \
                or launches[k] != p_n + d_n:
            raise AssertionError(f"{k} launches: prefill {p_n}, decode "
                                 f"{d_n}, total {launches[k]}; expected "
                                 f"{want}")
    tokens = sum(len(outs[r.rid]) for r in reqs)
    if tokens != max_new * len(reqs):
        raise AssertionError(f"{tokens} tokens for {len(reqs)} requests")
    stats = dict(arch=model.cfg.name, layers=layers, kv_mode=eng.kv_mode,
                 requests=len(reqs), tokens=tokens, wall_s=wall,
                 tokens_per_s=tokens / wall, prefill_s=prefill.seconds,
                 prefill_calls=prefill.calls,
                 decode_steps=decode.calls,
                 decode_step_ms=decode.seconds / decode.calls * 1e3,
                 launches=launches, launches_prefill=prefill.launches,
                 launches_decode=decode.launches,
                 kernel_launches=kernel_launches,
                 kernel_launches_prefill=prefill.kernel_launches,
                 kernel_launches_decode=decode.kernel_launches,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                 prompt_tokens=int(sum(len(p) for p in prompts)))
    print("main path: " + json.dumps(stats))
    return stats


def phase_paged_equals_contiguous(model, params, prompts, s_max) -> None:
    results = {}
    for mode in ("contiguous", "paged"):
        eng = ServingEngine(model, params, max_batch=8, s_max=s_max,
                            block_size=16, kv_mode=mode)
        reqs = [eng.submit(p, max_new_tokens=16, priority=float(i % 3))
                for i, p in enumerate(prompts)]
        outs = eng.run_until_drained()
        if not all(r.state.name == "DONE" for r in reqs):
            raise AssertionError(f"{mode}: not every request finished")
        results[mode] = [outs[r.rid] for r in reqs]
    if results["paged"] != results["contiguous"]:
        raise AssertionError(f"{model.cfg.name}: paged and contiguous "
                             "tokens differ")
    print(f"paged == contiguous ({model.cfg.name}): {len(prompts)} requests, "
          f"{sum(map(len, results['paged']))} identical tokens")


class _GmmTimer:
    """Stands in for ``models.moe.grouped_swiglu`` during a speculative
    run: calls the wrapper and records, by the ``_Phase`` it ran in, the
    dispatch rows C of each call and its device time (CUDA events around
    the call)."""

    def __init__(self, fn):
        self.fn = fn
        self.rows, self.events = {}, {}

    def __call__(self, x, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(x, *args)
        end.record()
        self.rows.setdefault(_Phase.current, set()).add(int(x.shape[1]))
        self.events.setdefault(_Phase.current, []).append((start, end))
        return out

    def summary(self) -> dict:
        torch.cuda.synchronize()
        out = {}
        for name, pairs in self.events.items():
            ms = [s.elapsed_time(e) for s, e in pairs]
            out[name] = dict(calls=len(ms), C=sorted(self.rows[name]),
                             mean_ms=statistics.fmean(ms),
                             median_ms=statistics.median(ms))
        return out


def _spec_run(model, params, prompts, *, s_max, max_new, spec):
    """Serve ``prompts`` through the paged engine, with ``spec`` (a
    Speculator) or without; every engine and speculator call wrapped in a
    ``_Phase``, the counts set to 0 just before the run and read just
    after.  Checks: every request DONE with ``max_new`` tokens, the
    allocator's invariants."""
    eng = ServingEngine(model, params, max_batch=8, s_max=s_max,
                        block_size=16, kv_mode="paged", speculator=spec)
    phases = {"prefill": _Phase(eng._prefill, "prefill"),
              "decode": _Phase(eng._decode, "decode")}
    eng._prefill, eng._decode = phases["prefill"], phases["decode"]
    if spec is not None:
        phases.update(warm=_Phase(spec._prefill, "warm"),
                      draft=_Phase(spec._decode, "draft"),
                      verify=_Phase(spec._verify, "verify"))
        spec._prefill, spec._decode, spec._verify = (
            phases["warm"], phases["draft"], phases["verify"])
    reqs = [eng.submit(p, max_new_tokens=max_new, priority=float(i % 3))
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    outs = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in COUNTERS.items()}
    if not all(r.state.name == "DONE" for r in reqs):
        raise AssertionError("not every request finished")
    eng.alloc.check()
    tokens = [outs[r.rid] for r in reqs]
    if any(len(t) != max_new for t in tokens):
        raise AssertionError(f"token counts {[len(t) for t in tokens]}, "
                             f"expected {max_new} each")
    for k in COUNTERS:
        if launches[k] != sum(ph.launches[k] for ph in phases.values()):
            raise AssertionError(f"{k}: {launches[k]} launches, not all "
                                 "inside the engine's calls")
    n = sum(map(len, tokens))
    stats = dict(tokens=n, wall_s=wall, tokens_per_s=n / wall,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                 launches=launches,
                 phases={name: dict(calls=ph.calls, seconds=ph.seconds,
                                    ms_per_call=ph.seconds / ph.calls * 1e3
                                    if ph.calls else None,
                                    launches=ph.launches,
                                    kernel_launches=ph.kernel_launches)
                         for name, ph in phases.items()})
    if spec is not None:
        stats["spec_stats"] = eng.spec_stats
    return tokens, stats, phases


def _same_share(got, want) -> float:
    """Share of tokens equal, position by position, to ``want``'s."""
    same = sum(a == b for g, w in zip(got, want) for a, b in zip(g, w))
    return same / sum(map(len, want))


def phase_spec(model, params, prompts, *, s_max, max_new, drafts,
               moe=False) -> dict:
    """Speculative decoding at full width: the plain paged engine, then one
    engine for each of ``drafts`` ((name, Speculator, least acceptance or
    None)) on the same prompts.  Checks, beyond ``_spec_run``'s: rounds >
    0; the self draft's acceptance at least its bound, a cross draft's
    wasted > 0; flash attention launched once a layer in every draft step
    and never in a verify call; with ``moe``, grouped SwiGLU once a layer
    in every verify call and its dispatch reaching C = B (k + 1).  The share
    of tokens equal to the plain engine's is printed, not asserted: verify
    takes the masked path, plain decode the split kernel (P rounded to
    bf16 before PV)."""
    layers = model.cfg.num_layers
    timer = _GmmTimer(moe_mod.grouped_swiglu) if moe else None
    out = {}
    plain = None
    for name, spec, least in [("plain", None, None)] + drafts:
        if timer is not None:
            timer.rows, timer.events = {}, {}
            moe_mod.grouped_swiglu = timer
        try:
            tokens, stats, ph = _spec_run(model, params, prompts,
                                          s_max=s_max, max_new=max_new,
                                          spec=spec)
        finally:
            if timer is not None:
                moe_mod.grouped_swiglu = timer.fn
        if timer is not None:
            stats["grouped_swiglu"] = timer.summary()
        if spec is None:
            plain = tokens
        else:
            s = stats["spec_stats"]
            stats["same_as_plain"] = _same_share(tokens, plain)
            if s["rounds"] == 0:
                raise AssertionError(f"{name}: no speculation round")
            if least is not None and not s["acceptance_rate"] >= least:
                raise AssertionError(f"{name}: acceptance "
                                     f"{s['acceptance_rate']} < {least}")
            if least is None and s["wasted"] == 0:
                raise AssertionError(f"{name}: the cross draft wasted "
                                     "nothing")
            draft, verify = ph["draft"], ph["verify"]
            if draft.launches["flash_attention"] != layers * draft.calls \
                    or verify.launches["flash_attention"] != 0:
                raise AssertionError(
                    f"{name}: flash launches {draft.launches} in "
                    f"{draft.calls} draft steps, {verify.launches} in "
                    f"{verify.calls} verify calls")
            if moe:
                want_c = len(spec.engine.slot_req) * (spec.adapt.k0 + 1)
                if verify.launches["grouped_swiglu"] != \
                        layers * verify.calls:
                    raise AssertionError(
                        f"{name}: grouped SwiGLU {verify.launches} in "
                        f"{verify.calls} verify calls")
                if want_c not in stats["grouped_swiglu"]["verify"]["C"]:
                    raise AssertionError(
                        f"{name}: verify's dispatch rows "
                        f"{stats['grouped_swiglu']['verify']['C']}, never "
                        f"{want_c}")
        out[name] = stats
        print(f"spec {model.cfg.name} {name}: " + json.dumps(stats))
    return out


def _top2_gap(model, params, context) -> tuple:
    """The target's (top-1 - top-2 logit, largest |logit|) after
    ``context``, from a prefill."""
    toks = torch.as_tensor(np.asarray(context)[None, :], device=model.device)
    logits = model.prefill(params, {"tokens": toks})[0][0, -1].float()
    top = torch.topk(logits, 2).values
    return (top[0] - top[1]).item(), logits.abs().max().item()


def _noisy(params, scale, seed, device):
    """``params`` plus N(0, scale * std) noise on every leaf."""
    g = torch.Generator(device=device).manual_seed(seed)

    def go(tree):
        if isinstance(tree, dict):
            return {k: go(v) for k, v in tree.items()}
        std = tree.float().std().item() if tree.numel() > 1 else 0.0
        noise = torch.randn(tree.shape, generator=g, device=device)
        return (tree.float() + scale * std * noise).to(tree.dtype)
    return go(params)


def phase_spec_exact(model, params, prompts, *, s_max, max_new,
                     seed) -> dict:
    """The greedy contract on the card (fp32, flash off: plain decode and
    verify both take the masked path).  The plain engine, then a self, a
    cross (seed + 1) and a partial draft (the target's weights with seeded
    noise, the first of PARTIAL_NOISE that gives a round with 0 < matched
    < k); each must emit the plain engine's tokens.  At a request's first
    differing token the target's top-2 gap is taken: under TIE_REL of the
    row's largest |logit| it is recorded as a tie, else the phase fails.
    The self draft's acceptance must be 1."""
    plain, _, _ = _spec_run(model, params, prompts, s_max=s_max,
                            max_new=max_new, spec=None)
    out = dict(prompts=[len(p) for p in prompts], drafts={})
    rounds = []
    accept = speculative.accept_longest_prefix

    def record(proposals, target):
        accepted, matched = accept(proposals, target)
        rounds.append((matched, len(proposals)))
        return accepted, matched

    def run(name, dparams, **kw):
        rounds.clear()
        speculative.accept_longest_prefix = record
        try:
            tokens, stats, _ = _spec_run(
                model, params, prompts, s_max=s_max, max_new=max_new,
                spec=Speculator(model, dparams, k=SPEC_K, **kw))
        finally:
            speculative.accept_longest_prefix = accept
        ties = []
        for p, got, want in zip(prompts, tokens, plain):
            j = next((i for i, (a, b) in enumerate(zip(got, want))
                      if a != b), None)
            if j is None:
                continue
            gap, top = _top2_gap(model, params, list(p) + want[:j])
            ties.append(dict(position=j, plain=want[j], spec=got[j],
                             gap=gap, max_abs_logit=top))
            if not gap < TIE_REL * top:
                raise AssertionError(f"{name}: token {j} differs ({got[j]} "
                                     f"against {want[j]}) with a top-2 gap "
                                     f"of {gap} (max |logit| {top})")
        stats.update(ties=ties, partial_rounds=sum(
            1 for m, k in rounds if 0 < m < k), rounds_matched=list(rounds))
        out["drafts"][name] = stats
        print(f"spec exact {name}: " + json.dumps(
            dict(spec_stats=stats["spec_stats"], ties=ties,
                 partial_rounds=stats["partial_rounds"])))
        return stats

    s = run("self", params)
    if s["spec_stats"]["acceptance_rate"] != 1.0:
        raise AssertionError(f"fp32 self draft acceptance "
                             f"{s['spec_stats']['acceptance_rate']}")
    dparams = model.init(seed + 1)
    run("cross", dparams, adaptive=True)
    del dparams
    for scale in PARTIAL_NOISE:
        dparams = _noisy(params, scale, seed, model.device)
        s = run(f"partial_{scale}", dparams, adaptive=False)
        del dparams
        if s["partial_rounds"] > 0:
            break
    else:
        raise AssertionError(f"no noise of {PARTIAL_NOISE} gave a round "
                             "with 0 < matched < k")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_verify_probe(model, params, prompts, *, s_max, seed,
                       bound=None) -> dict:
    """One batch state (the prompts prefilled into the pool, every slot
    busy, mixed positions): ``verify_paged`` on c = SPEC_K + 1 tokens
    against as many sequential ``decode_step_paged`` calls, each on its own
    copy of the pool.  Per row i: max |difference| of the logits over its
    largest |logit|, and the share of equal argmaxes.  With ``bound``,
    every relative difference must be within it."""
    eng = ServingEngine(model, params, max_batch=8, s_max=s_max,
                        block_size=16, kv_mode="paged")
    for i, p in enumerate(prompts):
        eng.submit(p, max_new_tokens=16, priority=float(i % 3))
    for _ in range(64):
        if all(r is not None for r in eng.slot_req):
            break
        eng.step()
    else:
        raise AssertionError("slots never all busy")
    c = SPEC_K + 1
    b = len(eng.slot_req)
    dev = model.device
    pos = torch.as_tensor(eng.slot_pos, device=dev)
    if int(pos.max()) + c > eng.cap:
        raise AssertionError("probe positions past the ring")
    for i, r in enumerate(eng.slot_req):
        eng.alloc.ensure(r.rid, int(eng.slot_pos[i]) + c)
    table = torch.as_tensor(np.stack([eng._table_row(r.rid)
                                      for r in eng.slot_req]), device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, model.cfg.vocab_size, (b, c), generator=g,
                           device=dev)
    tokens[:, 0] = torch.as_tensor(eng.last_token[:, 0], device=dev)

    def pool():
        return PagedKVCache(eng.cache.k.clone(), eng.cache.v.clone())
    verify = model.verify_paged(params, tokens, pool(), table, pos)[0]
    cache = pool()
    rel, agree = [], []
    for i in range(c):
        step, cache = model.decode_step_paged(params, tokens[:, i:i + 1],
                                              cache, table, pos + i)
        a, d = verify[:, i].float(), step[:, 0].float()
        rel.append(((a - d).abs().max() / d.abs().max()).item())
        agree.append((a.argmax(-1) == d.argmax(-1)).float().mean().item())
    out = dict(dtype=str(model.cfg.dtype), use_flash=model.cfg.use_flash,
               positions=eng.slot_pos.tolist(), rel_max_abs_diff=rel,
               argmax_agree=agree, bound=bound)
    print(f"verify probe {model.cfg.name} {model.cfg.dtype} "
          f"flash={model.cfg.use_flash}: " + json.dumps(out))
    if bound is not None and not max(rel) <= bound:
        raise AssertionError(f"verify vs sequential decode: {rel} > {bound}")
    del eng, cache, verify
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def phase_rwkv_checks(model, params, prompts) -> dict:
    """The two checks that take paged == contiguous's place for RWKV-6 (no
    paged path), on the last logits of each prompt.

    * State hand-off, bf16: prefill(p + [t]) against prefill(p) then
      decode_step(t), within the reference's bf16 bound of 0.25.
    * Route: the kernel (use_flash) against the chunked scan.  In bf16 at
      32 layers the two routes' roundings differ by more than 0.25 on
      random weights, while each stays as far from the fp32 logits as the
      other; so the route is held in fp32 (the same weights, cast), where
      both sum the same fp32 products in other orders, within 1e-3; and in
      bf16 the kernel route's distance from the fp32 logits must stay
      within 1.5 times the scan route's."""
    cfg = model.cfg
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    params32 = _cast_tree(params, torch.float32)
    routes = {"kernel_bf16": (model, params),
              "scan_bf16": (build_model(cfg.replace(use_flash=False),
                                        model.device), params),
              "kernel_fp32": (build_model(cfg32, model.device), params32),
              "scan_fp32": (build_model(cfg32.replace(use_flash=False),
                                        model.device), params32)}
    out = dict(prompts=[len(p) for p in prompts], handoff_err=[],
               route_err_fp32=[], route_err_bf16=[],
               kernel_bf16_to_fp32=[], scan_bf16_to_fp32=[],
               handoff_bound=BF16_LOGIT_TOL, route_bound_fp32=ROUTE_TOL_FP32)
    for p in prompts:
        toks = torch.as_tensor(p[None, :], device="cuda")
        logits = {}
        for name, (m, prm) in routes.items():
            n0 = wkv_ops.wkv6.launches
            logits[name] = m.prefill(prm, {"tokens": toks})[0].float()
            launched = wkv_ops.wkv6.launches - n0
            if launched != (cfg.num_layers if m.cfg.use_flash else 0):
                raise AssertionError(f"{name}: wkv6 launched {launched} "
                                     "times in one prefill")
        _, state = model.prefill(params, {"tokens": toks[:, :-1]})
        stepped, _ = model.decode_step(params, toks[:, -1:], state,
                                       toks.shape[1] - 1)
        for x in (*logits.values(), stepped):
            if not torch.isfinite(x).all():
                raise AssertionError("non-finite logits")

        def dist(a, b):
            return (a - b).abs().max().item()
        exact = logits["kernel_fp32"]
        out["handoff_err"].append(dist(logits["kernel_bf16"],
                                       stepped.float()))
        out["route_err_fp32"].append(dist(exact, logits["scan_fp32"]))
        out["route_err_bf16"].append(dist(logits["kernel_bf16"],
                                          logits["scan_bf16"]))
        out["kernel_bf16_to_fp32"].append(dist(logits["kernel_bf16"], exact))
        out["scan_bf16_to_fp32"].append(dist(logits["scan_bf16"], exact))
    print("rwkv checks: " + json.dumps(out))
    if max(out["handoff_err"]) >= BF16_LOGIT_TOL:
        raise AssertionError(f"rwkv6-3b state hand-off: {out['handoff_err']}"
                             f" (bound {BF16_LOGIT_TOL})")
    if max(out["route_err_fp32"]) >= ROUTE_TOL_FP32:
        raise AssertionError(f"rwkv6-3b fp32 route: {out['route_err_fp32']}"
                             f" (bound {ROUTE_TOL_FP32})")
    if any(k > 1.5 * sc for k, sc in zip(out["kernel_bf16_to_fp32"],
                                         out["scan_bf16_to_fp32"])):
        raise AssertionError("rwkv6-3b bf16: the kernel route is farther "
                             "from the fp32 logits than 1.5x the scan's")
    del routes, params32
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _init(cfg, seed):
    model = build_model(cfg, "cuda")
    t0 = time.perf_counter()
    params = model.init(seed)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    print(f"model: {cfg.name} L={cfg.num_layers} d={cfg.d_model} "
          f"heads={cfg.num_heads}/{cfg.num_kv_heads} hd={cfg.head_dim} "
          f"d_ff={cfg.d_ff} experts={cfg.num_experts}/"
          f"{cfg.num_experts_per_tok} window={cfg.sliding_window} "
          f"vocab={cfg.vocab_size} {cfg.dtype}, {n_params} params, init "
          f"{time.perf_counter() - t0} s, allocated "
          f"{torch.cuda.memory_allocated() / 1e9} GB")
    return model, params


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    smi = phase_device()
    phase_build()
    flash_rows = phase_kernels(args.seed)
    phase_flash_probe()
    gmm_rows = phase_gmm_kernel(args.seed)
    wkv_rows = phase_wkv6_kernel(args.seed)
    scan_rows = phase_scan_kernel(args.seed)
    scan_path = phase_scan_path(args.seed)
    rng = np.random.default_rng(args.seed)

    # main path 1: qwen2-1.5b at full depth
    cfg = get_config("qwen2-1.5b").replace(use_flash=True)
    model, params = _init(cfg, args.seed)
    prompts = _prompts(rng, 16, cfg.vocab_size)
    qwen = phase_main_path(model, params, prompts, s_max=2048, max_new=32,
                           kv_mode="paged",
                           kernels={"flash_attention": (True, True)})
    phase_paged_equals_contiguous(model, params, prompts[:4], 2048)
    spec = dict(probe={})
    cross = model.init(args.seed + 1)
    spec["qwen2-1.5b"] = phase_spec(
        model, params, prompts[:8], s_max=2048, max_new=32, drafts=[
            ("self", Speculator(model, params, k=SPEC_K), SELF_ACCEPT_MIN),
            ("cross", Speculator(model, cross, k=SPEC_K, adaptive=True),
             None)])
    del cross
    spec["probe"]["bf16_flash"] = phase_verify_probe(
        model, params, prompts[:8], s_max=2048, seed=args.seed)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()

    # the greedy contract on the card: qwen2-1.5b at full width, 4 layers,
    # fp32, flash off (verify and plain decode on the same masked path)
    cfg = get_config("qwen2-1.5b").replace(
        num_layers=4, dtype="float32", param_dtype="float32",
        use_flash=False)
    model, params = _init(cfg, args.seed)
    spec["qwen2-1.5b_fp32_exact"] = phase_spec_exact(
        model, params, prompts[:4], s_max=2048, max_new=16, seed=args.seed)
    spec["probe"]["fp32"] = phase_verify_probe(
        model, params, prompts[:8], s_max=2048, seed=args.seed,
        bound=PROBE_TOL_FP32)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()

    # main path 2: Mixtral-8x22B at full width, 8 of its 56 layers
    cfg = get_config("mixtral-8x22b").replace(num_layers=8, use_flash=True)
    model, params = _init(cfg, args.seed)
    prompts = _prompts(rng, 8, cfg.vocab_size, longest=512)
    mixtral = phase_main_path(model, params, prompts, s_max=1024,
                              max_new=16, kv_mode="paged",
                              kernels={"flash_attention": (True, True),
                                       "grouped_swiglu": (True, True)})
    phase_paged_equals_contiguous(model, params, prompts[:4], 1024)
    spec["mixtral-8x22b"] = phase_spec(
        model, params, prompts, s_max=1024, max_new=16, moe=True, drafts=[
            ("self", Speculator(model, params, k=SPEC_K, adaptive=False),
             MOE_SELF_ACCEPT_MIN)])
    spec["probe"]["mixtral_bf16_flash"] = phase_verify_probe(
        model, params, prompts, s_max=1024, seed=args.seed)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    # the same probe in fp32 at full width, 2 of 56 layers, through the
    # kernels (fp32 grouped SwiGLU at verify's C = 40 and decode's C = 8,
    # flash's split decode): what bf16 rounding hides must hold here
    cfg = get_config("mixtral-8x22b").replace(
        num_layers=2, dtype="float32", param_dtype="float32", use_flash=True)
    model, params = _init(cfg, args.seed)
    spec["probe"]["mixtral_fp32_flash"] = phase_verify_probe(
        model, params, prompts, s_max=1024, seed=args.seed,
        bound=PROBE_TOL_FP32)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()

    # main path 3: rwkv6-3b at full depth and width, contiguous state cache
    cfg = get_config("rwkv6-3b").replace(use_flash=True)
    model, params = _init(cfg, args.seed)
    prompts = _prompts(rng, 8, cfg.vocab_size)
    rwkv = phase_main_path(model, params, prompts, s_max=2048, max_new=32,
                           kv_mode="contiguous",
                           kernels={"wkv6": (True, False)})
    phase_rwkv_checks(model, params, prompts[:4])

    # each row carries its kernel's launches on the path it was sized for
    # (the fp32 and synthetic-mask rows: the path whose heads they use)
    by_path = {p["arch"]: p["launches"]
               for p in (qwen, mixtral, rwkv, scan_path)}
    rows = flash_rows + gmm_rows + wkv_rows + scan_rows
    for row in rows:
        row["launches"] = by_path[row["path"]][row["name"]]
    print(json.dumps({"kernels": rows, "spec": spec}))
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
