"""Where a WKV-6 launch spends its time on the card, phase by phase.

    PYTHONPATH=src python -m repro_torch.launch.profile_wkv6 \
        --out build/profile_wkv6.json

Builds an instrumented copy of ``kernels/wkv6/csrc/wkv6.cu`` (into
``build/kernels/``, beside the real library): before each phase comment of
the kernel (``// 1a.`` .. ``// 3.``) every CTA meets a barrier and its first
thread reads the SM's cycle counter, and at its start and end the global
timer.  The barriers add a little to each phase; the real kernel's device
time is ``chip_smoke.py``'s.  Runs the kernel at rwkv6-3b's heads (H = 40,
N = 64) on the rows of ``chip_smoke.py``'s WKV-6 phase and prints, per row,
each phase's median and largest cycles over the CTAs, the chain phase's
median by chunk index (its wait for the predecessor), the median CTA life,
the launch's span and when the CTAs started.  Needs a CUDA device and
``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys

import torch

from ..kernels._build import BUILD_DIR, _NVCC_FLAGS, _nvcc
from ..kernels.wkv6.build import LIBRARY
from ..kernels.wkv6.ops import wkv6_plan

#: the kernel's phase comments, in order (1b covers 1c: for bf16 inputs a
#: warp goes on to its scans while others finish their diagonal block)
PHASES = ["1a", "1b", "1d", "1e", "1f", "2", "3"]
_SLOTS = 16        # words a CTA: cycles at each mark, then two timer reads

_HOOKS = """
__device__ long long g_wkv6_prof[1 << 20];
#define WKV6_MARK(K) do { __syncthreads(); if (threadIdx.x == 0) \\
    g_wkv6_prof[blockIdx.x * %d + (K)] = clock64(); } while (0)
#define WKV6_TIME(K) do { if (threadIdx.x == 0) { long long t_; \\
    asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t_)); \\
    g_wkv6_prof[blockIdx.x * %d + (K)] = t_; } } while (0)
""" % (_SLOTS, _SLOTS)


def instrumented_source() -> str:
    """The kernel's source with a mark before each phase and after the
    last, and the global timer at the CTA's start and end."""
    src = LIBRARY.source.read_text()
    for i, phase in enumerate(PHASES):
        pat = re.compile(rf"^(  // {phase}\. )", re.M)
        if len(pat.findall(src)) != 1:
            raise RuntimeError(f"phase comment // {phase}. not found once")
        src = pat.sub(rf"  WKV6_MARK({i});\n\1", src)
    # the CTA's ticket: which (b, h, chunk) it took
    src = src.replace("  WKV6_MARK(0);\n", "  WKV6_MARK(0);\n  if (threadIdx.x "
                      f"== 0) g_wkv6_prof[blockIdx.x * {_SLOTS} + "
                      f"{_SLOTS - 3}] = ticket;\n", 1)
    kernel = src.index("wkv6_chunk_kernel(")
    body = src.index("{", kernel)
    end = src.index("\n}\n", body)
    src = (src[:body + 1] + f"\n  WKV6_TIME({_SLOTS - 2});" + src[body + 1:end]
           + f"\n  WKV6_MARK({len(PHASES)});\n  WKV6_TIME({_SLOTS - 1});"
           + src[end:])
    src = src.replace("namespace {", _HOOKS + "namespace {", 1)
    return src.replace('extern "C" {', 'extern "C" {\nint wkv6_prof_read('
                       'void* dst, long bytes) { return (int)cudaMemcpy'
                       'FromSymbol(dst, g_wkv6_prof, bytes); }', 1)


def build() -> ctypes.CDLL:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = BUILD_DIR / "wkv6_phases.cu"
    so = BUILD_DIR / "libwkv6_phases.so"
    cu.write_text(instrumented_source())
    proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_fwd.argtypes = [i, i] + [p] * 9 + [i, i, i, p]
    lib.wkv6_fwd.restype = i
    lib.wkv6_prof_read.argtypes = [p, ctypes.c_long]
    lib.wkv6_prof_read.restype = i
    return lib


def profile_row(lib, b, t, dtype, seed, reps=3) -> dict:
    h, n = 40, 64
    g = torch.Generator(device="cuda").manual_seed(seed)
    r, k, v = (torch.randn(b, t, h, n, generator=g, device="cuda").to(dtype)
               for _ in range(3))
    w = 0.45 + 0.5 * torch.sigmoid(torch.randn(b, t, h, n, generator=g,
                                               device="cuda"))
    u = 0.1 * torch.randn(h, n, generator=g, device="cuda")
    s0 = torch.randn(b, h, n, n, generator=g, device="cuda")
    plan = wkv6_plan(b, t, h, n)
    if plan.ctas * _SLOTS > 1 << 20:
        raise ValueError(f"{plan.ctas} CTAs exceed the profile buffer")
    y = torch.empty_like(r)
    s_end = torch.empty(b, h, n, n, device="cuda")
    for _ in range(reps):     # the last launch is the one read
        chain = torch.zeros(max(plan.chain_words, 1), dtype=torch.int64,
                            device="cuda")
        code = lib.wkv6_fwd(
            1 if dtype == torch.bfloat16 else 0, n, r.data_ptr(),
            k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            s0.data_ptr(), y.data_ptr(), s_end.data_ptr(), chain.data_ptr(),
            b, t, h, torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"launch failed: {code}")
        torch.cuda.synchronize()
    prof = torch.zeros(plan.ctas, _SLOTS, dtype=torch.int64)
    if lib.wkv6_prof_read(prof.data_ptr(), prof.numel() * 8) != 0:
        raise RuntimeError("could not read the profile")
    marks = prof[:, :len(PHASES) + 1].double()
    cycles = marks[:, 1:] - marks[:, :-1]
    start, end = prof[:, _SLOTS - 2], prof[:, _SLOTS - 1]
    t0 = start.min()
    starts_us = (start - t0).double() / 1e3
    chunk = prof[:, _SLOTS - 3] // (b * h)
    chain = cycles[:, PHASES.index("2")]
    by_chunk = [chain[chunk == c].median().item()
                for c in range(plan.chunks)]
    return dict(
        B=b, T=t, dtype=str(dtype).split(".")[1], ctas=plan.ctas,
        phase_cycles_median={p: cycles[:, i].median().item()
                             for i, p in enumerate(PHASES)},
        phase_cycles_max={p: cycles[:, i].max().item()
                          for i, p in enumerate(PHASES)},
        cta_cycles_median=(marks[:, -1] - marks[:, 0]).median().item(),
        chain_cycles_median_by_chunk=by_chunk,
        cta_life_us_median=((end - start).double() / 1e3).median().item(),
        span_us=((end.max() - t0).double() / 1e3).item(),
        start_us_quartiles=[starts_us.quantile(q).item()
                            for q in (0.25, 0.5, 0.75, 1.0)])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the JSON here too")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_wkv6: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    lib = build()
    rows = [profile_row(lib, b, t, dt, args.seed + i) for i, (b, t, dt) in
            enumerate([(1, 1024, torch.bfloat16), (1, 77, torch.bfloat16),
                       (2, 256, torch.float32), (1, 64, torch.bfloat16)])]
    out = dict(device=smi.splitlines()[0], phases=PHASES, rows=rows)
    text = json.dumps(out)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
