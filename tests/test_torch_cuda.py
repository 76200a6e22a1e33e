"""The hand-written CUDA kernels against their plain PyTorch versions on
the card.  Needs a CUDA device (the kernels have no CPU mode) and imports no
JAX, so it runs on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
from itertools import product

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_attention_plain
from repro_torch.kernels.moe_dispatch import ops as md_ops
from repro_torch.kernels.moe_dispatch import ref as md_ref
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.kernels.moe_gmm.ref import grouped_swiglu_plain
from repro_torch.kernels.prefix_scan import ops as scan_ops
from repro_torch.kernels.prefix_scan.ref import prefix_scan_plain
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.kernels.wkv6.ref import wkv6_plain


def _inputs(b, s, t, h, hkv, d, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, t, hkv, d)).astype(np.float32),
            rng.standard_normal((b, t, hkv, d)).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 3e-2)])
@pytest.mark.parametrize("b,s,t,h,hkv,d,causal,window,q_offset,kv_valid", [
    (1, 256, 256, 12, 2, 128, True, None, 0, None),
    (8, 1, 512, 12, 2, 128, False, None, 0, [1, 512, 5, 100, 0, 511, 64, 65]),
    (2, 40, 100, 4, 2, 32, True, 48, 60, None),
    (1, 100, 100, 4, 4, 64, False, None, 0, None),
    # Mixtral-8x22B's heads: prefill with its window, decode over the paged
    # view of s_max 1024
    (1, 512, 512, 48, 8, 128, True, 4096, 0, None),
    (8, 1, 1024, 48, 8, 128, False, None, 0,
     [65, 1024, 130, 513, 1, 300, 700, 529]),
    # prefill on the edges of the fp32 route's tiles (64 query rows, 32 kv
    # rows): ragged S and T, kv_valid, a window, a q_offset, a row with
    # kv_valid = 0
    (2, 77, 130, 4, 2, 128, True, None, 53, [100, 130]),
    (1, 200, 300, 8, 2, 64, True, 48, 100, None),
    (2, 65, 161, 4, 1, 32, False, None, 0, [161, 0]),
    (1, 129, 129, 12, 2, 128, True, 40, 0, None),
])
def test_kernel_matches_plain_on_card(b, s, t, h, hkv, d, causal, window,
                                      q_offset, kv_valid, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to("cuda", dt)
               for x in _inputs(b, s, t, h, hkv, d))
    valid = None if kv_valid is None else torch.tensor(
        kv_valid, dtype=torch.int32, device="cuda")
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, valid, **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, valid, **kw)
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 3e-2)])
@pytest.mark.parametrize("e,c,d,f,load", [
    (4, 64, 32, 64, None),
    (2, 100, 16, 48, [100, 37]),
    (8, 8, 128, 256, [2, 0, 1, 8, 3, 0, 2, 0]),
    (8, 8, 6144, 16384, [2, 3, 1, 2, 4, 1, 2, 1]),     # Mixtral decode
    (8, 300, 6144, 16384, [256, 300, 0, 200, 1, 64, 65, 257]),
    (8, 512, 6144, 16384, [131, 120, 128, 140, 117, 126, 133, 129]),
])
def test_grouped_swiglu_matches_plain_on_card(e, c, d, f, load, dtype, tol):
    """Rows beyond each expert's load are zero, as dispatch leaves them; the
    kernel skips them and must still write them as zeros."""
    _check_grouped_swiglu(e, c, d, f, load, dtype, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("e,c,d,f,load", [
    (3, 40, 260, 516, [0, 1, 40]),
    (2, 9, 20, 36, [9, 4]),
    (4, 130, 132, 68, [130, 0, 65, 129]),
    # the prefill tile, both phases, at C = 40 (row tiles of up to 32
    # live rows take its sliver path) and at C = 300 (row tiles of 44, 1
    # and 0 live rows)
    (16, 40, 4356, 2180, [40, 0, 1, 13, 33, 8, 9, 39, 32, 2, 17, 31, 0, 5,
                          40, 26]),
    (4, 300, 5636, 2820, [300, 129, 0, 257]),
])
def test_grouped_swiglu_fp32_tile_edges_on_card(e, c, d, f, load):
    """fp32 on the edges of its tiles (``ops.gmm_plan``: narrow, prefill):
    D and F multiples of 4 but not of the tiles' columns, C just
    over the decode tile's 8 rows and over one 128-row tile, loads of 0, 1
    and C rows, within 1e-4 of the plain version."""
    _check_grouped_swiglu(e, c, d, f, load, "float32", 1e-4)


def _check_grouped_swiglu(e, c, d, f, load, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(e * c + d)
    x = torch.randn(e, c, d, generator=g, device="cuda").to(dt)
    w = [(torch.randn(shape, generator=g, device="cuda") / shape[1] ** 0.5
          ).to(dt) for shape in ((e, d, f), (e, d, f), (e, f, d))]
    ld = None
    if load is not None:
        ld = torch.tensor(load, dtype=torch.int32, device="cuda")
        x[torch.arange(c, device="cuda")[None, :] >= ld[:, None]] = 0
    before = gmm_ops.grouped_swiglu.launches
    y = gmm_ops.grouped_swiglu(x, *w, ld)
    torch.cuda.synchronize()
    assert gmm_ops.grouped_swiglu.launches == before + 1
    want = grouped_swiglu_plain(x, *w)
    assert torch.isfinite(y).all()
    assert (y.float() - want.float()).abs().max().item() <= tol
    if ld is not None:
        dead = torch.arange(c, device="cuda")[None, :] >= ld[:, None]
        assert torch.all(y[dead] == 0)
        assert torch.equal(y, gmm_ops.grouped_swiglu(x, *w))


def _wkv_inputs(b, t, h, n, dt, with_s0, seed, extreme=False):
    """r, k, v ~ N(0, 1) in ``dt``; w in (0.45, 0.95), or with ``extreme``
    w = exp(-exp(x)), x ~ U(-6, 5) (fp32 w underflows to 0 past x ~ 4.6),
    with whole steps at exactly 0 and exactly 1; u ~ N(0, 0.1); s0 ~
    N(0, 1) or None."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r, k, v = (torch.randn(b, t, h, n, generator=g, device="cuda").to(dt)
               for _ in range(3))
    if extreme:
        w = torch.exp(-torch.exp(
            torch.rand(b, t, h, n, generator=g, device="cuda") * 11 - 6))
        w[:, 5:9] = 0
        w[:, 300:340] = 1
        w[:, 700] = 0
    else:
        w = 0.45 + 0.5 * torch.sigmoid(torch.randn(b, t, h, n, generator=g,
                                                   device="cuda"))
    u = 0.1 * torch.randn(h, n, generator=g, device="cuda")
    s0 = torch.randn(b, h, n, n, generator=g, device="cuda") \
        if with_s0 else None
    return r, k, v, w, u, s0


def _check_wkv(r, k, v, w, u, s0):
    """One launch, within the tolerances of the plain version: y in bf16
    within one bf16 ulp (2^-8 relative, doubled for the rounding point),
    fp32 within 1e-4 relative; s_end fp32 within 1e-4 relative; 1e-4
    absolute on each.  A second call gives the same bits."""
    before = wkv_ops.wkv6.launches
    y, s = wkv_ops.wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert wkv_ops.wkv6.launches == before + 1
    assert y.dtype == r.dtype and s.dtype == torch.float32
    want_y, want_s = wkv6_plain(r, k, v, w, u, s0)
    rtol = 2 ** -7 if r.dtype == torch.bfloat16 else 1e-4
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    assert torch.all((y.float() - want_y.float()).abs()
                     <= rtol * want_y.float().abs() + 1e-4)
    assert torch.all((s - want_s).abs() <= 1e-4 * want_s.abs() + 1e-4)
    y2, s2 = wkv_ops.wkv6(r, k, v, w, u, s0)
    assert torch.equal(y, y2) and torch.equal(s, s2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h,n,with_s0", [
    (2, 32, 2, 16, False),
    (1, 77, 3, 32, True),           # ragged T, a non-zero state handed in
    (2, 100, 4, 64, True),
    (1, 1024, 40, 64, False),       # rwkv6-3b's prefill
    (1, 64, 40, 64, True),          # one chunk: the shortest prompt
    (1, 65, 40, 64, True),          # a chunk and one step
    (1, 1, 2, 64, True),            # one step
    (3, 200, 5, 32, True),          # four chunks, the last ragged
    (2, 130, 3, 16, False),
])
def test_wkv6_matches_plain_on_card(b, t, h, n, with_s0, dtype):
    """r, k, v in ``dtype``; w, u, s0 fp32; the tolerances of
    ``_check_wkv``, and the same bits on a second call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    _check_wkv(*_wkv_inputs(b, t, h, n, getattr(torch, dtype), with_s0,
                            seed=b * t + n))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_fast_decay_on_card(dtype):
    """rwkv6-3b's heads at T = 1024 with the extreme decays: the floor of
    e^-30 keeps every exponent finite; the tolerances of ``_check_wkv``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    _check_wkv(*_wkv_inputs(1, 1024, 40, 64, getattr(torch, dtype), True,
                            seed=17, extreme=True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int32", "float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 64), (4, 1000), (2, 3, 130), (8, 8),
                                   (4, 1024), (3, 1025), (2, 10000)])
def test_prefix_scan_matches_plain_on_card(shape, dtype):
    """int32 exact (values in [-50, 50)); fp32 within 1e-6 of each row's
    sum of |x| (sums in another order); bf16 also within one bf16 ulp of
    the output (each output rounded to bf16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    if dtype == "int32":
        x = torch.randint(-50, 50, shape, generator=g, device="cuda",
                          dtype=torch.int32)
    else:
        x = (8 * torch.randn(shape, generator=g, device="cuda")).to(
            getattr(torch, dtype))
    before = scan_ops.prefix_scan.launches
    got = scan_ops.prefix_scan(x)
    torch.cuda.synchronize()
    assert scan_ops.prefix_scan.launches == before + 1
    want = prefix_scan_plain(x)
    assert got.dtype == x.dtype and got.shape == x.shape
    if dtype == "int32":
        assert torch.equal(got, want)
        return
    tol = 1e-6 * x.float().abs().sum(-1, keepdim=True)
    if dtype == "bfloat16":
        tol = tol + 2 ** -7 * want.float().abs()
    assert torch.all((got.float() - want.float()).abs() <= tol)


@pytest.mark.cuda
def test_prefix_scan_int32_wraps_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    x = torch.full((2, 5000), 2 ** 30 + 12345, dtype=torch.int32,
                   device="cuda")
    x[1] *= -1
    assert torch.equal(scan_ops.prefix_scan(x), prefix_scan_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,t,h,hkv,d,causal,window,q_offset,kv_valid", [
    (2, 77, 77, 4, 2, 32, True, None, 0, None),        # ragged S = T
    (2, 200, 300, 4, 2, 64, True, None, 100, None),    # T not a multiple of 64
    (2, 77, 130, 4, 1, 32, True, None, 53, [100, 130]),  # kv_valid, S > 4
    (2, 200, 300, 8, 2, 64, False, None, 0, [150, 0]),   # a kv_valid = 0 row
    (1, 200, 200, 4, 2, 128, True, 48, 0, None),       # window < S
    (2, 96, 96, 4, 4, 64, True, 16, 0, [90, 0]),
])
def test_flash_mma_prefill_on_card(b, s, t, h, hkv, d, causal, window,
                                   q_offset, kv_valid):
    """The bf16 prefill route (tensor cores) against the plain version
    within 3e-2 (P is rounded to bf16 before PV); a kv_valid = 0 row is all
    zeros; two calls give the same bits (no atomics, no split)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    q, k, v = (torch.from_numpy(x).to("cuda", torch.bfloat16)
               for x in _inputs(b, s, t, h, hkv, d, seed=s + t))
    assert ops.kernel_route(q.dtype, s) == "mma"
    valid = None if kv_valid is None else torch.tensor(
        kv_valid, dtype=torch.int32, device="cuda")
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, valid, **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, valid, **kw)
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= 3e-2
    assert torch.equal(got, ops.flash_attention(q, k, v, valid, **kw))
    if valid is not None:
        assert torch.all(got[valid == 0] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int32", "float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 2, 3])
def test_prefix_scan_many_tiles_on_card(rows, dtype):
    """Rows of 2^20 + 13 (129 tiles of 8192, the last ragged) chained by the
    look-back, with the tolerances of test_prefix_scan_matches_plain_on_card;
    int32 also the same bits on a second run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    n = (1 << 20) + 13
    assert scan_ops.scan_plan(rows, n).tiles_per_row > 1
    g = torch.Generator(device="cuda").manual_seed(rows)
    if dtype == "int32":
        x = torch.randint(-50, 50, (rows, n), generator=g, device="cuda",
                          dtype=torch.int32)
    else:
        x = (8 * torch.randn(rows, n, generator=g, device="cuda")).to(
            getattr(torch, dtype))
    got = scan_ops.prefix_scan(x)
    want = prefix_scan_plain(x)
    if dtype == "int32":
        assert torch.equal(got, want)
        assert torch.equal(scan_ops.prefix_scan(x), got)
        return
    tol = 1e-6 * x.float().abs().sum(-1, keepdim=True)
    if dtype == "bfloat16":
        tol = tol + 2 ** -7 * want.float().abs()
    assert torch.all((got.float() - want.float()).abs() <= tol)


@pytest.mark.cuda
def test_prefix_scan_int32_wraps_across_tiles_on_card():
    """Sums that pass 2^31 inside a tile and across the look-back's carry
    wrap as 32-bit integers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    x = torch.full((2, 3 * 8192 + 5), 2 ** 30 + 12345, dtype=torch.int32,
                   device="cuda")
    x[1] *= -1
    assert scan_ops.scan_plan(2, x.shape[1]).tiles_per_row == 4
    assert torch.equal(scan_ops.prefix_scan(x), prefix_scan_plain(x))


def _split_case(b, s, t, h, hkv, d, dtype, seed):
    q, k, v = (torch.from_numpy(x).to("cuda", getattr(torch, dtype))
               for x in _inputs(b, s, t, h, hkv, d, seed=seed))
    return q, k, v


def _attn_fp64(q, k, v, kv_valid, causal, window, q_offset):
    """Attention in fp64 with the kernel's mask (a fully masked row is 0):
    [B, S, H, d]."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    i = q_offset + torch.arange(s, device=q.device)[:, None]
    j = torch.arange(t, device=q.device)[None, :]
    vis = torch.ones(b, 1, 1, s, t, dtype=torch.bool, device=q.device)
    if causal:
        vis = vis & (j <= i)
    if window is not None:
        vis = vis & (i - j < window)
    if kv_valid is not None:
        vis = vis & (j < kv_valid.reshape(b, 1, 1, 1, 1))
    qd = q.double().reshape(b, s, hkv, h // hkv, d).permute(0, 2, 3, 1, 4)
    kd, vd = (x.double().permute(0, 2, 1, 3) for x in (k, v))
    logits = torch.einsum("bkgsd,bktd->bkgst", qd, kd) * d ** -0.5
    p = torch.nan_to_num(torch.softmax(
        logits.masked_fill(~vis, float("-inf")), -1))
    out = torch.einsum("bkgst,bktd->bkgsd", p, vd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)


#: ulps of the dtype at a row's largest |value| that a split-decode row may
#: lie from fp64 beyond twice the plain version's error: bf16 output
#: rounding hides the rest; in fp32 both versions' T-term sums and exps
#: leave them 6-22 ulps from fp64, in orders that differ
FP64_ULPS = {torch.bfloat16: 1, torch.float32: 16}


def _rows_within_fp64_allowance(got, want, exact):
    """Each output row's (batch, query, head) error against fp64 is at most
    twice the plain version's plus FP64_ULPS ulps of the dtype at the row's
    largest |value|.  Long rows average to values of ~sqrt(e / T), under
    the absolute tolerance: a fault that biases them shows here."""
    ek = (got.double() - exact).abs().amax(-1)
    ep = (want.double() - exact).abs().amax(-1)
    scale = exact.abs().amax(-1)
    ulp = torch.ldexp(torch.full_like(scale, torch.finfo(got.dtype).eps
                                      * FP64_ULPS[got.dtype]),
                      torch.frexp(scale).exponent - 1)
    return bool(torch.all(ek <= 2 * ep + torch.where(scale > 0, ulp, 0)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 3e-2)])
@pytest.mark.parametrize("b,s,t,h,hkv,d,causal,window,q_offset,kv_valid", [
    # T not a multiple of the chunk; kv_valid of 0, 1 and T in one batch
    (4, 1, 1000, 12, 2, 128, False, None, 0, [0, 1, 1000, 517]),
    (1, 1, 50, 4, 4, 64, False, None, 0, None),        # T under one chunk
    (2, 2, 700, 12, 2, 128, True, None, 698, [700, 350]),  # S = 2, causal
    (2, 3, 300, 8, 8, 32, True, None, 297, None),      # S = 3, g = 1
    (2, 4, 513, 64, 8, 128, True, None, 509, [513, 4]),  # S = 4, g = 8
    (2, 4, 256, 64, 4, 64, True, None, 252, None),     # g = 16: 2 CTAs a kv
    (3, 1, 2048, 12, 2, 128, False, 300, 2047, None),  # window cuts chunks
    (2, 2, 1024, 48, 8, 128, True, 100, 1022, [1024, 600]),
    (8, 1, 2048, 12, 2, 128, False, None, 0,
     [0, 2048, 7, 300, 0, 2047, 64, 1500]),            # qwen2-1.5b decode
    (8, 1, 1024, 48, 8, 128, False, None, 0,
     [65, 1024, 130, 513, 1, 300, 700, 529]),          # Mixtral decode
])
def test_flash_split_decode_on_card(b, s, t, h, hkv, d, causal, window,
                                    q_offset, kv_valid, dtype, tol):
    """The decode route (split-KV, GQA packing) against the plain version,
    and row by row against fp64 attention; a kv_valid = 0 row is all zeros,
    and two calls give the same bits.  A call counts once, and launches
    the combine pass too when its plan has several splits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    q, k, v = _split_case(b, s, t, h, hkv, d, dtype, seed=s + t)
    assert ops.kernel_route(q.dtype, s) == "split"
    valid = None if kv_valid is None else torch.tensor(
        kv_valid, dtype=torch.int32, device="cuda")
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = (ops.flash_attention.launches,
              ops.flash_attention.kernel_launches)
    got = ops.flash_attention(q, k, v, valid, **kw)
    torch.cuda.synchronize()
    kernels = 2 if ops.decode_plan(b, hkv, t).splits > 1 else 1
    assert (ops.flash_attention.launches,
            ops.flash_attention.kernel_launches) == (before[0] + 1,
                                                     before[1] + kernels)
    want = flash_attention_plain(q, k, v, valid, **kw)
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert _rows_within_fp64_allowance(
        got, want, _attn_fp64(q, k, v, valid, **kw))
    assert torch.equal(got, ops.flash_attention(q, k, v, valid, **kw))
    if valid is not None:
        assert torch.all(got[valid == 0] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_split_row_ignores_other_rows_on_card(dtype):
    """A row's bits depend only on its own kv_valid, T and the plan: other
    rows' kv_valid and values change nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    q, k, v = _split_case(4, 1, 1536, 12, 2, 128, dtype, seed=7)
    valid = torch.tensor([900, 1536, 3, 0], dtype=torch.int32, device="cuda")
    got = ops.flash_attention(q, k, v, valid, causal=False)
    other = torch.tensor([900, 17, 1536, 1200], dtype=torch.int32,
                         device="cuda")
    k2, v2 = k.clone(), v.clone()
    k2[1:], v2[1:] = k2[1:].flip(1), -v2[1:]
    again = ops.flash_attention(q, k2, v2, other, causal=False)
    assert torch.equal(got[0], again[0])


@pytest.mark.cuda
@pytest.mark.parametrize("e,c,d,f,load", [
    (8, 16, 6144, 16384, [16, 0, 1, 5, 16, 2, 9, 3]),  # decode, C = 16
    (3, 16, 264, 520, [0, 1, 16]),        # D, F multiples of 8, not of 16
    (3, 200, 264, 520, [0, 1, 200]),      # ... and on the prefill tile
    (2, 9, 24, 40, [9, 4]),
])
def test_grouped_swiglu_mma_on_card(e, c, d, f, load):
    """The bf16 tensor-core path against the plain version within 3e-2;
    rows beyond each load exactly 0; two calls give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(e + c + d + f)
    x = torch.randn(e, c, d, generator=g, device="cuda").bfloat16()
    w = [(torch.randn(shape, generator=g, device="cuda") / shape[1] ** 0.5
          ).bfloat16() for shape in ((e, d, f), (e, d, f), (e, f, d))]
    ld = torch.tensor(load, dtype=torch.int32, device="cuda")
    dead = torch.arange(c, device="cuda")[None, :] >= ld[:, None]
    x[dead] = 0
    kernels = gmm_ops.grouped_swiglu.kernel_launches
    y = gmm_ops.grouped_swiglu(x, *w, ld)
    assert gmm_ops.grouped_swiglu.kernel_launches == kernels + 2
    want = grouped_swiglu_plain(x, *w)
    assert torch.isfinite(y).all()
    assert (y.float() - want.float()).abs().max().item() <= 3e-2
    assert torch.all(y[dead] == 0)
    assert torch.equal(y, gmm_ops.grouped_swiglu(x, *w, ld))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("c", [8, 16, 300, 1024])
def test_grouped_swiglu_row_bits_on_card(c, dtype):
    """A row's bits do not depend on its place in the slab or on the other
    experts' loads (one fixed k order, no atomics), on each tile: in fp32
    (wider, so the prefill tile's grid fills the card) decode (C = 8),
    narrow (16), prefill (300, phase (a); 1024, both phases, with the
    sliver path for the experts of 3 and 1 rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    e, d, f = (4, 512, 1024) if dtype == "bfloat16" else (4, 2304, 2176)
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(c)
    x = torch.randn(e, c, d, generator=g, device="cuda").to(dt)
    w = [(torch.randn(shape, generator=g, device="cuda") / shape[1] ** 0.5
          ).to(dt) for shape in ((e, d, f), (e, d, f), (e, f, d))]
    full = torch.full((e,), c, dtype=torch.int32, device="cuda")
    y = gmm_ops.grouped_swiglu(x, *w, full)
    perm = torch.randperm(c, generator=g, device="cuda")
    moved = gmm_ops.grouped_swiglu(x[:, perm].contiguous(), *w, full)
    assert torch.equal(moved, y[:, perm])
    # expert 1 unchanged while the others' loads (and rows) change
    other = torch.tensor([0, c, 3, 1], dtype=torch.int32, device="cuda")
    x2 = x.clone()
    x2[torch.arange(c, device="cuda")[None, :] >= other[:, None]] = 0
    y2 = gmm_ops.grouped_swiglu(x2, *w, other)
    assert torch.equal(y2[1], y[1])


@pytest.mark.cuda
@pytest.mark.parametrize("t,e,k,cap", [(8, 384, 8, 8), (512, 384, 8, 512),
                                       (64, 32, 8, 12)])
def test_moe_combine_k8_on_card(t, e, k, cap):
    """The combine at top-8 (Kimi-K2's 384 experts at decode and prefill,
    and a droppy capacity): two calls give the same bits, and the result
    equals the CPU's within fp32 rounding (the gathers and adds are the
    CPU's, in the same order; only fused multiply-adds may differ)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.device import moe_balance as mb
    g = torch.Generator(device="cuda").manual_seed(t + e + k)
    logits = torch.randn(t, e, generator=g, device="cuda")
    idx, gate, probs = mb.route_topk(logits, k)
    plan = mb.priority_dispatch(idx, gate, probs, num_experts=e,
                                capacity=cap)
    y = torch.randn(e, cap, 256, generator=g, device="cuda")
    got = mb.combine_expert_outputs(y, plan, t, k)
    assert torch.equal(got, mb.combine_expert_outputs(y, plan, t, k))
    cpu = mb.combine_expert_outputs(
        y.cpu(), mb.DispatchPlan(*(a.cpu() for a in plan)), t, k)
    torch.testing.assert_close(got.cpu(), cpu, rtol=1e-6, atol=1e-6)


#: (T, E, k, C): Mixtral's decode (T = max_batch) and chunk, Jamba's 16
#: experts at a 1024-token prefill, Kimi's 384 at decode and at a
#: 1024-token chunk, all dropless; then droppy shapes (Mixtral at capacity
#: 6, and the odd shapes of the CPU plan tests)
MOE_DISPATCH_CASES = [(32, 8, 2, 32), (512, 8, 2, 512), (1024, 16, 2, 1024),
                      (8, 384, 8, 8), (1024, 384, 8, 1024), (48, 8, 2, 6),
                      (33, 5, 3, 4), (17, 12, 1, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("t,e,k,cap", MOE_DISPATCH_CASES)
def test_moe_dispatch_matches_plain_on_card(t, e, k, cap, ties):
    """The route kernel against ``route_topk`` on the card: the same
    experts, gates and probabilities within 1e-6, the next choice that of
    the stable sort.  The plan, for both policies with and without
    restealing, against ``priority_dispatch`` on the kernel's routing:
    ``slot_src``, ``kept``, ``expert`` and ``load`` equal, ``gate``,
    ``dropped_mass`` (relative: summed in another order) and the aux loss
    within 1e-6; the buffer equal to ``gather_expert_inputs``'s.  The
    combine, bf16 and fp32: the bits of ``combine_expert_outputs`` on the
    card, and the same bits from a second call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.core.device import moe_balance as mb
    rng = np.random.default_rng(t * 7 + e + k)
    logits = (rng.integers(-2, 3, (t, e)) if ties
              else rng.standard_normal((t, e)) * 2).astype(np.float32)
    logits = torch.from_numpy(logits).cuda()
    g = torch.Generator(device="cuda").manual_seed(t + e)
    routing = md_ops.moe_route(logits, k, alt=True)
    idx, gate, probs = mb.route_topk(logits, k)
    assert torch.equal(routing.expert_idx, idx)
    torch.testing.assert_close(routing.gate, gate, rtol=0, atol=1e-6)
    torch.testing.assert_close(routing.probs, probs, rtol=0, atol=1e-6)
    alt_e, alt_p = md_ref.route_alt_plain(routing.probs.cpu(), k)
    assert torch.equal(routing.alt_expert.cpu(), alt_e)
    assert torch.equal(routing.alt_prob.cpu(), alt_p)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(t, 64, generator=g, device="cuda").to(dtype)
        y = torch.randn(e, cap, 64, generator=g, device="cuda").to(dtype)
        for policy, resteal in product(("priority", "arrival"),
                                       (False, True)):
            kw = dict(num_experts=e, capacity=cap, policy=policy,
                      resteal=resteal)
            case = (dtype, policy, resteal)
            sent = md_ops.moe_dispatch(x, routing, **kw)
            plan = mb.priority_dispatch(*routing[:3], **kw)
            for name in ("slot_src", "kept", "expert", "load"):
                assert torch.equal(getattr(sent.plan, name),
                                   getattr(plan, name)), (name, case)
            torch.testing.assert_close(sent.plan.gate, plan.gate, rtol=0,
                                       atol=1e-6)
            torch.testing.assert_close(sent.plan.dropped_mass,
                                       plan.dropped_mass, rtol=1e-6,
                                       atol=1e-6)
            torch.testing.assert_close(
                sent.aux_loss, md_ref.aux_loss_plain(routing.probs,
                                                     plan.load, e),
                rtol=0, atol=1e-6)
            assert torch.equal(sent.buf, mb.gather_expert_inputs(x, plan, k))
            got = md_ops.moe_combine(y, sent, t, k)
            assert torch.equal(got, mb.combine_expert_outputs(y, plan, t, k)
                               ), case
            assert torch.equal(got, md_ops.moe_combine(y, sent, t, k))


@pytest.mark.cuda
@pytest.mark.parametrize("t,e,k", [(32, 16, 2), (512, 16, 2), (17, 8, 3)])
def test_moe_route_without_renormalising_on_card(t, e, k):
    """The route kernel with ``renormalize=False`` (Jamba's router) against
    ``route_topk(renormalize=False)``: the same experts, and gates equal to
    the top-k probabilities within 1e-6; the default renormalises as
    before."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.core.device import moe_balance as mb
    g = torch.Generator(device="cuda").manual_seed(t + e)
    logits = torch.randn(t, e, generator=g, device="cuda") * 2
    for renormalize in (False, True):
        routing = md_ops.moe_route(logits, k, alt=True,
                                   renormalize=renormalize)
        idx, gate, probs = mb.route_topk(logits, k, renormalize=renormalize)
        assert torch.equal(routing.expert_idx, idx), renormalize
        torch.testing.assert_close(routing.gate, gate, rtol=0, atol=1e-6)
        torch.testing.assert_close(routing.probs, probs, rtol=0, atol=1e-6)
    plain = md_ops.moe_route(logits, k, renormalize=False)
    torch.testing.assert_close(
        plain.gate, torch.gather(plain.probs, 1, plain.expert_idx.long()),
        rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("t,e,k,cap", [(48, 8, 2, 6), (512, 8, 2, 512)])
def test_moe_dispatch_global_lists_on_card(t, e, k, cap, monkeypatch):
    """An expert's list past ``RANK_SMEM_LIMIT`` bytes goes to a global
    scratch instead of shared memory (T > 20480 in one pass): with the
    limit at 0 the plan and buffer are those of the shared-memory lists,
    both policies, with and without restealing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(t)
    logits = torch.randn(t, e, generator=g, device="cuda") * 2
    x = torch.randn(t, 64, generator=g, device="cuda").bfloat16()
    routing = md_ops.moe_route(logits, k, alt=True)
    for policy, resteal in product(("priority", "arrival"), (False, True)):
        kw = dict(num_experts=e, capacity=cap, policy=policy,
                  resteal=resteal)
        want = md_ops.moe_dispatch(x, routing, **kw)
        with monkeypatch.context() as m:
            m.setattr(md_ops, "RANK_SMEM_LIMIT", 0)
            got = md_ops.moe_dispatch(x, routing, **kw)
        for a, b in zip(got.plan, want.plan):
            assert torch.equal(a, b), (policy, resteal)
        assert torch.equal(got.buf, want.buf)
        assert torch.equal(got.slot, want.slot)


@pytest.mark.cuda
@pytest.mark.parametrize("dropless", [True, False])
def test_moe_fwd_launches_on_card(dropless):
    """One ``moe_fwd`` call with ``use_kernel`` (a scaled Mixtral in bf16,
    restealing on; droppy: capacity < T, so both rank passes run) launches
    at most 5 kernels besides the router GEMM (with its cast of x to fp32)
    and grouped SwiGLU's two, as the profiler sees them and as the
    wrapper's counters count them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.configs import get_config, scale_down
    from repro_torch.models import moe
    cfg = scale_down(get_config("mixtral-8x22b")).replace(
        moe_dropless=dropless, use_flash=True)
    assert cfg.dispatch_resteal
    p = moe.init_moe(torch.Generator(device="cuda").manual_seed(0), cfg)
    x = torch.randn(4, 8, cfg.d_model, device="cuda").bfloat16()

    def kernels(fn):
        """The kernels of one call of ``fn``, from a profiled window that
        saw some (now and then the profiler returns a window with no
        device events at all: it is taken again, 3 times in all)."""
        fn()                                           # build and load
        torch.cuda.synchronize()
        for _ in range(3):
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            names = [ev.name for ev in prof.events()
                     if ev.device_type == torch.autograd.DeviceType.CUDA]
            if names:
                return names
        raise AssertionError("the profiler saw no device events")

    def layer():
        return moe.moe_fwd(p, x, cfg, use_kernel=True)

    with torch.no_grad():
        router = kernels(lambda: x.reshape(-1, cfg.d_model).float()
                         @ p["router"]["w"])
        names = kernels(layer)
        n0 = md_ops.moe_dispatch.launches
        k0 = md_ops.moe_dispatch.kernel_launches
        y, stats = layer()
        torch.cuda.synchronize()
    ours = [n for n in names if "moe_" in n]
    gmm = [n for n in names if "gmm_" in n]
    assert len(ours) == (4 if dropless else 5), names
    assert len(gmm) == 2, names
    # the rest is the router's GEMM and its cast (cuBLAS may pick another
    # algorithm for another call of the same shapes)
    assert len(names) - len(ours) - len(gmm) <= len(router), (names, router)
    assert md_ops.moe_dispatch.launches == n0 + 1
    assert md_ops.moe_dispatch.kernel_launches == k0 + len(ours)
    assert torch.isfinite(y).all() and int(stats.load.sum()) > 0


def _wrapper_call(name):
    """(the wrapper's launch counter, a call of it on small bf16 CUDA
    inputs, those inputs)."""
    g = torch.Generator(device="cuda").manual_seed(9)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda",
                           dtype=torch.bfloat16)

    if name == "flash_attention":
        xs = (rnd(1, 64, 4, 64), rnd(1, 64, 2, 64), rnd(1, 64, 2, 64))
        return ops.flash_attention, lambda: ops.flash_attention(*xs), xs
    if name == "grouped_swiglu":
        xs = (rnd(2, 16, 64), rnd(2, 64, 128), rnd(2, 64, 128),
              rnd(2, 128, 64))
        return (gmm_ops.grouped_swiglu,
                lambda: gmm_ops.grouped_swiglu(*xs), xs)
    if name == "wkv6":
        xs = (rnd(1, 16, 2, 64), rnd(1, 16, 2, 64), rnd(1, 16, 2, 64),
              torch.rand(1, 16, 2, 64, generator=g, device="cuda"),
              torch.randn(2, 64, generator=g, device="cuda"),
              torch.zeros(1, 2, 64, 64, device="cuda"))
        return wkv_ops.wkv6, lambda: wkv_ops.wkv6(*xs), xs
    xs = (torch.randn(2, 300, generator=g, device="cuda"),)
    return scan_ops.prefix_scan, lambda: scan_ops.prefix_scan(*xs), xs


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flash_attention", "grouped_swiglu",
                                  "wkv6", "prefix_scan"])
def test_wrapper_refuses_inputs_that_require_grad_on_card(name):
    """No kernel has a backward pass: on inputs that require grad each
    wrapper raises before launching (a result without a ``grad_fn`` would
    cut the gradient silently); under ``torch.no_grad`` it launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    counter, call, xs = _wrapper_call(name)
    for i in range(len(xs)):
        xs[i].requires_grad_(True)
        before = counter.launches
        with pytest.raises(RuntimeError, match="has no backward pass"):
            call()
        assert counter.launches == before
        with torch.no_grad():
            out = call()
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        assert not (out[0] if isinstance(out, tuple) else out).requires_grad
        xs[i].requires_grad_(False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [("float32", 1e-4),
                                       ("bfloat16", 5e-2)])
def test_encdec_decode_step_flash_matches_plain_on_card(dtype, rel):
    """A scaled seamless-m4t-medium (2 + 2 layers, d_model 256, 4 heads of
    64 with 4 kv heads: g = 1) prefilled once, then a decode step with
    flash on (the split route at d = 64, g = 1: one launch a decoder layer,
    none in the prefill) against the plain route on the same cache: the
    logits within ``rel`` of their largest |logit| (fp32: summation order;
    bf16: the two routes round the attention's output differently)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.configs import get_config, scale_down
    from repro_torch.models import build_model
    cfg = scale_down(get_config("seamless-m4t-medium"), d_model=256,
                     d_ff=512, heads=4).replace(dtype=dtype,
                                                param_dtype=dtype)
    assert cfg.resolved_head_dim == 64 and cfg.num_kv_heads == 4
    flash = build_model(cfg.replace(use_flash=True), "cuda")
    plain = build_model(cfg, "cuda")
    params = flash.init(0)
    g = torch.Generator(device="cuda").manual_seed(1)
    batch = {"src_embeds": torch.randn(4, 40, cfg.audio_embed_dim,
                                       generator=g, device="cuda"),
             "tokens": torch.randint(0, cfg.vocab_size, (4, 9), generator=g,
                                     device="cuda")}
    token = torch.randint(0, cfg.vocab_size, (4, 1), generator=g,
                          device="cuda")
    with torch.no_grad():
        before = ops.flash_attention.launches
        _, cache = flash.prefill(params, batch, 64)
        assert ops.flash_attention.launches == before
        want, _ = plain.decode_step(params, token, cache, 9)
        got, _ = flash.decode_step(params, token, cache, 9)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + cfg.num_layers
    want = want.float()
    err = (got.float() - want).abs().max().item()
    assert err <= rel * want.abs().max().item()
