"""The hand-written CUDA kernels against their plain PyTorch versions on
the card.  Needs a CUDA device (the kernels have no CPU mode) and imports no
JAX, so it runs on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_attention_plain
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
@pytest.mark.parametrize("c", [16, 300])
def test_grouped_swiglu_row_bits_on_card(c):
    """A row's bits do not depend on its place in the slab or on the other
    experts' loads (one fixed k order, no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    e, d, f = 4, 512, 1024
    g = torch.Generator(device="cuda").manual_seed(c)
    x = torch.randn(e, c, d, generator=g, device="cuda").bfloat16()
    w = [(torch.randn(shape, generator=g, device="cuda") / shape[1] ** 0.5
          ).bfloat16() for shape in ((e, d, f), (e, d, f), (e, f, d))]
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
