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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h,n,with_s0", [
    (2, 32, 2, 16, False),
    (1, 77, 3, 32, True),           # ragged T, a non-zero state handed in
    (2, 100, 4, 64, True),
    (1, 1024, 40, 64, False),       # rwkv6-3b's prefill
])
def test_wkv6_matches_plain_on_card(b, t, h, n, with_s0, dtype):
    """r, k, v in ``dtype``; w, u, s0 fp32.  y: bf16 within one bf16 ulp
    (2^-8 relative, doubled for the rounding point) of the plain version,
    fp32 within 1e-4 relative; s_end fp32 within 1e-4 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(b * t + n)
    r, k, v = (torch.randn(b, t, h, n, generator=g, device="cuda").to(dt)
               for _ in range(3))
    w = 0.45 + 0.5 * torch.sigmoid(torch.randn(b, t, h, n, generator=g,
                                               device="cuda"))
    u = 0.1 * torch.randn(h, n, generator=g, device="cuda")
    s0 = torch.randn(b, h, n, n, generator=g, device="cuda") \
        if with_s0 else None
    before = wkv_ops.wkv6.launches
    y, s = wkv_ops.wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert wkv_ops.wkv6.launches == before + 1
    assert y.dtype == dt and s.dtype == torch.float32
    want_y, want_s = wkv6_plain(r, k, v, w, u, s0)
    rtol = 2 ** -7 if dtype == "bfloat16" else 1e-4
    assert torch.all((y.float() - want_y.float()).abs()
                     <= rtol * want_y.float().abs() + 1e-4)
    assert torch.all((s - want_s).abs() <= 1e-4 * want_s.abs() + 1e-4)


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
