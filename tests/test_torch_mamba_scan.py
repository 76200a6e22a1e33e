"""The Mamba mixer's kernel route (``kernels/mamba_scan``) on the CPU,
where its wrappers run the plain code: ``mamba_fwd`` and ``mamba_decode``
with ``use_flash`` on and off give the bits of the mixer as it was written
before the kernels (kept below as ``_before_fwd`` and ``_before_decode``),
with the inner norms on and off; a carried state splits a call; the CPU
launches nothing; a call that a backward pass can follow keeps the plain
code and its gradient; a tiny hybrid engine counts its Mamba layers'
tokens."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config, scale_down
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.kernels.mamba_scan.ref import scan_chunk, scan_chunked
from repro_torch.models import build_model, ssm
from repro_torch.models.layers import linear, rms_norm
from repro_torch.serving import ServingEngine

B = 2


def _cfg(norm: bool, dtype: str = "bfloat16"):
    """A scaled-down Jamba (d_model 32: d_inner 64, d_state 8, dt_rank 2,
    d_conv 4, scan chunks of at most 16)."""
    return scale_down(get_config("jamba-v0.1-52b"), d_model=32).replace(
        mamba_inner_norm=norm, dtype=dtype, param_dtype=dtype)


def _layer(cfg, seed=0):
    """A Mamba layer's weights, with the inner norms' scales and conv bias
    away from their init (ones, zeros) so that they act."""
    dt = getattr(torch, cfg.dtype)
    g = torch.Generator().manual_seed(seed)
    p = ssm.init_mamba(g, cfg, dt)
    p["conv_b"] = (torch.randn(p["conv_b"].shape, generator=g) * 0.1).to(dt)
    p["a_log"] = p["a_log"] + torch.rand(p["a_log"].shape, generator=g)
    for k in ("dt_norm", "b_norm", "c_norm"):
        if k in p:
            p[k]["scale"] = (1 + 0.1 * torch.randn(
                p[k]["scale"].shape, generator=g)).to(dt)
    return p


def _inputs(cfg, t, seed=1):
    dt = getattr(torch, cfg.dtype)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, t, cfg.d_model, generator=g).to(dt)
    conv = torch.randn(B, cfg.mamba_d_conv - 1, cfg.mamba_d_inner,
                       generator=g).to(dt)
    h = torch.randn(B, cfg.mamba_d_inner, cfg.mamba_d_state, generator=g)
    return x, ssm.MambaState(conv, h)


# The mixer as models/ssm.py wrote it before the kernels, step for step.

def _before_ssm_inputs(p, xc, cfg):
    dtr, ds = cfg.resolved_dt_rank, cfg.mamba_d_state
    proj = linear(p["x_proj"], xc)
    dt, bmat, cmat = (proj[..., :dtr], proj[..., dtr:dtr + ds],
                      proj[..., dtr + ds:])
    if cfg.mamba_inner_norm:
        eps = cfg.norm_eps
        dt = rms_norm(p["dt_norm"], dt, eps)
        bmat = rms_norm(p["b_norm"], bmat, eps)
        cmat = rms_norm(p["c_norm"], cmat, eps)
    dt = F.softplus(linear(p["dt_proj"], dt).float())
    bmat = bmat.float()
    cmat = cmat.float()
    a = -torch.exp(p["a_log"])
    decay = torch.exp(dt[..., None] * a)
    inp = (dt * xc.float())[..., None] * bmat[..., None, :]
    return decay, inp, cmat


def _before_fwd(p, x, cfg, state):
    t = x.shape[1]
    dc = cfg.mamba_d_conv
    u = linear(p["in_proj"], x)
    xi, z = u.chunk(2, dim=-1)
    xpad = torch.cat([state.conv, xi], dim=1)
    conv_state = xpad[:, -(dc - 1):]
    xc = sum(xpad[:, i:i + t] * p["conv_w"][i] for i in range(dc))
    xc = F.silu(xc + p["conv_b"])
    decay, inp, cmat = _before_ssm_inputs(p, xc, cfg)
    hs, h_end = scan_chunked(decay, inp, state.h,
                             scan_chunk(t, cfg.ssm_chunk))
    y = torch.einsum("btds,bts->btd", hs, cmat)
    y = (y + xc.float() * p["d_skip"]).to(x.dtype)
    return linear(p["out_proj"], y * F.silu(z)), conv_state, h_end


def _before_decode(p, x, cfg, state):
    u = linear(p["in_proj"], x)
    xi, z = u.chunk(2, dim=-1)
    xfull = torch.cat([state.conv, xi], dim=1)
    xc = F.silu(torch.einsum("bcd,cd->bd", xfull, p["conv_w"])
                + p["conv_b"])
    decay, inp, cmat = _before_ssm_inputs(p, xc, cfg)
    h = decay * state.h + inp
    y = torch.einsum("bds,bs->bd", h, cmat)
    y = (y + xc.float() * p["d_skip"]).to(x.dtype)
    return linear(p["out_proj"], y[:, None] * F.silu(z)), xfull[:, 1:], h


def _same(got, want):
    y, st = got
    assert torch.equal(y, want[0])
    assert torch.equal(st.conv, want[1]) and torch.equal(st.h, want[2])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("norm", [False, True], ids=["plain", "norms"])
@pytest.mark.parametrize("t", [1, 7, 512, 513])
@pytest.mark.parametrize("flash", [False, True], ids=["plain", "route"])
def test_fwd_keeps_its_bits(t, norm, dtype, flash):
    """``mamba_fwd`` with a state, on the kernel route (the wrappers' CPU
    form) and off it, gives the mixer's bits as before."""
    cfg = _cfg(norm, dtype).replace(use_flash=flash)
    p = _layer(cfg)
    x, state = _inputs(cfg, t)
    with torch.no_grad():
        _same(ssm.mamba_fwd(p, x, cfg, state),
              _before_fwd(p, x, cfg, state))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("norm", [False, True], ids=["plain", "norms"])
@pytest.mark.parametrize("flash", [False, True], ids=["plain", "route"])
def test_decode_keeps_its_bits(norm, dtype, flash):
    cfg = _cfg(norm, dtype).replace(use_flash=flash)
    p = _layer(cfg)
    x, state = _inputs(cfg, 1)
    h = state.h.clone()
    with torch.no_grad():
        _same(ssm.mamba_decode(p, x, cfg, state),
              _before_decode(p, x, cfg, state))
    assert torch.equal(state.h, h)                    # not modified


@pytest.mark.parametrize("t", [8, 512])
def test_two_carried_calls_equal_one(t):
    """One call over T steps against two of T / 2, the second starting
    from the state the first left: fp32, within fp32 rounding (the scan's
    chunks differ)."""
    cfg = _cfg(True, "float32").replace(use_flash=True)
    p = _layer(cfg)
    x, state = _inputs(cfg, t)
    with torch.no_grad():
        y, whole = ssm.mamba_fwd(p, x, cfg, state)
        y1, mid = ssm.mamba_fwd(p, x[:, :t // 2], cfg, state)
        y2, end = ssm.mamba_fwd(p, x[:, t // 2:], cfg, mid)
    for got, want in ((torch.cat([y1, y2], 1), y), (end.conv, whole.conv),
                      (end.h, whole.h)):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


def test_cpu_launches_nothing():
    cfg = _cfg(True).replace(use_flash=True)
    p = _layer(cfg)
    x, state = _inputs(cfg, 7)
    before = mamba_scan.launches, mamba_scan.tokens
    with torch.no_grad():
        _, st = ssm.mamba_fwd(p, x, cfg, state)
        ssm.mamba_decode(p, x[:, :1], cfg, st)
    assert (mamba_scan.launches, mamba_scan.tokens) == before


def test_grad_enabled_call_keeps_the_plain_path():
    """On the CPU a grad-enabled layer call under ``use_flash`` runs the
    plain code (the wrappers' CPU form), so the gradient reaches the
    weights, and it gives the bits of the same call without grad.  (On the
    card the wrappers raise on such a call: ``test_torch_cuda.py``.)"""
    cfg = _cfg(True, "float32").replace(use_flash=True)
    p = _layer(cfg)
    leaves = (p["a_log"], p["conv_w"], p["b_norm"]["scale"])
    for leaf in leaves:
        leaf.requires_grad_()
    x, state = _inputs(cfg, 7)
    y, st = ssm.mamba_fwd(p, x, cfg, state)
    (y.sum() + st.h.sum()).backward()
    assert all(leaf.grad is not None and torch.isfinite(leaf.grad).all()
               for leaf in leaves)
    with torch.no_grad():
        _same(ssm.mamba_fwd(p, x, cfg, state), (y, st.conv, st.h))
        _same(ssm.mamba_fwd(p, x, cfg.replace(use_flash=False), state),
              (y, st.conv, st.h))


def test_engine_counts_mamba_tokens():
    """A tiny paged hybrid engine in chunks of 5: ``mamba_layer_tokens``
    is (chunk tokens + decoded rows, every slot of a decode call) times
    the Mamba layers; the CPU's kernels took none of them."""
    cfg = scale_down(get_config("jamba-v0.1-52b"), layers=8).replace(
        dtype="float32", param_dtype="float32", use_flash=True)
    model = build_model(cfg, "cpu")
    mamba_layers = 7                       # a superblock: 1 attention + 7
    eng = ServingEngine(model, model.init(0), max_batch=3, s_max=32,
                        block_size=8, prefill_chunk=5,
                        prefill_token_budget=5, kv_mode="paged")
    seen = {"chunk": 0, "decode": 0}
    chunk, decode = eng._prefill_chunk, eng._decode

    def count_chunk(params, batch, *args):
        seen["chunk"] += batch["tokens"].shape[1]
        return chunk(params, batch, *args)

    def count_decode(params, tokens, *args):
        seen["decode"] += tokens.shape[0]
        return decode(params, tokens, *args)
    eng._prefill_chunk, eng._decode = count_chunk, count_decode
    rng = np.random.default_rng(0)
    for n in (12, 4, 7):
        eng.submit(rng.integers(0, cfg.vocab_size, n), 3)
    eng.run_until_drained()
    assert seen["chunk"] == 23 and seen["decode"] > 0
    assert eng.io_stats["mamba_layer_tokens"] == mamba_layers * (
        seen["chunk"] + seen["decode"])
    assert eng.io_stats["mamba_kernel_tokens"] == 0
