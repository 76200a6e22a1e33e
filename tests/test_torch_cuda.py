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
