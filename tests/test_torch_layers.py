"""The port's building blocks against ``repro.models.layers`` on the same
numpy inputs (fp32, atol 1e-5)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

RNG = np.random.default_rng(0)


def _np(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol)


def test_rms_norm():
    x, scale = _np(2, 5, 64), _np(64)
    _close(tl.rms_norm({"scale": torch.from_numpy(scale)},
                       torch.from_numpy(x), 1e-6),
           jl.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0, 0.0])
def test_apply_rope(theta):
    x = _np(2, 7, 4, 16)
    pos = RNG.integers(0, 300, (2, 7))
    _close(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


def test_linear_with_bias():
    x, w, b = _np(3, 4, 32), _np(32, 48), _np(48)
    _close(tl.linear({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                     torch.from_numpy(x)),
           jl.linear({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                     jnp.asarray(x)))


def test_mlp():
    x = _np(2, 3, 32)
    p = {n: {"w": _np(*shape) / 6} for n, shape in
         (("gate", (32, 64)), ("up", (32, 64)), ("down", (64, 32)))}
    tp = {n: {"w": torch.from_numpy(d["w"])} for n, d in p.items()}
    jp = {n: {"w": jnp.asarray(d["w"])} for n, d in p.items()}
    _close(tl.mlp(tp, torch.from_numpy(x)), jl.mlp(jp, jnp.asarray(x)))


def test_embed():
    table = _np(50, 16)
    tokens = RNG.integers(0, 50, (3, 9))
    _close(tl.embed({"table": torch.from_numpy(table)},
                    torch.from_numpy(tokens)),
           jl.embed({"table": jnp.asarray(table)}, jnp.asarray(tokens)),
           atol=0)


def test_init_distributions():
    """Same trees and distributions as the reference inits (the numbers
    differ: the generators do)."""
    g = torch.Generator().manual_seed(0)
    lin = tl.init_linear(g, 256, 512, bias=True, dtype=torch.float32)
    assert lin["w"].shape == (256, 512) and torch.all(lin["b"] == 0)
    assert abs(lin["w"].std().item() - 256 ** -0.5) < 2e-3
    emb = tl.init_embedding(g, 1000, 64, dtype=torch.bfloat16)
    assert emb["table"].dtype == torch.bfloat16
    assert abs(emb["table"].float().std().item() - 0.02) < 1e-3
    assert torch.all(tl.init_rms_norm(8)["scale"] == 1)
