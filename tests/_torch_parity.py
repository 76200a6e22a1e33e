"""Shared set-up for the parity tests of the PyTorch port against the JAX
reference: the same small fp32 config of an architecture in both packages,
and the same parameters (drawn by the reference, bridged to the port
through numpy)."""
import dataclasses

import jax
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import scale_down as jax_scale_down
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config, scale_down
from repro_torch.models import build_model
from repro_torch.params import from_numpy_params

FP32 = dict(dtype="float32", param_dtype="float32")


def assert_same_config(jcfg, tcfg):
    """The port's config has every field of the reference's, equal, and
    its port-only fields (``ModelConfig``'s marked block, which the
    reference has not) at their defaults: the behaviour both share."""
    want = dataclasses.asdict(jcfg)
    got = dataclasses.asdict(tcfg)
    assert {k: got[k] for k in want if k in got} == want
    defaults = {f.name: f.default for f in dataclasses.fields(tcfg)}
    assert {k: v for k, v in got.items() if k not in want} == \
        {k: defaults[k] for k in got if k not in want}


def configs(arch="qwen2-1.5b", layers=2, **over):
    """(reference cfg, port cfg): scaled-down ``arch`` in fp32."""
    jcfg = jax_scale_down(jax_get_config(arch), layers=layers).replace(
        **FP32, **over)
    tcfg = scale_down(get_config(arch), layers=layers).replace(**FP32,
                                                               **over)
    assert_same_config(jcfg, tcfg)
    return jcfg, tcfg


#: leaves the reference initialises to constants: biases (0), norm scales
#: (1), RWKV's token-shift mixes (0.5) and decay bias (-2), and Mamba's
#: conv bias (0) and skip (1)
CONSTANT_LEAVES = ("b", "bias", "scale", "mu_x", "mu_k", "mu_r", "maa", "w0",
                   "conv_b", "d_skip")


def perturb(tree, rng):
    """Add N(0, 0.3) noise to the leaves the reference initialises to
    constants, so the parity tests exercise them (dicts and lists walked in
    order)."""
    if isinstance(tree, dict):
        return {k: (rng.normal(0, 0.3, np.shape(v)).astype(np.float32)
                    + np.asarray(v, np.float32)
                    if k in CONSTANT_LEAVES else perturb(v, rng))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [perturb(v, rng) for v in tree]
    return tree


def models(seed=0, arch="qwen2-1.5b", **over):
    """Reference model + params and port model + params on the CPU, with
    identical weights."""
    jcfg, tcfg = configs(arch, **over)
    jmodel = jax_build_model(jcfg)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    tree = perturb(tree, np.random.default_rng(seed))
    jparams = jax.tree.map(jax.numpy.asarray, tree)
    tmodel = build_model(tcfg, "cpu")
    tparams = from_numpy_params(tree, tcfg, "cpu")
    return jmodel, jparams, tmodel, tparams


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)
