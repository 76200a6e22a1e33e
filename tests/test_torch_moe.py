"""The port's MoE dispatch and layer against ``repro.core.device.moe_balance``
and ``repro.models.moe`` on the same logits and weights: the dispatch plan
bit for bit (both policies, with and without restealing, dropless and under
capacity pressure, and with exactly tied router probabilities), gather and
combine within 1e-6, and ``moe_fwd`` within 1e-5 (fp32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import scale_down as jax_scale_down
from repro.core.device import moe_balance as jmb
from repro.models import moe as jmoe
from repro_torch.configs import get_config, scale_down
from repro_torch.core.device import moe_balance as tmb
from repro_torch.models import moe as tmoe

from _torch_parity import FP32, to_np

PLAN_EXACT = ("slot_src", "kept", "expert", "load")


def _logits(t, e, seed, k=2, ties=False):
    """Seeded router logits whose margins among each token's k + 1 best
    experts (the top-k and the resteal choice) are clear of fp32 rounding,
    or exactly tied where asked: a different choice between the two
    frameworks is then a fault, not a near-tie."""
    rng = np.random.default_rng(seed)
    if ties:    # a few distinct values: many exactly tied probabilities
        return rng.integers(-2, 3, (t, e)).astype(np.float32)
    x = rng.standard_normal((t, e)).astype(np.float32) * 2
    p = np.sort(np.exp(x) / np.exp(x).sum(-1, keepdims=True), -1)[:, ::-1]
    assert np.diff(-p[:, :k + 1], axis=-1).min() > 1e-5
    return x


def _route_both(logits, k):
    j = jmb.route_topk(jnp.asarray(logits), k)
    t = tmb.route_topk(torch.from_numpy(logits), k)
    return j, t


def _plans(logits, k, e, cap, policy, resteal):
    (je, jg, jp), (te, tg, tp) = _route_both(logits, k)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    kw = dict(num_experts=e, capacity=cap, policy=policy, resteal=resteal)
    return jmb.priority_dispatch(je, jg, jp, **kw), \
        tmb.priority_dispatch(te, tg, tp, **kw)


def _assert_plans_equal(jplan, tplan):
    for name in PLAN_EXACT:
        np.testing.assert_array_equal(getattr(tplan, name).numpy(),
                                      np.asarray(getattr(jplan, name)), name)
    np.testing.assert_allclose(tplan.gate.numpy(), np.asarray(jplan.gate),
                               atol=1e-6)
    np.testing.assert_allclose(tplan.dropped_mass.numpy(),
                               np.asarray(jplan.dropped_mass), atol=1e-6)


@pytest.mark.parametrize("resteal", [False, True])
@pytest.mark.parametrize("policy", ["priority", "arrival"])
@pytest.mark.parametrize("t,e,k,cap", [(48, 8, 2, 48), (48, 8, 2, 6),
                                       (33, 5, 3, 4), (17, 12, 1, 2)])
def test_dispatch_plan_bit_identical(t, e, k, cap, policy, resteal):
    jplan, tplan = _plans(_logits(t, e, seed=t * e + k, k=k), k, e, cap,
                          policy, resteal)
    _assert_plans_equal(jplan, tplan)
    assert (int(jplan.load.sum()) < t * k) == (cap < t)   # drops iff droppy


@pytest.mark.parametrize("resteal", [False, True])
@pytest.mark.parametrize("policy", ["priority", "arrival"])
def test_dispatch_plan_with_exact_ties(policy, resteal):
    t, e, k, cap = 40, 6, 2, 9
    logits = _logits(t, e, seed=11, ties=True)
    probs = np.sort(logits, -1)
    assert (np.diff(probs, axis=-1) == 0).any(-1).mean() > 0.5
    jplan, tplan = _plans(logits, k, e, cap, policy, resteal)
    _assert_plans_equal(jplan, tplan)


def test_gather_and_combine_match_reference():
    t, e, k, d, cap = 32, 4, 2, 8, 12
    (je, jg, jp), (te, tg, tp) = _route_both(_logits(t, e, seed=2), k)
    kw = dict(num_experts=e, capacity=cap, resteal=True)
    jplan = jmb.priority_dispatch(je, jg, jp, **kw)
    tplan = tmb.priority_dispatch(te, tg, tp, **kw)
    x = np.random.default_rng(3).standard_normal((t, d)).astype(np.float32)
    jbuf = jmb.gather_expert_inputs(jnp.asarray(x), jplan, k)
    tbuf = tmb.gather_expert_inputs(torch.from_numpy(x), tplan, k)
    np.testing.assert_allclose(to_np(tbuf), to_np(jbuf), atol=1e-6)
    y = np.random.default_rng(4).standard_normal((e, cap, d)).astype(
        np.float32)
    np.testing.assert_allclose(
        to_np(tmb.combine_expert_outputs(torch.from_numpy(y), tplan, t, k)),
        to_np(jmb.combine_expert_outputs(jnp.asarray(y), jplan, t, k)),
        atol=1e-6)


@pytest.mark.parametrize("dropless", [True, False])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_moe_fwd_matches_reference(use_kernel, dropless):
    over = dict(FP32, moe_dropless=dropless)
    jcfg = jax_scale_down(jax_get_config("mixtral-8x22b")).replace(**over)
    tcfg = scale_down(get_config("mixtral-8x22b")).replace(**over)
    p = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(0), jcfg,
                                               jnp.float32))
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), p)
    x = np.random.default_rng(1).standard_normal(
        (2, 9, jcfg.d_model)).astype(np.float32)
    jy, jstats = jmoe.moe_fwd(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              jcfg, use_kernel=use_kernel)
    ty, tstats = tmoe.moe_fwd(tp, torch.from_numpy(x), tcfg,
                              use_kernel=use_kernel)
    np.testing.assert_allclose(to_np(ty), to_np(jy), atol=1e-5)
    np.testing.assert_array_equal(tstats.load.numpy(), np.asarray(jstats.load))
    np.testing.assert_allclose(float(tstats.dropped_mass),
                               float(jstats.dropped_mass), atol=1e-6)
    np.testing.assert_allclose(float(tstats.aux_loss),
                               float(jstats.aux_loss), atol=1e-6)
    assert tmoe.moe_capacity(tcfg, 18) == jmoe.moe_capacity(jcfg, 18)
