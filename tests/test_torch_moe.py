"""The port's MoE dispatch and layer against ``repro.core.device.moe_balance``
and ``repro.models.moe`` on the same logits and weights: the dispatch plan
bit for bit (both policies, with and without restealing, dropless and under
capacity pressure, and with exactly tied router probabilities), gather and
combine within 1e-6, and ``moe_fwd`` within 1e-5 (fp32).  Then the
``kernels/moe_dispatch`` wrappers on CPU tensors against the plain
functions, and the CUDA kernels' algorithms (``ref.py``) against them."""
from itertools import product

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
from repro_torch.kernels.moe_dispatch import ops as mdo
from repro_torch.kernels.moe_dispatch import ref as mdr
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


#: (T, E, k, C): Mixtral's decode (T = max_batch) and chunk, Jamba's 16
#: experts, Kimi's 384 at decode and at a 1024-token chunk, all dropless;
#: then droppy shapes (Mixtral at capacity 6, and the odd shapes above)
DISPATCH_CASES = [(32, 8, 2, 32), (512, 8, 2, 512), (1024, 16, 2, 1024),
                  (8, 384, 8, 8), (1024, 384, 8, 1024), (48, 8, 2, 6),
                  (33, 5, 3, 4), (17, 12, 1, 2)]
MODES = list(product(("priority", "arrival"), (False, True)))


def _router_logits(t, e, seed, ties=False):
    rng = np.random.default_rng(seed)
    if ties:
        return torch.from_numpy(rng.integers(-2, 3, (t, e)).astype(
            np.float32))
    return torch.from_numpy(rng.standard_normal((t, e)).astype(
        np.float32) * 2)


@pytest.mark.parametrize("t,e,k,cap", DISPATCH_CASES)
def test_dispatch_wrappers_on_cpu_are_the_plain_functions(t, e, k, cap):
    """On CPU tensors ``moe_route``, ``moe_dispatch`` and ``moe_combine``
    return what ``route_topk``, ``priority_dispatch``,
    ``gather_expert_inputs``, the aux loss and ``combine_expert_outputs``
    return, bit for bit, for both policies with and without restealing."""
    logits = _router_logits(t, e, seed=t + e + k)
    x = torch.randn(t, 16, generator=torch.Generator().manual_seed(t))
    y = torch.randn(e, cap, 16, generator=torch.Generator().manual_seed(e))
    routing = mdo.moe_route(logits, k, alt=True)
    for got, want in zip(routing, tmb.route_topk(logits, k)):
        assert torch.equal(got, want)
    for policy, resteal in MODES:
        kw = dict(num_experts=e, capacity=cap, policy=policy,
                  resteal=resteal)
        sent = mdo.moe_dispatch(x, routing, **kw)
        plan = tmb.priority_dispatch(*routing[:3], **kw)
        for name in plan._fields:
            assert torch.equal(getattr(sent.plan, name),
                               getattr(plan, name)), name
        assert torch.equal(sent.buf, tmb.gather_expert_inputs(x, plan, k))
        me = routing.probs.mean(0)
        ce = plan.load.float() / torch.clamp(plan.load.sum(), min=1)
        assert torch.equal(sent.aux_loss, e * torch.sum(me * ce))
        assert torch.equal(mdo.moe_combine(y, sent, t, k),
                           tmb.combine_expert_outputs(y, plan, t, k))
    assert mdo.rank_passes(t, cap, True) == (2 if cap < t else 1)
    assert mdo.rank_list(t, k, cap, False) == t


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("t,e,k,cap", DISPATCH_CASES)
def test_kernel_algorithms_match_the_plain_dispatch(t, e, k, cap, ties):
    """The CUDA kernels' algorithms in plain PyTorch (``ref.py``): the
    route's (k+1)-th choice is the plain path's masked argmax; ranking each
    expert's assignments by (priority, index), with the resteal pass
    skipped where capacity >= T, gives ``priority_dispatch``'s plan; the
    combine over each assignment's slot gives ``combine_expert_outputs``'s
    bits.  Both policies, with and without restealing, and with exactly
    tied probabilities."""
    logits = _router_logits(t, e, seed=3 * t + e, ties=ties)
    routing = mdr.moe_route_plain(logits, k)
    alt_e, alt_p = mdr.route_alt_plain(routing.probs, k)
    chosen = torch.zeros(t, e, dtype=torch.bool)
    chosen.scatter_(1, routing.expert_idx.long(), True)
    masked = torch.where(chosen, float("-inf"), routing.probs)
    assert torch.equal(alt_e, masked.argmax(-1).int())
    assert torch.equal(alt_p, masked.amax(-1))
    routing = routing._replace(alt_expert=alt_e, alt_prob=alt_p)
    y = torch.randn(e, cap, 8, generator=torch.Generator().manual_seed(k))
    for policy, resteal in MODES:
        kw = dict(num_experts=e, capacity=cap, policy=policy,
                  resteal=resteal)
        plan = tmb.priority_dispatch(*routing[:3], **kw)
        ranked, slot = mdr.dispatch_ranked_plain(routing, **kw)
        for name in PLAN_EXACT + ("gate",):
            assert torch.equal(getattr(ranked, name), getattr(plan, name)), \
                (name, policy, resteal)
        # summed by expert, then over the experts: another fp32 order
        torch.testing.assert_close(ranked.dropped_mass, plan.dropped_mass,
                                   rtol=1e-6, atol=1e-6)
        kept = slot >= 0
        assert torch.equal(kept, plan.kept)
        flat = plan.slot_src.reshape(-1)
        assert torch.equal(flat[slot[kept].long()],
                           torch.arange(t * k).reshape(t, k)[kept].int())
        assert torch.equal(mdr.combine_by_slot_plain(y, slot, ranked.gate),
                           tmb.combine_expert_outputs(y, plan, t, k))
