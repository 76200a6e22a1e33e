"""The paper's scheduler in the port against the reference: the six apps,
the cluster simulator, the weighted steal-half-work balancer, the
straggler plan, the checkers (schedlint over both zoos, the interleaving
explorer) and the scheduler core, on the same inputs and seeds."""
import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.analysis.interleave as j_interleave
import repro.analysis.schedlint as j_lint
import repro.apps as j_apps
import repro.cluster as j_cluster
import repro.core as j_core
import repro.core.device.weighted_partition as j_wp
import repro.runtime as j_runtime
import repro_torch.analysis.interleave as t_interleave
import repro_torch.analysis.schedlint as t_lint
import repro_torch.apps as t_apps
import repro_torch.cluster as t_cluster
import repro_torch.core as t_core
import repro_torch.core.device as t_device
import repro_torch.runtime as t_runtime

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: one place: a single worker runs the same schedule in both packages, so
#: every counter of the result equals the reference's
APPS = {
    "bipartition": lambda m: m.bipartition.run_bipartition(
        n=10, density=0.6, max_weight=10, seed=3, num_places=1),
    "prefix_sum": lambda m: m.prefix_sum.run_prefix_sum(n=20_000,
                                                        num_places=1),
    "quicksort": lambda m: m.quicksort.run_quicksort(n=20_000,
                                                     num_places=1),
    "sssp": lambda m: m.sssp.run_sssp(n=200, density=0.05, num_places=1),
    "tristrip": lambda m: m.tristrip.run_tristrip(rows=12, cols=12,
                                                  num_places=1),
    "uts": lambda m: m.uts.run_uts(b0=3.0, max_depth=7, num_places=1),
}


def _untimed(res: dict) -> dict:
    """The result without its wall-clock entries."""
    return {k: v for k, v in res.items()
            if not (k.endswith("_s") or k.endswith("per_s"))}


@pytest.mark.parametrize("app", list(APPS))
def test_app_matches_reference_at_one_place(app):
    want = _untimed(APPS[app](j_apps))
    got = _untimed(APPS[app](t_apps))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


#: results no schedule can change, at four places
FOUR_PLACES = {
    "bipartition-cut": (lambda m: m.bipartition.run_bipartition(
        n=10, density=0.6, max_weight=10, seed=3, num_places=4), "cut"),
    "uts-nodes": (lambda m: m.uts.run_uts(b0=3.0, max_depth=8,
                                          num_places=4), "nodes"),
    "tristrip-triangles": (lambda m: m.tristrip.run_tristrip(
        rows=16, cols=16, num_places=4), "num_triangles"),
}


@pytest.mark.parametrize("case", list(FOUR_PLACES))
def test_app_result_matches_reference_at_four_places(case):
    run, key = FOUR_PLACES[case]
    assert run(t_apps)[key] == run(j_apps)[key]


def _sim_summary(pkg, amount, **kw):
    tel = pkg.run_cluster_sim(4, 240, pkg.StealPolicy(amount=amount),
                              size_dist="pareto", utilization=0.9, seed=5,
                              **kw)
    return tel.summary()


@pytest.mark.parametrize("amount", ["half_work", "half_count", "none"])
def test_sim_summary_matches_reference(amount):
    """The simulator runs on its own modeled clock: the whole summary,
    latencies included, is the reference's."""
    want = _sim_summary(j_cluster, amount)
    got = _sim_summary(t_cluster, amount)
    assert got == want
    assert want["finished"] == 240
    if amount != "none":
        assert want["steal_events"] > 0


def test_sim_with_chaos_and_autoscale_matches_reference():
    def run(pkg, rt):
        chaos = pkg.ChaosSchedule(crashes=(pkg.CrashEvent(t=2.0,
                                                          replica=1),))
        return _sim_summary(pkg, "half_work", chaos=chaos,
                            autoscale=rt.AutoscalePolicy(
                                min_replicas=4, max_replicas=6,
                                target_backlog=128.0))
    want = run(j_cluster, j_runtime)
    assert run(t_cluster, t_runtime) == want
    assert want["chaos"]["crashes"] == 1


def _weights(seed, n):
    """Integer-valued weights: many ties, so tie order is exercised."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 6, n).astype(np.float32)


@pytest.mark.parametrize("seed,n,bins", [(0, 16, 3), (1, 40, 4),
                                         (2, 7, 8), (3, 64, 5)])
def test_greedy_weighted_partition_matches_reference(seed, n, bins):
    w = _weights(seed, n)
    want = np.asarray(j_wp.greedy_weighted_partition(jnp.asarray(w), bins))
    got = t_device.greedy_weighted_partition(torch.from_numpy(w), bins)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    cost = t_device.partition_cost(torch.from_numpy(w), got, bins)
    assert float(cost) == float(j_wp.partition_cost(
        jnp.asarray(w), jnp.asarray(want), bins))


@pytest.mark.parametrize("loads", [[10, 1, 1, 4, 7], [5, 5, 5, 5],
                                   [0, 0, 9, 0], [3, 3, 1, 1, 8, 8],
                                   [100, 1, 1, 1, 1, 1, 1, 1],
                                   [0.3, 7.1, 2.9, 1e3, 5.5, 1.25]])
def test_steal_half_transfers_matches_reference(loads):
    """Bit for bit: the same float32 operations in the same order (ties
    included: equal loads pick the first bin in both)."""
    x = np.asarray(loads, np.float32)
    jt, jc = j_wp.steal_half_transfers(jnp.asarray(x))
    tt, tc = t_device.steal_half_transfers(torch.from_numpy(x))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def _detector(pkg, speeds):
    det = pkg.StragglerDetector(num_hosts=len(speeds))
    for step in range(5):
        for h, s in enumerate(speeds):
            det.record_step(h, s * (1.0 + 0.01 * step))
    return det


@pytest.mark.parametrize("speeds,shards", [
    ([1.0, 1.0, 3.0, 1.0], [8, 8, 8, 8]),
    ([0.5, 2.0, 1.0], [10, 4, 6]),
    ([1.0, 1.0], [5, 5]),
])
def test_mitigation_plan_matches_reference(speeds, shards):
    shards = np.asarray(shards)
    want = _detector(j_runtime, speeds).mitigation_plan(shards)
    got = _detector(t_runtime, speeds).mitigation_plan(shards)
    np.testing.assert_array_equal(got, want)
    assert _detector(t_runtime, speeds).stragglers() == \
        _detector(j_runtime, speeds).stragglers()


def test_mitigation_plan_before_every_host_reported():
    det = t_runtime.StragglerDetector(num_hosts=3)
    det.record_step(0, 1.0)
    np.testing.assert_array_equal(det.mitigation_plan(np.ones(3)),
                                  np.zeros((3, 3)))


# -- the checkers -----------------------------------------------------------

def test_schedlint_source_differs_only_in_strategy_modules():
    port = (ROOT / "src/repro_torch/analysis/schedlint.py").read_text()
    ref = (ROOT / "src/repro/analysis/schedlint.py").read_text()

    def without_modules(text):
        node = next(n for n in ast.parse(text).body
                    if isinstance(n, ast.Assign)
                    and n.targets[0].id == "STRATEGY_MODULES")
        lines = text.splitlines(keepends=True)
        return "".join(lines[:node.lineno - 1] + lines[node.end_lineno:])
    assert without_modules(port) == without_modules(ref)
    assert t_lint.STRATEGY_MODULES == tuple(
        m.replace("repro.", "repro_torch.", 1)
        for m in j_lint.STRATEGY_MODULES)


def test_schedlint_zoo_matches_reference():
    names = sorted(c.__name__ for c in t_lint.discover_strategies())
    assert names == sorted(c.__name__ for c in j_lint.discover_strategies())
    assert len(names) == 12
    assert all(c.__module__.startswith("repro_torch.")
               for c in t_lint.discover_strategies())
    want = [(f.level, f.rule) for f in j_lint.run_lint()]
    assert [(f.level, f.rule) for f in t_lint.run_lint()] == want
    assert not [lvl for lvl, _ in want if lvl == "error"]
    assert {c.name for c in t_lint.default_cohorts(
        t_lint.discover_strategies())} == {c.name for c in
                                           j_lint.default_cohorts(
                                               j_lint.discover_strategies())}


def _faults(core):
    class Cycle(core.PriorityStrategy):
        def prioritize(self, other):
            return (self.priority, other.priority) in \
                {(0.0, 1.0), (1.0, 2.5), (2.5, 0.0)}

    class Reflexive(core.PriorityStrategy):
        def prioritize(self, other):
            return self.priority <= other.priority

    class TupleKeyed(core.PriorityStrategy):
        def __init__(self, priority, **kw):
            super().__init__(priority=(float(priority), 0.0), **kw)

    class Overshoot(core.MergePolicy):
        def chunk_size(self, queue_depth, remaining):
            return remaining + 1
    return dict(cycle=("classes", [Cycle]),
                reflexive=("classes", [Reflexive]),
                clash=("cohort", [core.PriorityStrategy, TupleKeyed]),
                overshoot=("policy", Overshoot()))


@pytest.mark.parametrize("fault", ["cycle", "reflexive", "clash",
                                   "overshoot"])
def test_schedlint_finds_the_reference_rules(fault):
    def rules(lint, core):
        kind, arg = _faults(core)[fault]
        if kind == "classes":
            found = lint.lint_classes(arg)
        elif kind == "cohort":
            found = lint.lint_cohort(lint.Cohort("clash", arg))
        else:
            found = lint.lint_merge_policy(arg)
        return sorted((f.level, f.rule) for f in found)
    want = rules(j_lint, j_core)
    assert want
    assert rules(t_lint, t_core) == want


@pytest.mark.parametrize("storage", ["StrategyTaskStorage",
                                     "DequeTaskStorage"])
def test_interleave_explorer_matches_reference(storage):
    sched = [[("push", 0, 2.0, 1), ("push", 1, 1.0, 2), ("pop",),
              ("cancel", 0), ("pop",)],
             [("steal", 1), ("compact",), ("steal", 1)]]

    def run(interleave, core):
        res = interleave.explore(sched, lambda: getattr(core, storage)(0))
        return (res.ok, res.truncated, res.interleavings, res.states,
                res.edges, res.replays, res.ops_executed)
    want = run(j_interleave, j_core)
    assert want[0] and want[2] == 56          # 8! / (5! 3!)
    assert run(t_interleave, t_core) == want


def _sim_crash(cluster, analysis, request_scheduler):
    """Three requests on two simulated replicas, one replica failed: the
    router's conservation invariants hold before and after."""
    clock = cluster.SimClock()
    reps = [cluster.SimReplica(i, clock, slots=1) for i in range(2)]
    router = cluster.ClusterRouter(reps, now=clock.now)
    for n in (30, 40, 50):
        router.submit(request_scheduler.Request(prompt_len=n,
                                                max_new_tokens=8,
                                                arrival=0.0))
    analysis.check_router(router)
    router.fail_replica(0)
    analysis.check_router(router)
    return router.displaced_total, router.replayed_total


def test_invariants_check_a_crashed_router():
    import repro.analysis as j_analysis
    import repro.core.device.request_scheduler as j_rs
    import repro_torch.analysis as t_analysis
    import repro_torch.core.device.request_scheduler as t_rs
    want = _sim_crash(j_cluster, j_analysis, j_rs)
    assert want[0] == want[1] > 0
    assert _sim_crash(t_cluster, t_analysis, t_rs) == want


def _fib_metrics(core, scheduler):
    """fib(12) through the scheduler's own spawn/finish API at one place."""
    def fib(n):
        if n < 2:
            return n
        box = [0, 0]

        def left():
            box[0] = fib(n - 1)

        def right():
            box[1] = fib(n - 2)
        with core.finish():
            core.spawn(left)
            core.spawn(right)
        return box[0] + box[1]
    sched = (core.StrategyScheduler if scheduler == "strategy"
             else core.WorkStealingScheduler)(num_places=1)
    out = sched.run(fib, 12)
    return out, sched.metrics.snapshot()


@pytest.mark.parametrize("scheduler", ["strategy", "deque"])
def test_scheduler_core_matches_reference(scheduler):
    want = _fib_metrics(j_core, scheduler)
    assert want[0] == 144
    assert _fib_metrics(t_core, scheduler) == want
