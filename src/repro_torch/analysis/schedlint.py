"""schedlint: static lints over the strategy zoo.

``heapq`` and the storage's cross-group head comparison assume properties
of ``prioritize``/``steal_prioritize`` that Python never enforces: each
concrete strategy type must induce a **strict weak order** (its group is a
binary heap in that order), every pair of types that can share a storage
must compare without raising under the LCA composition, tuple priorities
must be element-wise comparable across co-resident classes, and
``transitive_weight`` must stay positive (steal-half-*work* divides by it
in spirit; a zero-weight queue degenerates the steal target).  A violation
of any of these does not crash at the call site — it silently corrupts
heap order, which surfaces as starvation or priority inversion far away.

The lint discovers every :class:`~repro.core.strategy.BaseStrategy`
subclass defined in the scheduler's three strategy modules, instantiates a
small synthetic population per class (samplers keyed by nearest known
ancestor, so subclasses with inherited constructors are covered
automatically), and checks:

* **SL10x / SL11x — comparator lawfulness** (``prioritize`` /
  ``steal_prioritize`` respectively): irreflexivity (x1), asymmetry (x2)
  and transitivity (x3) at error level; transitivity of incomparability —
  the strict-*weak*-order completion, needed for "equal priority" to be an
  equivalence — at warning level (x4); a comparator that raises is x0.
* **SL120/SL121 — composition lawfulness**: irreflexivity and asymmetry of
  :func:`~repro.core.strategy.local_before` /
  :func:`~repro.core.strategy.steal_before` over each storage cohort's
  mixed population.  (Cross-type *transitivity* is deliberately not
  required: the storage compares group heads pairwise, so only per-type
  orders feed heaps — see ``docs/analysis.md``.)
* **SL130/SL131 — priority-key shape compatibility**: for every cohort
  pair whose LCA comparison reads ``.priority``, sampled keys must compare
  without ``TypeError`` (error) and tuple keys should share arity
  (warning: prefix comparison is well-defined but semantically blind).
* **SL140 — steal-class legality**: where co-resident classes declare
  ``steal_class``, a strictly smaller class must be stolen strictly first.
* **SL150 — transitive-weight positivity**: sampled instances carry
  ``transitive_weight >= 1`` and ``set_transitive_weight`` clamps to it.
* **SL160/SL161 — merge-policy legality**: ``chunk_size`` must return a
  value in ``[1, remaining]`` for every ``remaining >= 1`` (error; an
  overshoot makes ``spawn_many`` emit a chunk task for work that does not
  exist, an undershoot livelocks the spawn loop), and ``max_chunk <
  min_chunk`` is flagged (warning).
* **SL170 — merging delegation**: a merged chunk must inherit its
  representative's deadness (a chunk that outlives a dead rep resurrects
  cancelled work) and keep a positive weight.

Run as ``python -m repro.analysis.schedlint``; exits 1 on errors, 0 on
warnings (1 with ``--strict``).  The mutation harness drives
:func:`run_lint` directly with injected fault classes.
"""
from __future__ import annotations

import argparse
import inspect
import sys
from dataclasses import dataclass
from itertools import combinations, permutations
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from ..core.strategy import (BaseStrategy, DepthFirstStrategy, FifoStrategy,
                             MergePolicy, MergingStrategy, PriorityStrategy,
                             RandomStealStrategy, local_before,
                             lowest_common_ancestor, steal_before)

__all__ = ["Finding", "Cohort", "run_lint", "discover_strategies",
           "default_cohorts", "lint_classes", "lint_cohort",
           "lint_merge_policy", "main"]

#: the modules the zoo lives in — discovery keeps subclasses defined here
#: (test- and harness-local classes are linted via explicit injection).
STRATEGY_MODULES = (
    "repro_torch.core.strategy",
    "repro_torch.core.device.request_scheduler",
    "repro_torch.serving.speculative",
)


@dataclass
class Finding:
    level: str          # "error" | "warning"
    rule: str           # e.g. "SL103"
    message: str
    file: str = "<unknown>"
    line: int = 0

    def render(self) -> str:
        return f"{self.file}:{self.line}: {self.level}[{self.rule}] " \
               f"{self.message}"


@dataclass
class Cohort:
    """A set of strategy classes that can be co-resident in one storage
    (and therefore compared against each other via the LCA composition)."""
    name: str
    classes: List[type]


def _locate(cls: type, attr: Optional[str] = None) -> Tuple[str, int]:
    """file:line of ``cls`` (or of the class in ``cls``'s MRO that defines
    ``attr`` — the diagnostic should point at the offending comparator,
    not at a subclass that merely inherits it)."""
    target = cls
    if attr is not None:
        for c in cls.__mro__:
            if attr in c.__dict__:
                target = c
                break
    try:
        src = inspect.getsourcefile(target) or "<unknown>"
        _, line = inspect.getsourcelines(
            target.__dict__[attr] if attr is not None
            and attr in target.__dict__ else target)
        return src, line
    except (OSError, TypeError):
        return "<unknown>", 0


# --------------------------------------------------------------------------
# Instance samplers
# --------------------------------------------------------------------------
# Keyed by known ancestor; a discovered class is sampled by the factory of
# the nearest registered class in its MRO, constructing the *discovered*
# class — so a subclass that only overrides a comparator is exercised
# without its own sampler.

def _sample_base(cls: type) -> List[BaseStrategy]:
    return [cls(place=p) for p in (None, None, 7, 7, None)]


def _sample_priority(cls: type) -> List[BaseStrategy]:
    return [cls(priority=p, transitive_weight=w)
            for p, w in ((0.0, 1), (0.0, 3), (1.0, 2), (2.5, 1), (-1.0, 4))]


def _sample_random_steal(cls: type) -> List[BaseStrategy]:
    return [cls(priority=p, steal_key=s)
            for p, s in ((0.0, 0.3), (0.0, 0.9), (1.0, 0.1), (2.0, 0.5))]


def _sample_depth_first(cls: type) -> List[BaseStrategy]:
    return [cls(depth=d, max_depth=6, place=pl)
            for d, pl in ((0, None), (2, None), (5, None),
                          (1, 999), (4, 999), (2, None))]


def _sample_merging(cls: type) -> List[BaseStrategy]:
    return [cls(rep=PriorityStrategy(priority=p), merged_count=n)
            for p, n in ((0.0, 2), (1.0, 4), (3.0, 1))]


def _fixed_now() -> float:
    return 1000.0


def _sample_request(cls: type) -> List[BaseStrategy]:
    from ..core.device.request_scheduler import Request
    reqs = [
        Request(prompt_len=64, max_new_tokens=32, priority=0.0,
                deadline=None, arrival=1.0),
        Request(prompt_len=64, max_new_tokens=32, priority=0.0,
                deadline=50.0, arrival=2.0),
        Request(prompt_len=512, max_new_tokens=8, priority=1.0,
                deadline=None, arrival=3.0),
        Request(prompt_len=16, max_new_tokens=128, priority=1.0,
                deadline=2000.0, arrival=4.0),
        Request(prompt_len=256, max_new_tokens=64, priority=2.0,
                deadline=None, arrival=5.0),
    ]
    reqs[2].cached_prefix = 448            # cache-aware: mostly-cached prompt
    reqs[4].cached_prefix = 64
    return [cls(r, _fixed_now) for r in reqs]


def _sample_spec(cls: type) -> List[BaseStrategy]:
    return [cls(cls_key=k, steal_class=sc, slot=i, weight=w)
            for i, (k, sc, w) in enumerate(
                ((-1.0, 1.0, 3), (-1.0, 1.0, 5),
                 (float(2 ** 40), 0.0, 1), (float(2 ** 40), 0.0, 4)))]


def _sample_draft(cls: type) -> List[BaseStrategy]:
    return [cls(kind, slot, k=k)
            for kind, slot, k in (("warm", 0, 1), ("propose", 1, 4),
                                  ("propose", 2, 2), ("warm", 3, 1))]


def _sample_verify(cls: type) -> List[BaseStrategy]:
    return [cls(slot, proposals)
            for slot, proposals in ((0, [1, 2, 3]), (1, [7]),
                                    (2, [4, 5]), (3, [9, 9, 9, 9]))]


def _sampler_registry() -> Dict[type, Callable[[type], List[BaseStrategy]]]:
    reg: Dict[type, Callable[[type], List[BaseStrategy]]] = {
        BaseStrategy: _sample_base,
        FifoStrategy: _sample_base,
        PriorityStrategy: _sample_priority,
        RandomStealStrategy: _sample_random_steal,
        DepthFirstStrategy: _sample_depth_first,
        MergingStrategy: _sample_merging,
    }
    try:
        from ..core.device.request_scheduler import RequestStrategy
        reg[RequestStrategy] = _sample_request
    except ImportError:                              # pragma: no cover
        pass
    try:
        from ..serving.speculative import (DraftStrategy, SpecStrategy,
                                           VerifyStrategy)
        reg[SpecStrategy] = _sample_spec
        reg[DraftStrategy] = _sample_draft
        reg[VerifyStrategy] = _sample_verify
    except ImportError:                              # pragma: no cover
        pass
    return reg


def sample(cls: type) -> Optional[List[BaseStrategy]]:
    """Synthetic population of ``cls`` via the nearest registered sampler
    in its MRO; None when no sampler applies (reported as SL001)."""
    reg = _sampler_registry()
    for c in cls.__mro__:
        f = reg.get(c)
        if f is not None:
            try:
                return f(cls)
            except Exception:
                return None
    return None


# --------------------------------------------------------------------------
# Discovery and cohorts
# --------------------------------------------------------------------------

def discover_strategies() -> List[type]:
    """Every ``BaseStrategy`` subclass defined in the strategy modules
    (imported here, so a bare ``schedlint`` run sees the whole zoo)."""
    import importlib
    for m in STRATEGY_MODULES:
        importlib.import_module(m)
    found: List[type] = [BaseStrategy]
    stack = [BaseStrategy]
    while stack:
        for sub in stack.pop().__subclasses__():
            if sub not in found:
                found.append(sub)
                stack.append(sub)
    return [c for c in found if c.__module__ in STRATEGY_MODULES]


def default_cohorts(classes: Sequence[type]) -> List[Cohort]:
    """Co-residency model of the repo: one cohort per storage population
    that actually occurs (apps scheduler, each batcher admission mode, the
    speculator's draft/verify storage) plus the *declared* spec-vs-request
    compatibility contract (``serving.speculative.SPEC_KEY_ARITY``)."""
    by_name = {c.__name__: c for c in classes}

    def pick(*names: str) -> List[type]:
        return [by_name[n] for n in names if n in by_name]

    cohorts = [
        Cohort("apps", pick("BaseStrategy", "FifoStrategy",
                            "PriorityStrategy", "RandomStealStrategy",
                            "DepthFirstStrategy", "MergingStrategy")),
        Cohort("batcher-strategy", pick("RequestStrategy")),
        Cohort("batcher-fifo", pick("FifoRequestStrategy")),
        Cohort("batcher-cache", pick("CacheAwareStrategy")),
        Cohort("speculator", pick("DraftStrategy", "VerifyStrategy")),
        Cohort("spec-request-compat",
               pick("RequestStrategy", "DraftStrategy", "VerifyStrategy")),
    ]
    return [c for c in cohorts if c.classes]


# --------------------------------------------------------------------------
# Per-class comparator lawfulness (SL10x local, SL11x steal)
# --------------------------------------------------------------------------

def _relation(name: str) -> Callable[[BaseStrategy, BaseStrategy], bool]:
    def rel(a: BaseStrategy, b: BaseStrategy) -> bool:
        return bool(getattr(a, name)(b))
    return rel


def _check_order(cls: type, pop: Sequence[BaseStrategy], attr: str,
                 base_rule: int, findings: List[Finding]) -> None:
    rel = _relation(attr)
    file, line = _locate(cls, attr)

    def err(off: int, msg: str) -> None:
        findings.append(Finding("error", f"SL{base_rule + off}",
                                f"{cls.__name__}.{attr}: {msg}", file, line))

    try:
        for a in pop:
            if rel(a, a):
                err(1, "not irreflexive: an instance orders before itself "
                       "(heap sift would loop on equal keys)")
                return
        for a, b in permutations(pop, 2):
            if rel(a, b) and rel(b, a):
                err(2, f"not asymmetric: {a!r} and {b!r} each claim to "
                       f"come first — heap order is undefined")
                return
        for a, b, c in permutations(pop, 3):
            if rel(a, b) and rel(b, c) and not rel(a, c):
                err(3, f"not transitive: {a!r} < {b!r} < {c!r} but not "
                       f"{a!r} < {c!r} — a cycle a heap cannot sort")
                return
        # strict WEAK order: incomparability must be transitive, else
        # "equal priority" is not an equivalence and pop order depends on
        # heap layout history.
        for a, b, c in permutations(pop, 3):
            inc_ab = not rel(a, b) and not rel(b, a)
            inc_bc = not rel(b, c) and not rel(c, b)
            inc_ac = not rel(a, c) and not rel(c, a)
            if inc_ab and inc_bc and not inc_ac:
                findings.append(Finding(
                    "warning", f"SL{base_rule + 4}",
                    f"{cls.__name__}.{attr}: incomparability is not "
                    f"transitive ({a!r} ~ {b!r} ~ {c!r} but {a!r} !~ "
                    f"{c!r}): a strict order but not a strict weak one; "
                    f"tie-break order is layout-dependent", file, line))
                return
    except Exception as e:
        err(0, f"comparator raised {type(e).__name__}: {e}")


def lint_classes(classes: Sequence[type]) -> List[Finding]:
    """Per-class checks: comparator lawfulness (both relations) and
    transitive-weight positivity."""
    findings: List[Finding] = []
    for cls in classes:
        pop = sample(cls)
        if not pop:
            file, line = _locate(cls)
            findings.append(Finding(
                "warning", "SL001",
                f"{cls.__name__}: no sampler can instantiate this class; "
                f"comparators unchecked (register one in "
                f"repro.analysis.schedlint)", file, line))
            continue
        _check_order(cls, pop, "prioritize", 100, findings)
        _check_order(cls, pop, "steal_prioritize", 110, findings)
        # SL150: weight positivity — on a fresh population (order checks
        # never mutate, but keep the probe isolated anyway).
        probe = sample(cls) or []
        for s in probe:
            w = s.transitive_weight
            if not isinstance(w, int) or w < 1:
                file, line = _locate(cls)
                findings.append(Finding(
                    "error", "SL150",
                    f"{cls.__name__}: sampled transitive_weight is {w!r}; "
                    f"must be an int >= 1 (steal-half-work targets half "
                    f"the summed weight — zero/negative weights let a "
                    f"steal drain or starve)", file, line))
                break
        if probe:
            s = probe[0]
            try:
                s.set_transitive_weight(0)
                clamped = s.transitive_weight
            except Exception:
                clamped = None
            if clamped is None or clamped < 1:
                file, line = _locate(cls, "set_transitive_weight")
                findings.append(Finding(
                    "error", "SL150",
                    f"{cls.__name__}.set_transitive_weight(0) yields "
                    f"{clamped!r}; must clamp to >= 1", file, line))
    return findings


# --------------------------------------------------------------------------
# Cohort checks (SL12x composition, SL13x key shape, SL140 steal class)
# --------------------------------------------------------------------------

def _key_shape(p) -> Tuple:
    if isinstance(p, tuple):
        return ("tuple", len(p))
    return ("scalar", type(p).__name__)


def lint_cohort(cohort: Cohort) -> List[Finding]:
    findings: List[Finding] = []
    pops: List[Tuple[type, List[BaseStrategy]]] = []
    for cls in cohort.classes:
        pop = sample(cls)
        if pop:
            pops.append((cls, pop))
    mixed = [s for _, pop in pops for s in pop]

    # SL120/SL121: the composed relations must stay lawful on the mix.
    for attr, fn, rule in (("prioritize", local_before, "SL120"),
                           ("steal_prioritize", steal_before, "SL121")):
        try:
            for a in mixed:
                if fn(a, a):
                    findings.append(Finding(
                        "error", rule,
                        f"cohort {cohort.name}: composed {attr} "
                        f"({fn.__name__}) is not irreflexive on "
                        f"{type(a).__name__}"))
                    break
            else:
                for a, b in permutations(mixed, 2):
                    if fn(a, b) and fn(b, a):
                        findings.append(Finding(
                            "error", rule,
                            f"cohort {cohort.name}: composed {attr} is not "
                            f"asymmetric across {type(a).__name__} / "
                            f"{type(b).__name__} — cross-group head "
                            f"comparison is undefined"))
                        break
        except Exception as e:
            file, line = _locate(cohort.classes[0]) if cohort.classes \
                else ("<unknown>", 0)
            findings.append(Finding(
                "error", rule,
                f"cohort {cohort.name}: composed {attr} raised "
                f"{type(e).__name__}: {e} — these classes cannot share a "
                f"storage", file, line))

    # SL130/SL131: priority-key shapes, for pairs whose LCA comparison
    # actually reads .priority (LCA below PriorityStrategy).
    for (ca, pa), (cb, pb) in combinations(pops, 2):
        lca = lowest_common_ancestor(ca, cb)
        if not (issubclass(lca, PriorityStrategy)
                and hasattr(pa[0], "priority") and hasattr(pb[0], "priority")):
            continue
        sa, sb = _key_shape(pa[0].priority), _key_shape(pb[0].priority)
        try:
            pa[0].priority < pb[0].priority  # noqa: B015 - the probe IS the point
        except TypeError:
            file, line = _locate(cb, "_key") if hasattr(cb, "_key") \
                else _locate(cb)
            findings.append(Finding(
                "error", "SL130",
                f"cohort {cohort.name}: {ca.__name__} key {sa} and "
                f"{cb.__name__} key {sb} are not comparable — a mixed "
                f"storage raises TypeError mid-heap-op", file, line))
            continue
        if sa[0] == "tuple" and sb[0] == "tuple" and sa[1] != sb[1]:
            file, line = _locate(cb, "_key") if hasattr(cb, "_key") \
                else _locate(cb)
            findings.append(Finding(
                "warning", "SL131",
                f"cohort {cohort.name}: {ca.__name__} builds {sa[1]}-tuple "
                f"keys but {cb.__name__} builds {sb[1]}-tuples; prefix "
                f"comparison is defined but field meanings diverge",
                file, line))

    # SL140: declared steal classes must agree with the steal order.
    classed = [(c, pop) for c, pop in pops
               if all(hasattr(s, "steal_class") for s in pop)]
    for (ca, pa), (cb, pb) in combinations(classed, 2):
        for a in pa:
            for b in pb:
                lo, hi = (a, b) if a.steal_class < b.steal_class else (b, a)
                if lo.steal_class == hi.steal_class:
                    continue
                if not steal_before(lo, hi) or steal_before(hi, lo):
                    file, line = _locate(ca, "steal_prioritize")
                    findings.append(Finding(
                        "error", "SL140",
                        f"cohort {cohort.name}: {type(lo).__name__} "
                        f"steal_class={lo.steal_class} must be stolen "
                        f"strictly before {type(hi).__name__} "
                        f"steal_class={hi.steal_class}, but steal_before "
                        f"disagrees — the steal-resistance contract is "
                        f"inverted", file, line))
                    return findings
    return findings


# --------------------------------------------------------------------------
# Merge-policy legality (SL160/SL161) and merging delegation (SL170)
# --------------------------------------------------------------------------

def lint_merge_policy(policy: MergePolicy) -> List[Finding]:
    findings: List[Finding] = []
    cls = type(policy)
    file, line = _locate(cls, "chunk_size")
    if policy.max_chunk < policy.min_chunk:
        findings.append(Finding(
            "warning", "SL161",
            f"{cls.__name__}({policy!r}): max_chunk < min_chunk — the "
            f"clamps fight and max_chunk wins", file, line))
    for depth in (0, 1, 2, 5, 17, 64, 200):
        for remaining in (1, 2, 3, 7, 63, 64, 65, 500):
            c = policy.chunk_size(depth, remaining)
            if not (1 <= c <= remaining):
                findings.append(Finding(
                    "error", "SL160",
                    f"{cls.__name__}({policy!r}).chunk_size({depth}, "
                    f"{remaining}) = {c}, outside [1, {remaining}]: "
                    f"an overshoot spawns a chunk for work that does not "
                    f"exist; 0 livelocks the spawn loop", file, line))
                return findings
    return findings


def lint_merging(merging_cls: type = MergingStrategy) -> List[Finding]:
    findings: List[Finding] = []
    file, line = _locate(merging_cls, "is_dead")

    class _DeadRep(PriorityStrategy):
        def is_dead(self) -> bool:
            return True

    chunk = merging_cls(rep=_DeadRep(priority=1.0), merged_count=3)
    if not chunk.is_dead():
        findings.append(Finding(
            "error", "SL170",
            f"{merging_cls.__name__}: chunk of a dead representative is "
            f"not dead — pruning the rep resurrects its merged work",
            file, line))
    if chunk.transitive_weight < 1:
        findings.append(Finding(
            "error", "SL170",
            f"{merging_cls.__name__}: merged chunk weight "
            f"{chunk.transitive_weight} < 1", file, line))
    return findings


# --------------------------------------------------------------------------
# Entry points
# --------------------------------------------------------------------------

def run_lint(classes: Optional[Sequence[type]] = None,
             cohorts: Optional[Sequence[Cohort]] = None,
             policies: Optional[Iterable[MergePolicy]] = None
             ) -> List[Finding]:
    """Full lint pass.  With no arguments, lints the repo's zoo; the
    mutation harness passes fault classes/cohorts/policies explicitly."""
    if classes is None:
        classes = discover_strategies()
    if cohorts is None:
        cohorts = default_cohorts(classes)
    if policies is None:
        policies = [MergePolicy(),
                    MergePolicy(min_chunk=4, max_chunk=16, depth_factor=0.5),
                    MergePolicy(max_chunk=8, depth_factor=2.0)]
    findings = lint_classes(classes)
    for cohort in cohorts:
        findings.extend(lint_cohort(cohort))
    for policy in policies:
        findings.extend(lint_merge_policy(policy))
    merging = [c for c in classes
               if isinstance(c, type) and issubclass(c, MergingStrategy)]
    for cls in merging or [MergingStrategy]:
        findings.extend(lint_merging(cls))
    return findings


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro.analysis.schedlint",
        description="static lints over the work-stealing strategy zoo")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on warnings as well as errors")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the per-finding listing")
    args = ap.parse_args(argv)
    findings = run_lint()
    errors = [f for f in findings if f.level == "error"]
    warnings = [f for f in findings if f.level == "warning"]
    if not args.quiet:
        for f in findings:
            print(f.render())
    print(f"schedlint: {len(errors)} error(s), {len(warnings)} warning(s) "
          f"over {len(discover_strategies())} strategy classes")
    if errors or (args.strict and warnings):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
