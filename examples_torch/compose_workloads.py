"""Composability (paper Fig. 9): two kernels with DIFFERENT specialized
strategies — adaptive prefix sums and unbalanced tree search — run in ONE
scheduler, finishing faster than back-to-back execution.  A third act
composes *serving* strategies: speculative-decoding draft/verify tasks
share one storage with ordinary request tasks, and the strategy machinery
alone produces the right order (verify > request > draft).

The PyTorch port's counterpart of ``examples/compose_workloads.py``.  Acts
1-3 run on the host; ``--spec`` adds a live self-draft speculative engine
on the GPU unless ``--device cpu`` (without a CUDA device it exits 1).

Run:  python examples_torch/compose_workloads.py [--spec [--device cpu]]
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch.apps.prefix_sum import (_State, _finalize,  # noqa: E402
                                         run_prefix_sum)
from repro_torch.apps.prefix_sum import _root as prefix_root  # noqa: E402
from repro_torch.apps.uts import _splitmix64, _uts_task, run_uts  # noqa: E402
from repro_torch.configs import get_config, scale_down  # noqa: E402
from repro_torch.core import SchedulerConfig, StrategyScheduler  # noqa: E402
from repro_torch.core.device.request_scheduler import (  # noqa: E402
    Request, RequestStrategy)
from repro_torch.core.task import FinishRegion, Task  # noqa: E402
from repro_torch.core.task_storage import StrategyTaskStorage  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import (DraftStrategy, ServingEngine,  # noqa: E402
                                 Speculator, VerifyStrategy)

PLACES = 4
N = 1_000_000
DEPTH = 12


def compose() -> dict:
    """Acts 1 and 2: prefix sum and UTS alone, then both in one
    scheduler.  Prints the times and the strategy mix, asserts the
    composed run's results, and returns the runs alone, the input, the
    prefix state, the UTS counts per place and the composed run's
    metrics."""
    r_prefix = run_prefix_sum(n=N, num_places=PLACES)
    r_uts = run_uts(b0=4.0, max_depth=DEPTH, num_places=PLACES)
    print(f"prefix sum alone: {r_prefix['time_s']:.3f}s "
          f"(one-pass {r_prefix['one_pass_fraction']:.0%})")
    print(f"UTS alone:        {r_uts['time_s']:.3f}s "
          f"({r_uts['nodes']} nodes)")

    x = np.random.default_rng(0).integers(-1000, 1000, N).astype(np.int64)
    s = _State(x, 4096)
    counts = np.zeros(PLACES, np.int64)
    sched = StrategyScheduler(num_places=PLACES,
                              config=SchedulerConfig(seed=0))

    def root():
        prefix_root(s, True, 0)                      # PrefixStrategy tasks
        _uts_task(counts, _splitmix64(42), 0, 4.0, DEPTH, True)  # UTS tasks

    t0 = time.perf_counter()
    sched.run(root)
    _finalize(s)
    dt = time.perf_counter() - t0
    assert np.array_equal(s.out, np.cumsum(x))
    assert counts.sum() == r_uts["nodes"]
    total = r_prefix["time_s"] + r_uts["time_s"]
    print(f"composed (1 sched): {dt:.3f}s vs {total:.3f}s sum of parts "
          f"→ {total / dt:.2f}x")
    m = sched.metrics.snapshot()
    print(f"strategy mix in one run: spawns={m['spawns']} "
          f"inlined={m['calls_converted']} steals={m['steals']}")
    return {"prefix": r_prefix, "uts": r_uts, "x": x, "state": s,
            "counts": counts, "metrics": m}


def pop_order() -> list:
    """Act 3: serving strategies compose the same way.  Draft/verify
    speculation tasks and an ordinary request task in ONE storage: no
    scheduler special-cases, the strategy tuples alone order them (verify
    first — emitted tokens are the product; drafts last — pure
    opportunism).  Returns the strategies' class names in pop order."""
    storage = StrategyTaskStorage(0)
    req = Request(prompt_len=32, max_new_tokens=16, priority=0.0)
    for strat in (DraftStrategy("propose", 0, k=4),
                  RequestStrategy(req, lambda: 0.0),
                  VerifyStrategy(1, [7, 8, 9])):
        storage.push(Task(lambda: None, (), {}, strat, FinishRegion()))
    order = [type(storage.pop_local().strategy).__name__ for _ in range(3)]
    print(f"spec + request tasks in one storage pop as: {' > '.join(order)}")
    return order


def spec_demo(model, params) -> dict:
    """``--spec``: a self-draft speculative engine over ``(model,
    params)`` against the plain engine on the same prompts.  Asserts the
    streams are identical and returns both engines, their requests and
    outputs."""
    cfg = model.cfg
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(4, 14)))
               for _ in range(4)]
    base_eng = ServingEngine(model, params, max_batch=4, s_max=48)
    base_reqs = [base_eng.submit(p, max_new_tokens=8) for p in prompts]
    base = base_eng.run_until_drained()
    eng = ServingEngine(model, params, max_batch=4, s_max=48,
                        speculator=Speculator(model, params, k=3))
    reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
    outs = eng.run_until_drained()
    assert [outs[r.rid] for r in reqs] == \
        [base[r.rid] for r in base_reqs], "spec stream must be exact"
    s = eng.spec_stats
    print(f"self-draft speculation: bit-identical stream, "
          f"rounds={s['rounds']} drafted={s['drafted']} "
          f"accepted={s['accepted']} merged_drafts={s['merged_drafts']}")
    return {"base_eng": base_eng, "base_reqs": base_reqs, "base": base,
            "eng": eng, "reqs": reqs, "outs": outs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spec", action="store_true",
                    help="add the live self-draft speculative engine demo")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the --spec engine's device; cuda (default) fails "
                         "without a CUDA device")
    args = ap.parse_args(argv)
    if args.spec:
        try:
            device = resolve_device(args.device)
        except RuntimeError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    compose()
    pop_order()
    if args.spec:
        model = build_model(scale_down(get_config("qwen2-1.5b")), device)
        spec_demo(model, model.init(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
