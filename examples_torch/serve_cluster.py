"""Two live serving replicas behind the cluster router: SLO-aware
placement, steal-half-the-work backlog migration between real engines, and
per-class latency telemetry — the identical `StealPolicy`/`ClusterRouter`
code that `benchmarks/cluster_scale.py` evaluates on 1000 simulated
replicas.

The PyTorch port's counterpart of ``examples/serve_cluster.py``, on the
GPU unless ``--device cpu`` (without a CUDA device it exits 1).
``serve(model, params)`` is the example itself; ``main`` builds the model.

Run:  python examples_torch/serve_cluster.py [--device cpu]
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch.cluster import (ClusterRouter,  # noqa: E402
                                 ClusterTelemetry, EngineReplica,
                                 StealPolicy)
from repro_torch.configs import get_config, scale_down  # noqa: E402
from repro_torch.core.device.request_scheduler import Request  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402


def serve(model, params) -> dict:
    """Serve the example's traffic on two replicas of ``(model, params)``:
    6 interactive requests, 8 bulk ones of alternating sizes and a
    cancelled one.  Prints the report, asserts the invariants, and returns
    the router, the replicas, the requests, the cancelled request and the
    wall seconds."""
    cfg = model.cfg
    # one model, two replicas (independent KV caches + batchers)
    replicas = [
        EngineReplica(i, ServingEngine(model, params, max_batch=2, s_max=96,
                                       prefill_token_budget=256))
        for i in range(2)]
    policy = StealPolicy(amount="half_work", victim="nearest",
                         placement="round_robin")
    router = ClusterRouter(replicas, policy=policy,
                           telemetry=ClusterTelemetry(len(replicas)))

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    reqs = []
    for i in range(6):    # interactive tier
        req = Request(prompt_len=8, max_new_tokens=6, priority=0.0)
        router.submit(req, tokens=rng.integers(0, cfg.vocab_size, 8))
        reqs.append(req)
    # bulk tier: round-robin placement balances the request COUNT, but the
    # alternating heavy/light sizes skew the WEIGHT onto one replica — the
    # other drains early and steal-half-work migrates backlog to it
    for i in range(8):
        plen, new = (48, 12) if i % 2 == 0 else (8, 4)
        req = Request(prompt_len=plen, max_new_tokens=new, priority=1.0)
        router.submit(req, tokens=rng.integers(0, cfg.vocab_size, plen))
        reqs.append(req)
    dead = Request(prompt_len=30, max_new_tokens=64, priority=1.0)
    router.submit(dead, tokens=rng.integers(0, cfg.vocab_size, 30))
    dead.cancel()         # dead request: pruned, never migrated, never run

    router.run_until_drained()
    dt = time.perf_counter() - t0

    tel = router.telemetry
    toks = sum(r.generated for r in reqs)
    print(f"{toks} tokens across {len(reqs)} live requests on "
          f"{len(replicas)} replicas in {dt:.2f}s ({toks / dt:.1f} tok/s)")
    print(tel.report())
    for h in router.health():
        print(f"  replica {h['replica_id']}: backlog={h['backlog_weight']} "
              f"waiting={h['waiting']} active={h['active']}")

    assert all(r.state.name == "DONE" for r in reqs)
    assert dead.generated == 0 and dead.state.name == "CANCELLED"
    assert tel.finished == len(reqs)
    # both replicas did real work (placement and/or stealing spread it)
    per_rep = tel.summary()["per_replica"]
    assert all(rep["finished"] > 0 for rep in per_rep), per_rep
    assert tel.steal_events > 0, "expected backlog migration between engines"
    return {"router": router, "replicas": replicas, "reqs": reqs,
            "dead": dead, "seconds": dt}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default) fails without a CUDA device")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    cfg = scale_down(get_config("qwen2-1.5b"), layers=4, d_model=128,
                     d_ff=512, vocab=4096)
    model = build_model(cfg, device)
    serve(model, model.init(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
