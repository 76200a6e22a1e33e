"""Serve a small model with batched requests through the strategy-scheduled
continuous-batching engine: SLO priorities, merged (spawn-to-call) prefills,
dead-request cancellation, per-slot decode positions.

The PyTorch port's counterpart of ``examples/serve_requests.py``, on the
GPU unless ``--device cpu`` (without a CUDA device it exits 1).
``serve(model, params)`` is the example itself; ``main`` builds the model.

Run:  python examples_torch/serve_requests.py [--device cpu]
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.cluster import ClusterTelemetry  # noqa: E402
from repro_torch.configs import get_config, scale_down  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402


def serve(model, params) -> dict:
    """Serve the example's traffic on one engine over ``(model, params)``:
    6 interactive and 10 batch requests and a cancelled one.  Prints the
    report, asserts the invariants, and returns the engine, the requests,
    the outputs (rid -> tokens), the telemetry and the wall seconds."""
    cfg = model.cfg
    eng = ServingEngine(model, params, max_batch=4, s_max=96,
                        prefill_token_budget=256)

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    interactive, batchy = [], []
    for i in range(6):   # tier-0 interactive requests
        interactive.append(eng.submit(
            rng.integers(0, cfg.vocab_size, 8), max_new_tokens=8,
            priority=0.0))
    for i in range(10):  # tier-1 batch requests with longer prompts
        batchy.append(eng.submit(
            rng.integers(0, cfg.vocab_size, 40), max_new_tokens=16,
            priority=1.0))
    cancelled = eng.submit(rng.integers(0, cfg.vocab_size, 30),
                           max_new_tokens=64, priority=1.0)
    cancelled.cancel()   # dead task: never admitted, never computed

    outs = eng.run_until_drained()
    dt = time.perf_counter() - t0
    toks = sum(len(v) for v in outs.values())
    fin_i = max(r.finished_at for r in interactive)
    fin_b = max(r.finished_at for r in batchy)
    m = eng.batcher.metrics

    # per-SLO-class latency percentiles via the cluster telemetry module
    tel = ClusterTelemetry(num_replicas=1)
    for r in interactive + batchy:
        tel.record_finish(r, r.finished_at, replica_id=0)
    dev = model.device
    dev = "CPU" if dev.type == "cpu" else torch.cuda.get_device_name(dev)
    print(f"{toks} tokens across {len(outs) - 1} live requests in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s on {dev})")
    print(f"interactive tier drained {fin_b - fin_i:+.2f}s before batch tier"
          f" (strategy priority)")
    for slo in (0.0, 1.0):
        c = tel.class_percentiles(slo)
        print(f"slo={slo:g}: n={c['count']} p50={c['p50_s']*1e3:.0f}ms "
              f"p90={c['p90_s']*1e3:.0f}ms p99={c['p99_s']*1e3:.0f}ms "
              f"mean={c['mean_s']*1e3:.0f}ms")
    print(f"merged prefills: {m['merged_prefills']}  "
          f"dead evicted: {m['evicted_dead']}  steps: {m['steps']}")
    if eng.paged:
        eng.alloc.check()      # no leaked KV blocks after the drain
        print(f"paged kv: {eng.alloc.total_blocks} x "
              f"{eng.alloc.block_size}-token blocks, "
              f"{eng.alloc.free_tokens} tokens free")
    assert cancelled.rid not in outs or not outs[cancelled.rid]
    assert all(r.state.name == "DONE" for r in interactive + batchy)
    return {"eng": eng, "outs": outs, "interactive": interactive,
            "batchy": batchy, "cancelled": cancelled, "tel": tel,
            "seconds": dt}


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
