"""Serving launcher: strategy-scheduled continuous batching over paged KV,
on the GPU unless ``--device cpu``.

Full-width qwen2-1.5b with random weights on the card:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --requests 16

Equality gate (paged and contiguous KV must generate identical tokens):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --smoke --requests 8 --check-paged-equality

``--arch mixtral-8x22b`` serves the MoE family (grouped-SwiGLU kernel);
full Mixtral-8x22B does not fit one card, so on the GPU run it with
``--smoke`` (``chip_smoke.py`` serves it at full width, 8 layers).
``--arch rwkv6-3b`` serves RWKV-6 (WKV-6 kernel in prefill) through the
contiguous state cache: the family has no paged path, so ``--kv auto``
resolves to contiguous and ``--check-paged-equality`` skips the paged modes.
``--arch jamba-v0.1-52b`` serves the hybrid (Mamba layers in plain PyTorch,
flash attention and grouped SwiGLU in its attention and MoE layers): its
attention KV pages, its Mamba states stay per slot, and it has no chunked
prefill, prefix cache or verify path, so ``--check-paged-equality`` runs
``contiguous`` and ``paged`` only.  Full Jamba does not fit one card
(``chip_smoke.py`` serves 16 of its 32 layers at full width).
``--arch qwen3-8b`` (``qk_norm``), ``deepseek-coder-33b`` and
``internvl2-26b`` (served text-only, as in the reference) fit one card
whole; full ``mistral-large-123b`` (246 GB) and ``kimi-k2-1t-a32b`` (384
experts, top-8; ~2 TB) do not, so on the GPU run them with ``--smoke``
(``chip_smoke.py`` serves 22 and 1 of their layers at full width).
qwen3-8b shares qwen2-1.5b's vocab, so ``--arch qwen3-8b --spec-draft
qwen2-1.5b`` drafts with the smaller model.  ``--arch seamless-m4t-medium``
exits 2: the engine cannot serve the encoder-decoder family (no
``init_cache``, as in the reference); ``chip_smoke.py`` serves it through
the step functions.

Speculative decoding: ``--spec-draft self`` (the target drafts for itself)
or a ported zoo name with the target's vocab; ``--spec-k`` and
``--spec-adaptive`` as in the reference.  With ``--check-paged-equality``
the ``paged+spec`` mode must generate the contiguous engine's tokens:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \
        --spec-draft self --check-paged-equality

Cluster (``--replicas > 1``): the paper's work-stealing between live
engines, each with its own paged pool over one shared set of weights; a
stolen partially-prefilled request carries its prefix KV.  ``--chaos
kill-one`` kills the busiest engine mid-run (the heartbeat declares it dead
and its requests replay elsewhere); ``--autoscale`` grows and shrinks the
fleet from the backlog.  Either exits 1 unless every request finishes, the
replayed count equals the displaced count and the per-class counts match:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \
        --replicas 2 --requests 12 --chaos kill-one

The flags are those of ``repro.launch.serve`` plus ``--device``.
"""
from __future__ import annotations

import argparse
import itertools
import sys
import time
from collections import Counter

import numpy as np

from ..cluster import (ClusterRouter, ClusterTelemetry, EngineReplica,
                       StealPolicy)
from ..configs import get_config, scale_down
from ..core.device.request_scheduler import Request
from ..device import resolve_device
from ..models import build_model
from ..runtime import (Autoscaler, AutoscalePolicy, HeartbeatMonitor,
                       StragglerDetector)
from ..serving import ServingEngine, Speculator


def _make_prompts(args, cfg):
    """Mixed traffic: half the prompts share a 16-token system prefix (the
    shared-prefix caching shape), half are cold."""
    rng = np.random.default_rng(args.seed)
    sys_prefix = rng.integers(0, cfg.vocab_size, 16)
    out = []
    for i in range(args.requests):
        tail = rng.integers(0, cfg.vocab_size, int(rng.integers(4, 32)))
        out.append(np.concatenate([sys_prefix, tail]) if i % 2 == 0
                   else tail)
    return out


def _engine_kw(args):
    admission = args.admission
    if args.prefix_cache and args.cache_policy == "aware" \
            and admission == "strategy":
        admission = "cache_aware"
    return dict(max_batch=args.max_batch, s_max=args.s_max,
                kv_mode=args.kv, block_size=args.block_size,
                num_blocks=args.num_blocks,
                prefill_chunk=args.prefill_chunk,
                admission=admission,
                prefix_cache=args.prefix_cache,
                overflow=args.overflow)


def _build_draft(args, model, params, cfg):
    """Resolve ``--spec-draft`` into a ``(model, params)`` pair, failing
    fast (exit 2) on an unknown name, a vocab mismatch or a family that
    cannot draft, before any engine or cache is built."""
    name = args.spec_draft
    if name is None:
        return None
    if name == "self":
        return model, params
    try:
        dcfg = get_config(name)
    except KeyError as e:
        print(f"--spec-draft {name!r}: {e.args[0]}", file=sys.stderr)
        raise SystemExit(2)
    tcfg = get_config(args.arch)
    if dcfg.vocab_size != tcfg.vocab_size:
        print(f"--spec-draft {name!r}: vocab {dcfg.vocab_size} != target "
              f"{args.arch!r} vocab {tcfg.vocab_size}: draft and target "
              f"must share a tokenizer", file=sys.stderr)
        raise SystemExit(2)
    if dcfg.family not in ("dense", "moe", "vlm"):
        print(f"--spec-draft {name!r}: family {dcfg.family!r} cannot draft "
              f"(speculation needs a positional KV cache for rollback)",
              file=sys.stderr)
        raise SystemExit(2)
    if args.smoke:
        dcfg = scale_down(dcfg, layers=2, d_model=256, d_ff=1024,
                          vocab=cfg.vocab_size)
    dcfg = dcfg.replace(use_flash=cfg.use_flash)
    dmodel = build_model(dcfg, model.device)
    return dmodel, dmodel.init(args.seed + 1)


def _make_spec(args, draft) -> "Speculator | None":
    """One Speculator per engine: it owns a per-slot draft cache sized to
    the engine it attaches to."""
    if draft is None:
        return None
    dmodel, dparams = draft
    return Speculator(dmodel, dparams, k=args.spec_k,
                      adaptive=args.spec_adaptive)


def _run_engine(eng, prompts, args):
    reqs = [eng.submit(p, max_new_tokens=args.max_new_tokens,
                       priority=float(i % 3))
            for i, p in enumerate(prompts)]
    outs = eng.run_until_drained()
    return reqs, outs


def _serve_single(args, model, params, cfg, draft=None) -> None:
    eng = ServingEngine(model, params, speculator=_make_spec(args, draft),
                        **_engine_kw(args))
    t0 = time.perf_counter()
    reqs, outs = _run_engine(eng, _make_prompts(args, cfg), args)
    dt = time.perf_counter() - t0
    done = sum(1 for r in reqs if r.state.name == "DONE")
    toks = sum(len(outs[r.rid]) for r in reqs)
    m = eng.batcher.metrics
    print(f"completed {done}/{len(reqs)} requests, {toks} tokens in "
          f"{dt:.2f}s ({toks / dt:.1f} tok/s) [kv={eng.kv_mode}, "
          f"device={model.device}]")
    print(f"scheduler: steps={m['steps']} merged_prefills="
          f"{m['merged_prefills']} prefill_chunks={m['prefill_chunks']} "
          f"evicted_dead={m['evicted_dead']} preempted={m['preempted']}")
    if eng.paged:
        eng.alloc.check()
        print(f"paged kv: {eng.alloc.total_blocks} blocks x "
              f"{eng.alloc.block_size} tokens, "
              f"{eng.alloc.free_tokens} tokens free at drain")
    if eng.prefix_cache:
        s = eng.cache_stats
        print(f"prefix cache: hit_rate={eng.cache_hit_rate():.2f} "
              f"({s['hit_tokens']} hit / {s['miss_tokens']} miss tokens), "
              f"{eng.alloc.cached_tokens} tokens cached at drain, "
              f"evictions={eng.alloc.cache_evictions} "
              f"cow_forks={eng.alloc.cow_forks}")
    if eng.speculator is not None:
        s = eng.spec_stats
        print(f"speculative: rounds={s['rounds']} drafted={s['drafted']} "
              f"accepted={s['accepted']} "
              f"acceptance={s['acceptance_rate']:.2f} "
              f"merged_drafts={s['merged_drafts']} shed={s['shed']} "
              f"verify_calls={s['verify_calls']}")


def _check_paged_equality(args, model, params, cfg, draft=None) -> int:
    """Gate: the paged engine must generate exactly what the contiguous
    engine generates.  Also runs chunked-prefill and prefix-cached paged
    engines: every request must finish with the same token count, and
    whether their tokens are exact is reported.  With a draft, the
    speculative paged engine must generate the contiguous engine's tokens
    (greedy-exact)."""
    prompts = _make_prompts(args, cfg)
    results = {}
    cache_eng = None
    modes = [
        ("contiguous", dict(kv_mode="contiguous", prefill_chunk=None,
                            prefix_cache=False)),
        ("paged", dict(kv_mode="paged", prefill_chunk=None,
                       prefix_cache=False)),
        ("paged+chunked", dict(kv_mode="paged",
                               prefill_chunk=args.prefill_chunk or 8,
                               prefix_cache=False)),
        ("paged+cache", dict(kv_mode="paged",
                             prefill_chunk=args.prefill_chunk or 8,
                             prefix_cache=True))]
    if draft is not None:
        modes.append(("paged+spec", dict(kv_mode="paged",
                                         prefill_chunk=None,
                                         prefix_cache=False)))
    for mode, over in modes:
        if mode != "contiguous" and not model.supports_paged:
            print(f"{mode}: family {cfg.family!r} has no paged path — skip")
            continue
        if mode == "paged+spec" and not model.supports_speculation:
            print(f"{mode}: family {cfg.family!r} has no verify path — skip")
            continue
        if over["prefill_chunk"] and model.prefill_chunk_paged is None:
            print(f"{mode}: family {cfg.family!r} has no chunk path — skip")
            continue
        if over["prefix_cache"] and not model.supports_prefix_cache:
            print(f"{mode}: family {cfg.family!r} has no prefix cache — "
                  "skip")
            continue
        kw = dict(_engine_kw(args), **over)   # --num-blocks etc. flow in
        spec = _make_spec(args, draft) if mode == "paged+spec" else None
        eng = ServingEngine(model, params, speculator=spec, **kw)
        if mode == "paged+cache":
            # warm pass publishes the shared prefixes; the measured pass
            # below adopts them
            _run_engine(eng, prompts, args)
        reqs, outs = _run_engine(eng, prompts, args)
        if not all(r.state.name == "DONE" for r in reqs):
            print(f"FAIL: {mode}: not every request finished",
                  file=sys.stderr)
            return 1
        if eng.paged:
            eng.alloc.check()
        if mode == "paged+cache":
            cache_eng = eng
        results[mode] = [outs[r.rid] for r in reqs]
        print(f"{mode}: {sum(len(o) for o in results[mode])} tokens")
    if "paged" not in results:
        return 0
    if results["paged"] != results["contiguous"]:
        bad = sum(1 for a, b in zip(results["paged"],
                                    results["contiguous"]) if a != b)
        print(f"FAIL: paged vs contiguous decode mismatch on {bad}/"
              f"{len(prompts)} requests", file=sys.stderr)
        return 1
    print("OK: paged decode == contiguous decode "
          f"({len(prompts)} requests)")
    want_lens = [len(a) for a in results["contiguous"]]
    chunked = results.get("paged+chunked")
    if chunked is not None:
        if [len(a) for a in chunked] != want_lens:
            print("FAIL: chunked prefill changed token counts",
                  file=sys.stderr)
            return 1
        print(f"OK: chunked prefill token counts match "
              f"(token-exact: {chunked == results['contiguous']})")
    cached = results.get("paged+cache")
    if cached is not None:
        if [len(a) for a in cached] != want_lens:
            print("FAIL: prefix cache changed token counts", file=sys.stderr)
            return 1
        if cache_eng.cache_stats["hit_tokens"] == 0:
            print("FAIL: shared-prefix prompts produced zero cache hits",
                  file=sys.stderr)
            return 1
        print(f"OK: prefix-cached prefill token counts match "
              f"(token-exact: {cached == results['contiguous']}, hit_rate="
              f"{cache_eng.cache_hit_rate():.2f})")
    spec_outs = results.get("paged+spec")
    if spec_outs is not None:
        if spec_outs != results["contiguous"]:
            bad = sum(1 for a, b in zip(spec_outs, results["contiguous"])
                      if a != b)
            print(f"FAIL: speculative vs contiguous decode mismatch on "
                  f"{bad}/{len(prompts)} requests", file=sys.stderr)
            return 1
        print(f"OK: speculative decode == contiguous decode "
              f"(draft={args.spec_draft}, k={args.spec_k})")
    return 0


def _serve_cluster(args, model, params, cfg, draft=None) -> int:
    """The reference's cluster run: ``--replicas`` engines over the one
    model and its weights, each engine its own paged pool, behind a
    ``ClusterRouter`` with the ``--steal``/``--placement`` policy.  With
    ``--chaos`` or ``--autoscale``, the router's heartbeat and straggler
    tracking and the gates: every submitted request finishes, replayed
    equals displaced-at-crash, per-class telemetry counts every finish."""
    def make_engine():
        return ServingEngine(model, params,
                             speculator=_make_spec(args, draft),
                             **_engine_kw(args))

    chaotic = args.chaos is not None or args.autoscale
    replicas = [EngineReplica(i, make_engine())
                for i in range(args.replicas)]
    policy = StealPolicy(amount=args.steal, placement=args.placement)
    # a killed engine stops responding, the heartbeat declares it dead, and
    # the router replays its in-flight requests elsewhere
    heartbeat = (HeartbeatMonitor(timeout_s=args.heartbeat_timeout)
                 if chaotic else None)
    straggler = (StragglerDetector(num_hosts=args.replicas)
                 if chaotic else None)
    router = ClusterRouter(replicas, policy=policy,
                           telemetry=ClusterTelemetry(args.replicas),
                           heartbeat=heartbeat, straggler=straggler)
    autoscaler = None
    if args.autoscale:
        ceiling = args.max_replicas or 2 * args.replicas
        autoscaler = Autoscaler(AutoscalePolicy(
            min_replicas=args.replicas, max_replicas=ceiling,
            target_backlog=args.autoscale_target,
            up_ticks=2, down_ticks=8, cooldown_s=0.5))
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    reqs = []
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, int(rng.integers(4, 48)))
        req = Request(prompt_len=len(prompt),
                      max_new_tokens=args.max_new_tokens,
                      priority=float(i % 3))
        router.submit(req, tokens=prompt)
        reqs.append(req)
    submitted = [r for r in reqs if r.state.name != "CANCELLED"]

    killed = None
    if not chaotic:
        router.run_until_drained()
    else:
        tel = router.telemetry
        kill_after = max(1, len(submitted) // 4)
        # the heartbeat counts seconds, not steps: a step in which no live
        # engine had work does not count against the step budget, so work
        # stranded on a killed engine waits for the heartbeat however fast
        # an idle step is; idling ten timeouts in a row fails
        busy_steps, idle_since = 0, None
        for step in itertools.count():
            if router.step() > 0:
                busy_steps, idle_since = busy_steps + 1, None
            elif idle_since is None:
                idle_since = time.monotonic()
            if (args.chaos == "kill-one" and killed is None
                    and tel.finished >= kill_after and router.outstanding):
                # kill the engine that owns the most in-flight work, so the
                # crash displaces something worth replaying
                owners = Counter(o for o in router._owner.values()
                                 if o in router.placeable)
                if owners:
                    killed = owners.most_common(1)[0][0]
                    router.replicas[killed].dead = True
                    print(f"[chaos] killed replica {killed} after "
                          f"{tel.finished} finishes "
                          f"({owners[killed]} requests in flight on it)")
            if autoscaler is not None and step % 4 == 0:
                alive = router.placeable
                backlog = sum(router.replicas[i].backlog_weight()
                              for i in alive)
                delta = autoscaler.observe(time.monotonic(), len(alive),
                                           backlog)
                if delta > 0:
                    for _ in range(delta):
                        idx = router.add_replica(
                            EngineReplica(len(router.replicas),
                                          make_engine()))
                        print(f"[autoscale] added replica {idx}")
                    tel.record_scale(time.perf_counter() - t0, delta,
                                     len(router.placeable))
                    router.steal_tick()
                elif delta < 0:
                    victim = min(alive,
                                 key=lambda i:
                                 (router.replicas[i].backlog_weight(), i))
                    if router.retire_replica(victim):
                        tel.record_scale(time.perf_counter() - t0, -1,
                                         len(router.placeable))
                        print(f"[autoscale] retiring replica {victim}")
            if router.drained():
                break
            if busy_steps >= 200_000 or (
                    idle_since is not None and time.monotonic() - idle_since
                    > 10 * args.heartbeat_timeout):
                print("FAIL: cluster did not drain within step budget",
                      file=sys.stderr)
                return 1

    dt = time.perf_counter() - t0
    done = sum(1 for r in reqs if r.state.name == "DONE")
    toks = sum(r.generated for r in reqs)
    print(f"completed {done}/{len(reqs)} requests, {toks} tokens in "
          f"{dt:.2f}s ({toks / dt:.1f} tok/s) on {args.replicas} replicas "
          f"[device={model.device}]")
    tel = router.telemetry
    print(tel.report())
    summary = tel.summary()
    spec = summary["spec"]
    if spec["drafted_tokens"]:
        print(f"speculative: drafted={spec['drafted_tokens']} "
              f"accepted={spec['accepted_tokens']} "
              f"acceptance={spec['acceptance_rate']:.2f} "
              f"requests={spec['requests']}")
    if chaotic:
        ch, auto = summary["chaos"], summary["autoscale"]
        print(f"chaos: crashes={ch['crashes']} "
              f"replayed={ch['requests_replayed']} "
              f"recoveries={ch['recoveries']} "
              f"recovery_mean={ch['recovery_mean_s']:.3f}s "
              f"p99_under_failure={ch['p99_under_failure_s']:.3f}s")
        print(f"autoscale: ups={auto['scale_ups']} "
              f"downs={auto['scale_downs']} peak={auto['replicas_peak']} "
              f"final={auto['replicas_final']}")
    for h in router.health():
        if h.get("dead"):
            print(f"  replica {h['replica_id']}: dead")
            continue
        print(f"  replica {h['replica_id']}: backlog={h['backlog_weight']} "
              f"waiting={h['waiting']} active={h['active']}"
              + (f" free_kv={h['free_kv_tokens']}"
                 if "free_kv_tokens" in h else ""))
    if not chaotic:
        return 0
    ok = True
    if done != len(submitted):
        print(f"FAIL: {len(submitted) - done} submitted requests did "
              f"not finish", file=sys.stderr)
        ok = False
    if args.chaos == "kill-one":
        if killed is None:
            print("FAIL: chaos kill never triggered", file=sys.stderr)
            ok = False
        displaced = sum(e.get("displaced", 0) for e in summary["events"]
                        if e["kind"] == "crash")
        replayed = summary["chaos"]["requests_replayed"]
        if replayed != displaced:
            print(f"FAIL: telemetry replay mismatch: replayed="
                  f"{replayed} displaced-at-crash={displaced}",
                  file=sys.stderr)
            ok = False
        if killed is not None and displaced == 0:
            print("FAIL: crash displaced no requests", file=sys.stderr)
            ok = False
    want = Counter(r.priority for r in reqs if r.state.name == "DONE")
    for prio, n in sorted(want.items()):
        got = summary["per_class"].get(str(prio), {}).get("count", 0)
        if got != n:
            print(f"FAIL: SLO class {prio}: telemetry counted {got} "
                  f"finishes, engines report {n}", file=sys.stderr)
            ok = False
    if ok:
        print(f"OK: chaos/autoscale smoke — {done}/{len(submitted)} "
              f"finished, replay bookkeeping consistent")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default) fails without a CUDA device; cpu "
                         "runs the plain PyTorch path")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--s-max", type=int, default=128)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--steal", default="half_work",
                    choices=["half_work", "half_count", "none"])
    ap.add_argument("--placement", default="round_robin",
                    choices=["round_robin", "random", "least_of_d",
                             "least_work", "slo_aware", "cache_affinity",
                             "cost_model"])
    ap.add_argument("--chaos", default=None, choices=["kill-one"],
                    help="fault injection: kill-one marks the busiest "
                         "engine dead mid-run; the heartbeat declares it, "
                         "its requests replay elsewhere, and the run exits "
                         "1 unless every request finishes with consistent "
                         "replay telemetry")
    ap.add_argument("--heartbeat-timeout", type=float, default=2.0,
                    help="seconds without a step response before a replica "
                         "is declared dead (chaos/autoscale cluster runs)")
    ap.add_argument("--autoscale", action="store_true",
                    help="scale the live fleet from the backlog; "
                         "--replicas is the floor")
    ap.add_argument("--max-replicas", type=int, default=None,
                    help="autoscale ceiling (default: 2x --replicas)")
    ap.add_argument("--autoscale-target", type=float, default=256.0,
                    help="backlog weight per replica the autoscaler aims "
                         "to hold (token-units of remaining work)")
    ap.add_argument("--spec-draft", default=None,
                    help="speculative decoding: zoo config to draft with "
                         "('self' = the target drafts for itself); the "
                         "draft must share the target's vocab and have a "
                         "positional KV cache")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens proposed per speculation round")
    ap.add_argument("--spec-adaptive", dest="spec_adaptive",
                    action="store_true", default=True)
    ap.add_argument("--no-spec-adaptive", dest="spec_adaptive",
                    action="store_false")
    ap.add_argument("--kv", default="auto",
                    choices=["auto", "paged", "contiguous"])
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=None)
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill: tokens per chunk task (paged)")
    ap.add_argument("--admission", default="strategy",
                    choices=["strategy", "fifo", "cache_aware"])
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--cache-policy", default="aware",
                    choices=["aware", "oblivious"])
    ap.add_argument("--overflow", default="reject",
                    choices=["reject", "truncate", "allow"])
    ap.add_argument("--check-paged-equality", action="store_true",
                    help="paged and contiguous engines must generate "
                         "identical tokens (exit 1 on mismatch)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    # flash attention through the hand-written CUDA kernel: on by default
    # on the GPU; on the CPU the kernel wrapper runs its plain version
    ap.add_argument("--use-flash", dest="use_flash", action="store_true",
                    default=None)
    ap.add_argument("--no-use-flash", dest="use_flash", action="store_false")
    args = ap.parse_args(argv)

    try:
        cfg = get_config(args.arch)
    except KeyError as e:
        print(e.args[0], file=sys.stderr)
        return 2
    if cfg.family == "encdec":
        print(f"--arch {args.arch}: the engine cannot serve the "
              "encoder-decoder family: it needs model.init_cache, and this "
              "family's cache comes from prefill, which needs the encoder's "
              "output (as in the reference); drive it with "
              "train.make_prefill_step and make_decode_step", file=sys.stderr)
        return 2
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if args.smoke:
        cfg = scale_down(cfg, layers=4, d_model=256, d_ff=1024,
                         vocab=min(cfg.vocab_size, 32768))
    use_flash = device.type == "cuda" if args.use_flash is None \
        else args.use_flash
    cfg = cfg.replace(use_flash=use_flash)
    model = build_model(cfg, device)
    params = model.init(args.seed)
    draft = _build_draft(args, model, params, cfg)
    if args.check_paged_equality:
        return _check_paged_equality(args, model, params, cfg, draft)
    if args.replicas > 1:
        return _serve_cluster(args, model, params, cfg, draft)
    _serve_single(args, model, params, cfg, draft)
    return 0


if __name__ == "__main__":
    sys.exit(main())
