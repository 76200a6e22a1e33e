"""Serving launcher: strategy-scheduled continuous batching over paged KV,
one replica, on the GPU unless ``--device cpu``.

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

Speculative decoding: ``--spec-draft self`` (the target drafts for itself)
or a ported zoo name with the target's vocab; ``--spec-k`` and
``--spec-adaptive`` as in the reference.  With ``--check-paged-equality``
the ``paged+spec`` mode must generate the contiguous engine's tokens:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \
        --spec-draft self --check-paged-equality

The flags are those of ``repro.launch.serve`` plus ``--device``;
``--replicas > 1``, ``--chaos`` and ``--autoscale`` are not yet ported and
exit 2.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..configs import get_config, scale_down
from ..device import resolve_device
from ..models import build_model
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
    chunked = results["paged+chunked"]
    if [len(a) for a in chunked] != want_lens:
        print("FAIL: chunked prefill changed token counts", file=sys.stderr)
        return 1
    print(f"OK: chunked prefill token counts match "
          f"(token-exact: {chunked == results['contiguous']})")
    cached = results["paged+cache"]
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


def _not_yet_ported(args) -> list:
    out = []
    if args.replicas > 1:
        out.append("--replicas > 1 (cluster serving)")
    if args.chaos is not None:
        out.append("--chaos")
    if args.autoscale:
        out.append("--autoscale")
    return out


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
    # cluster and fault-injection flags of the reference launcher: parsed
    # so the command lines match, refused below
    ap.add_argument("--steal", default="half_work",
                    choices=["half_work", "half_count", "none"])
    ap.add_argument("--placement", default="round_robin",
                    choices=["round_robin", "random", "least_of_d",
                             "least_work", "slo_aware", "cache_affinity",
                             "cost_model"])
    ap.add_argument("--chaos", default=None, choices=["kill-one"])
    ap.add_argument("--heartbeat-timeout", type=float, default=2.0)
    ap.add_argument("--autoscale", action="store_true")
    ap.add_argument("--max-replicas", type=int, default=None)
    ap.add_argument("--autoscale-target", type=float, default=256.0)
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

    missing = _not_yet_ported(args)
    if missing:
        print(f"not yet ported to repro_torch: {', '.join(missing)}",
              file=sys.stderr)
        return 2
    try:
        cfg = get_config(args.arch)
    except KeyError as e:
        print(e.args[0], file=sys.stderr)
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
    _serve_single(args, model, params, cfg, draft)
    return 0


if __name__ == "__main__":
    sys.exit(main())
