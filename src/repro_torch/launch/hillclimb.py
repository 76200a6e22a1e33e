"""Perf hillclimb: run the roofline analysis for named variants of a
cell and print the three terms side by side.

    python -m repro_torch.launch.hillclimb --arch qwen2-1.5b \
        --shape train_4k --variants baseline,dp,dp+vchunk

The PyTorch counterpart of ``repro/launch/hillclimb.py``: the same
variants, each traced by ``dryrun.run_cell`` with ``analyze`` on the fake
16×16 world.  Variants are defined in ``VARIANTS`` below: each is (layout,
cfg-overrides, microbatches).  Results also land in
runs/hillclimb/<cell>__<variant>.json.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Tuple

__all__ = ["VARIANTS", "run_variant", "summarize", "main"]

#: variant name → (layout, cfg_overrides, microbatches)
VARIANTS: Dict[str, Tuple[str, dict, Optional[int]]] = {
    "baseline": ("tp", {}, None),
    # layout
    "dp": ("dp", {}, None),
    # dp is only whole-mesh-wide with batch ≥ chips per microbatch → µ=1
    "dp1": ("dp", {}, 1),
    "dp1+vchunk": ("dp", {"loss_vocab_chunk": 8192}, 1),
    "dp1+noremat": ("dp", {"remat": False}, 1),
    # loss logsumexp blockwise over vocab
    "vchunk": ("tp", {"loss_vocab_chunk": 8192}, None),
    "dp+vchunk": ("dp", {"loss_vocab_chunk": 8192}, None),
    # matmul-based embedding (fixes SPMD gather replication fallback)
    "onehot": ("tp", {"onehot_embed": True}, None),
    "onehot+vchunk": ("tp", {"onehot_embed": True,
                             "loss_vocab_chunk": 8192}, None),
    # MoE dispatch variants (droppy: capacity pressure is the study)
    "arrival": ("tp", {"dispatch_policy": "arrival",
                       "dispatch_resteal": False,
                       "moe_dropless": False}, None),
    "noresteal": ("tp", {"dispatch_resteal": False,
                         "moe_dropless": False}, None),
    "cf1.0": ("tp", {"capacity_factor": 1.0,
                     "moe_dropless": False}, None),
    "cf1.0+noresteal": ("tp", {"capacity_factor": 1.0,
                               "dispatch_resteal": False,
                               "moe_dropless": False}, None),
    # microbatch count
    "micro2x": ("tp", {}, -2),      # negative → multiply default
    "microhalf": ("tp", {}, -999),  # special: default // 2
    # remat off (memory for flops trade)
    "noremat": ("tp", {"remat": False}, None),
    "dp+vchunk+noresteal": ("dp", {"loss_vocab_chunk": 8192,
                                   "dispatch_resteal": False,
                                   "moe_dropless": False}, None),
    "swa_off": ("tp", {"sliding_window": None}, None),
    # pin activations batch-sharded at layer boundaries
    "actshard": ("tp", {"activation_sharding": True}, None),
    "actshard+microhalf": ("tp", {"activation_sharding": True}, -999),
    "actshard+er": ("tp-er", {"activation_sharding": True}, None),
    "actshard_moe": ("tp", {"activation_sharding": True,
                            "activation_sharding_moe_model": True}, None),
    # replicate the embedding table (kills the SPMD gather fallback)
    "embedrep": ("tp-er", {}, None),
    "embedrep+microhalf": ("tp-er", {}, -999),
    "embedrep+cf1.0": ("tp-er", {"capacity_factor": 1.0,
                                 "moe_dropless": False}, None),
}

#: one NVIDIA H100 SXM (data sheet, dense): bf16 FLOP/s and HBM3 bytes/s;
#: and the bytes/s a GPU has off its node, where a 256-rank mesh's
#: collectives run (one 400 Gb/s InfiniBand port a GPU)
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 50e9


def run_variant(arch: str, shape: str, name: str, out_dir: str) -> dict:
    from ..configs import get_config
    from .dryrun import run_cell
    from .input_specs import shape_by_name, train_microbatches
    layout, overrides, micro = VARIANTS[name]
    if micro is not None and micro < 0:
        default = train_microbatches(get_config(arch).replace(**overrides),
                                     shape_by_name(shape))
        micro = max(1, default // 2) if micro == -999 else default * (-micro)
    tag = f"{arch}__{shape}__{name}"
    path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    res = run_cell(arch, shape, multi_pod=False, microbatches=micro,
                   analyze=True, layout=layout, cfg_overrides=overrides)
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    return res


def summarize(res: dict) -> str:
    if res.get("status") != "ok" or "analysis" not in res:
        return f"{res.get('status')}: {res.get('error', '')[:80]}"
    ex = res["analysis"]["extrapolated"]
    comp = ex["flops"] / PEAK_FLOPS
    mem = ex["bytes"] / HBM_BW
    coll = ex["coll_bytes"] / LINK_BW
    bound = max(comp, mem, coll)
    mf = res.get("model_flops", 0)
    roof = (mf / 256 / PEAK_FLOPS) / bound if mf else 0
    return (f"compute={comp * 1e3:8.1f}ms  mem_traced={mem * 1e3:9.1f}ms  "
            f"coll={coll * 1e3:9.1f}ms  roofline_frac(vs traced-bound)="
            f"{roof:.3f}  µ={res['analysis'].get('n_micro', 1)}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variants", default="baseline")
    ap.add_argument("--out", default="runs/hillclimb")
    args = ap.parse_args(argv)
    for name in args.variants.split(","):
        res = run_variant(args.arch, args.shape, name.strip(), args.out)
        print(f"{args.arch}×{args.shape} [{name:>16s}] {summarize(res)}",
              flush=True)


if __name__ == "__main__":
    main()
