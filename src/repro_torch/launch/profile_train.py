"""Where the training step's time goes on the card: ``torch.profiler`` over
train steps of a full-width model with random weights at the shape of
``chip_smoke.py``'s training run (qwen2-1.5b, 8 x 512 tokens in 2
microbatches, remat), and over the step's two parts alone: one
microbatch's loss and gradients (autograd) and the AdamW update.

    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        --out build/profile_train.json

Prints one JSON object with, per window: host wall time (taken without the
profiler, on the same calls just before), device busy time (the sum of
kernel times), the device's idle share of the wall time, kernel launches
and the kernels that take the most device time; and the step's model
FLOPs (6 x matmul parameters x tokens, plus the attention products) over
its wall time, against the card's 989 TFLOP/s in bf16.  Needs a CUDA
device: device metrics are never taken on the CPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

from ..configs import get_config
from ..data import DataPipeline, SyntheticCorpus
from ..device import resolve_device
from ..models import build_model
from ..optim import adamw_init, adamw_update
from ..train import make_train_step
from ..train.step import _loss_and_grads
from ..tree import tree_leaves
from .profile_serve import _window

#: the shape of ``chip_smoke.py``'s training run (its ``TRAIN_ARGS``)
ARCH, GLOBAL_BATCH, SEQ_LEN, MICROBATCHES = "qwen2-1.5b", 8, 512, 2
STEPS = 3               # calls a window
BF16_PEAK = 989e12      # H100 SXM, dense (NVIDIA data sheet)
LR = 1e-4


def _model_flops(cfg, tokens: int, seq: int) -> float:
    """A dense trunk's 6 x (matmul parameters) x tokens, plus the attention
    products (QK^T and PV, full S x S as the plain path computes them:
    4 S H hd a token forward, 12 with the backward)."""
    hd = cfg.resolved_head_dim
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    attn = d * hd * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
    per_layer = attn + 3 * d * f
    matmul = cfg.num_layers * per_layer + d * v      # lm head (tied or not)
    return 6.0 * matmul * tokens \
        + 12.0 * cfg.num_layers * tokens * seq * cfg.num_heads * hd


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the JSON and a Chrome trace of the "
                         "step window next to it")
    args = ap.parse_args(argv)

    cfg = get_config(ARCH).replace(use_flash=False)
    device = resolve_device("cuda")
    model = build_model(cfg, device)
    params = model.init(args.seed)
    state = {"opt": adamw_init(params)}
    step_fn = make_train_step(model, num_microbatches=MICROBATCHES)
    pipe = DataPipeline(SyntheticCorpus(cfg.vocab_size, seed=args.seed),
                        global_batch=GLOBAL_BATCH, seq_len=SEQ_LEN)
    batch = {k: torch.from_numpy(a).to(device)
             for k, a in pipe.next_batch().items()}

    def step():
        _, state["opt"], _ = step_fn(params, state["opt"], batch, LR)

    step()                                   # warm-up (cuBLAS, allocator)
    step_w, prof = _window(step, STEPS)
    rows = GLOBAL_BATCH // MICROBATCHES
    mb = {k: a[:rows] for k, a in batch.items()}
    grads_w, _ = _window(lambda: _loss_and_grads(model, params, mb), STEPS)
    _, grads = _loss_and_grads(model, params, mb)
    adamw_w, _ = _window(
        lambda: adamw_update(grads, state["opt"], params, LR), STEPS)

    tokens = GLOBAL_BATCH * SEQ_LEN
    flops = _model_flops(cfg, tokens, SEQ_LEN)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    out = {"device": card.splitlines()[0].strip(), "arch": cfg.name,
           "layers": cfg.num_layers, "global_batch": GLOBAL_BATCH,
           "seq_len": SEQ_LEN, "microbatches": MICROBATCHES,
           "params": sum(p.numel() for p in tree_leaves(params)),
           "model_flops": flops,
           "model_tflops_per_s": flops / step_w["wall_ms"] / 1e9,
           "share_of_bf16_peak": flops / (step_w["wall_ms"] / 1e3)
           / BF16_PEAK,
           "tokens_per_s": tokens / step_w["wall_ms"] * 1e3,
           "train_step": step_w, "loss_and_grads_microbatch": grads_w,
           "adamw_update": adamw_w}
    print(json.dumps(out))
    if args.out:
        path = Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=1))
        prof.export_chrome_trace(str(path.with_suffix(".trace.json")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
