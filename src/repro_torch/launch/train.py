"""Training launcher, on the GPU unless ``--device cpu``: the PyTorch
counterpart of ``repro/launch/train.py``.

Full-width qwen2-1.5b with random weights on the card:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --steps 20 --global-batch 8 --seq-len 512 --microbatches 2

On the CPU, scaled down, with checkpoints (run it again to resume):

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \
        --steps 3 --ckpt-dir runs/ckpt

``--smoke`` scales the architecture down to a ~100M-class model.
``--arch seamless-m4t-medium`` exits 2: the data pipeline makes no source
embeddings for the encoder-decoder family.  The loop
is the reference's: deterministic data pipeline, AdamW + warmup cosine,
async checkpointing, the straggler detector's hook, and resume from the
latest checkpoint.  The flags are those of ``repro.launch.train`` plus
``--device``.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from ..checkpoint import CheckpointManager, latest_step
from ..configs import get_config, scale_down
from ..data import DataPipeline, SyntheticCorpus
from ..device import resolve_device
from ..models import build_model
from ..optim import adamw_init, warmup_cosine
from ..runtime import StragglerDetector
from ..train import make_train_step
from ..tree import tree_leaves


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default) fails without a CUDA device")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable ~100M-class)")
    ap.add_argument("--smoke-dmodel", type=int, default=256)
    ap.add_argument("--smoke-layers", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def train(args: argparse.Namespace) -> dict:
    """Run the loop of ``args``; returns the model, the trained params and
    optimizer state, and each step's loss, grad norm, lr and seconds."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = scale_down(cfg, layers=args.smoke_layers,
                         d_model=args.smoke_dmodel,
                         d_ff=args.smoke_dmodel * 4,
                         vocab=min(cfg.vocab_size, 32768))
    # Training pays for capacity-limited (droppy) dispatch on purpose:
    # dead-task shedding is the regularizer/perf model under study, and
    # dropless capacity (= T) would inflate expert buffers ~E/(k·cf)×.
    # Serving/eval keep the dropless default (decode ≡ forward).
    # No kernel has a backward pass (their wrappers refuse tensors that
    # require grad), so training takes the plain path, as the reference's
    # does.
    cfg = cfg.replace(moe_dropless=False, use_flash=False)
    model = build_model(cfg, device)
    params = model.init(args.seed)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params:,} "
          f"(~{n_params / 1e6:.1f}M)")

    opt = adamw_init(params)
    step_fn = make_train_step(model, num_microbatches=args.microbatches)
    pipe = DataPipeline(SyntheticCorpus(cfg.vocab_size, seed=args.seed),
                        global_batch=args.global_batch,
                        seq_len=args.seq_len)
    start = 0
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if mgr and latest_step(args.ckpt_dir) is not None:
        state, manifest = mgr.restore_latest(
            {"params": params, "opt": opt})
        params, opt = state["params"], state["opt"]
        start = manifest["step"]
        pipe.state.step = start
        print(f"resumed from step {start}")

    detector = StragglerDetector(num_hosts=1)
    history = []
    for step in range(start, args.steps):
        lr = warmup_cosine(step, peak_lr=args.lr,
                           warmup_steps=max(args.steps // 20, 5),
                           total_steps=args.steps)
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in pipe.next_batch().items()}
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch, lr)
        loss = float(metrics["loss"])     # waits for the step
        dt = time.perf_counter() - t0
        detector.record_step(0, dt)
        gnorm = float(metrics["grad_norm"])
        history.append({"step": step, "loss": loss, "grad_norm": gnorm,
                        "lr": float(lr), "seconds": dt,
                        "metrics": {k: float(v) for k, v in metrics.items()}})
        if step % 10 == 0 or step == args.steps - 1:
            toks = args.global_batch * args.seq_len / dt
            print(f"step {step:5d} loss={loss:.4f} gnorm={gnorm:.2f} "
                  f"lr={float(lr):.2e} {dt * 1e3:.0f}ms "
                  f"({toks:.0f} tok/s)")
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, {"params": params, "opt": opt})
    if mgr:
        mgr.save(args.steps, {"params": params, "opt": opt},
                 blocking=True)
    return {"model": model, "params": params, "opt": opt,
            "history": history}


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        cfg = get_config(args.arch)
    except KeyError as e:
        print(e.args[0], file=sys.stderr)
        return 2
    if cfg.family == "encdec":
        print(f"--arch {args.arch}: the launcher cannot train the "
              "encoder-decoder family: its DataPipeline makes token batches "
              "only, and this family's batches need src_embeds; drive it "
              "with train.make_train_step", file=sys.stderr)
        return 2
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    train(args)
    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
