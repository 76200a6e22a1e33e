"""End-to-end training example: a ~100M-parameter qwen2-family model trained
for a few hundred steps on the full substrate (sharded data pipeline, AdamW
+ warmup-cosine, async checkpointing, crash-safe resume).

The PyTorch port's counterpart of ``examples/train_lm.py``: it starts
``repro_torch.launch.train`` with the reference's arguments, on the GPU
unless ``--device cpu`` (without a CUDA device the launcher exits 1).
The default is d_model=256 / 4 layers (~12M params), 100 steps.  The
assignment-scale run:

    python examples_torch/train_lm.py --hundred-m --steps 300

is the same code at d_model=768 / 12 layers (~131M params with the
smoke's 32768-token vocab; the launcher prints the count).  Run it again
with more ``--steps`` on the same ``--ckpt-dir`` to resume from the last
checkpoint.
"""
import argparse
import os
import subprocess
import sys
from pathlib import Path

SRC = str(Path(__file__).resolve().parents[1] / "src")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hundred-m", action="store_true",
                    help="d_model 768, 12 layers: ~131M params "
                         "(assignment scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default="runs/example_ckpt")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default) fails without a CUDA device")
    args = ap.parse_args(argv)

    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--arch", "qwen2-1.5b", "--smoke",
           "--steps", str(args.steps),
           "--global-batch", "8", "--seq-len", "128",
           "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "50"]
    if args.hundred_m:
        cmd += ["--smoke-dmodel", "768", "--smoke-layers", "12"]
    else:
        cmd += ["--smoke-dmodel", "256", "--smoke-layers", "4"]
    cmd += ["--device", args.device]
    print("+", " ".join(cmd))
    path = os.pathsep.join(filter(None, [SRC, os.environ.get("PYTHONPATH")]))
    raise SystemExit(subprocess.call(cmd, env={**os.environ,
                                               "PYTHONPATH": path}))


if __name__ == "__main__":
    main()
