"""The whole step's share of the chip's peak: the model FLOPs of the
window's steps (``bench/counts/step.py``: 2 a token for every parameter
it passes through, plus attention's products over the keys it sees;
useful work only) over their summed wall time times the peak of the
served type (989 TFLOP/s in bf16; traced runs)."""
from bench.counts.peaks import PEAK_FLOPS
from bench.harness.stats import window_steps

UNIT = "%"


def read(rec):
    steps = window_steps(rec)
    if not rec.calls or not steps:
        return None
    idx = {i for i, _ in steps}
    flops = sum(c["flops"] for c in rec.calls if c["step"] in idx)
    wall = sum(s.end - s.start for _, s in steps)
    return 100.0 * flops / (wall * PEAK_FLOPS[rec.sizes["dtype"]])
