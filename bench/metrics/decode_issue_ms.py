"""The host's time to issue a decode step: the median of the program's
``model.decode`` spans (``repro_torch.trace``: the paged model's decode
step, from its embedding to its logits being enqueued) in the traced
run's program slice, in the drain after the window.  The span times the
host: the step's kernels may still run when it ends."""
from bench.harness.stats import percentile

UNIT = "ms"


def read(rec):
    v = percentile([s.end - s.start for s in rec.spans
                    if s.name == "model.decode"], 50)
    return None if v is None else v * 1e3
