"""The host's time to issue a decode step's Mamba layers: over the traced
run's program slice (in the drain after the window), the median across
the program's ``model.decode`` spans of the sum of the ``mamba.decode``
spans inside each (``repro_torch.trace``: one Mamba layer's decode from
in_proj to out_proj being enqueued).  The spans time the host: the
layers' kernels may still run when they end.  None where the program
opens no ``mamba.decode`` span."""
from bench.harness.stats import percentile

UNIT = "ms"


def _inside(spans, i: int, name: str):
    """The innermost enclosing span of ``spans[i]`` named ``name``, as an
    index, or None."""
    p = spans[i].parent
    while p is not None and spans[p].name != name:
        p = spans[p].parent
    return p


def read(rec):
    spans = rec.spans
    per_step = {i: 0.0 for i, s in enumerate(spans)
                if s.name == "model.decode"}
    found = False
    for i, s in enumerate(spans):
        if s.name == "mamba.decode":
            step = _inside(spans, i, "model.decode")
            if step is not None:
                per_step[step] += s.end - s.start
                found = True
    if not found:
        return None
    return percentile(list(per_step.values()), 50) * 1e3
