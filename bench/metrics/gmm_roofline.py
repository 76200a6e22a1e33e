"""Grouped SwiGLU's share of its roofline over profiled slice A: the sum
of each call's least time (``bench/counts/gmm.py``: the weights of the
experts that received a row, the rows and the output, or the FLOPs on the
kept rows, at 3.35 TB/s or 989 TFLOP/s; group sizes from the op's entry
point) over the device time of the ``gmm_`` kernels (device trace)."""
UNIT = "%"


def read(rec):
    p = rec.profile
    if not p or not p.get("gmm_s"):
        return None
    return 100.0 * p["gmm_bound_s"] / p["gmm_s"]
