"""The device's idle share over profiled slice A: 1 - the union of its
kernels' intervals / the slice's wall time (device trace)."""
UNIT = "%"


def read(rec):
    p = rec.profile
    if not p or not p.get("window_s"):
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
