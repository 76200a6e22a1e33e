"""Flash attention's decode (``split`` route) share of its roofline over
profiled slice A: the sum of each decode call's least time
(``bench/counts/flash.py``: q and o once and each sequence's valid K and
V once, ``kv_valid`` taken from the engine's positions at the call) over
the device time of the ``flash_split`` and ``flash_combine`` kernels
(device trace)."""
UNIT = "%"


def read(rec):
    p = rec.profile
    if not p or not p.get("flash_decode_s"):
        return None
    return 100.0 * p["flash_decode_bound_s"] / p["flash_decode_s"]
