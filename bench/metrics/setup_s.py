"""Set-up: from the process's start to the window's opening: imports, the
weights made on the device, the engine and its pool, the warm-up request
and the lead-in of the cell's traffic (host clock)."""
UNIT = "s"


def read(rec):
    return rec.setup_s
