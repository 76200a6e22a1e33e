"""Output tokens emitted inside the window (by steps that ended in it),
divided by the window's length (host clock)."""
UNIT = "tokens/s"


def read(rec):
    n = sum(s.tokens for s in rec.steps
            if rec.window_open <= s.end < rec.window_close)
    return n / (rec.window_close - rec.window_open)
