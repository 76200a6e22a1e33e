"""The host's time to issue the Mamba layers of prefill, per 1000 prompt
tokens: over the traced run's program slice (in the drain after the
window), the ``mamba.prefill`` spans inside the program's
``model.prefill_chunk`` spans (``repro_torch.trace``: one Mamba layer's
work on a chunk, from in_proj to out_proj being enqueued), summed, over
the tokens of those chunks (each chunk's ``tokens``, as its Mamba layers
record it).  The spans time the host.  None where the program opens no
``mamba.prefill`` span inside a chunk."""
UNIT = "ms"


def read(rec):
    spans = rec.spans
    seconds, tokens = 0.0, {}
    for s in spans:
        if s.name != "mamba.prefill":
            continue
        p = s.parent
        while p is not None and spans[p].name != "model.prefill_chunk":
            p = spans[p].parent
        if p is None:
            continue
        seconds += s.end - s.start
        tokens[p] = s.attrs["tokens"]
    total = sum(tokens.values())
    if not total:
        return None
    return seconds / total * 1e6
