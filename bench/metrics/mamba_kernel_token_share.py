"""The share of the Mamba layers' tokens that the Mamba kernels took:
``ServingEngine.io_stats``'s ``mamba_kernel_tokens`` over
``mamba_layer_tokens`` (rows x steps the engine's chunk and decode calls
ran through the model's Mamba layers, counted where each layer call
chooses its route), as deltas across the traced run's program slice, in
the drain after the window.  None where the engine has no such
counters."""
UNIT = "%"


def read(rec):
    a, b = rec.io_open, rec.io_close
    if a is None or b is None or "mamba_layer_tokens" not in b:
        return None
    layer = b["mamba_layer_tokens"] - a["mamba_layer_tokens"]
    if layer <= 0:
        return None
    return 100.0 * (b["mamba_kernel_tokens"] - a["mamba_kernel_tokens"]) \
        / layer
