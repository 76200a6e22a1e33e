"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
without sparsity, at the full 700 W power limit).

Frozen copy of ``chip_smoke.py``'s ``HBM_BYTES_S`` and ``PEAK_FLOPS`` at
commit 55bfaa9."""
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}
