"""Frozen operation, byte and model-FLOP arithmetic, and the table of the
chip's peaks.  Copied from the program's own arithmetic (``chip_smoke.py``:
``_gmm_bound``, ``_bound``, ``HBM_BYTES_S``, ``PEAK_FLOPS``) as it stood
at commit 55bfaa9, so that a later change to the program cannot move the
yardstick."""
