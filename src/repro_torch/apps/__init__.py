# Copied from src/repro/apps/__init__.py; only the imports may differ.
"""The paper's application kernels (Section 4), each with its specialized
strategy and a strategy-oblivious baseline path."""
from . import bipartition, prefix_sum, quicksort, sssp, tristrip, uts  # noqa: F401
