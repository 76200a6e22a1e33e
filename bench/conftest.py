"""pytest settings of the benchmark's own tests (``bench/tests``): the
``cuda`` marker, and the checkout's root and ``src`` on the import path."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (runs on the chip; skips "
        "elsewhere)")
