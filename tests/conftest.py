import os
import sys

# Tests run on the single real CPU device (the 512-device override is
# exclusively for the dry-run, which sets it before its own imports).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: takes several seconds on CPU (deselect with -m 'not slow')")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device; skips without one (run on the GPU with "
        "-m cuda)")
