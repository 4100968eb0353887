"""The benchmark's own CPU tests: run as ``python -m pytest port_bench/tests``
from the repository root. They need no GPU, no nvcc and no Triton."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (HERE.parent, HERE.parent.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line("markers", "card_free: runs on the CPU alone (no GPU, nvcc or Triton)")
