"""The benchmark's own tests, run on the CPU with
``python -m pytest benchmark/tests -q``; those marked ``card`` need a CUDA
card and skip without one (the test decides, never the collection)."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
