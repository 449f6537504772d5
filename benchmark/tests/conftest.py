"""The benchmark's own tests (run apart from the repository's ``tests/``):

  python -m pytest benchmark/tests -q

on the CPU, and on the card (the tests marked ``card``):

  python -m pytest benchmark/tests -q -m card
"""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
for p in (BENCH, REPO):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips itself without one")
