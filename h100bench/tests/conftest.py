"""The benchmark's own tests (``python -m pytest h100bench/tests``). They
run on the CPU; a test that needs the card carries the ``card`` marker and
decides inside itself whether to skip."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips on a host without one")
