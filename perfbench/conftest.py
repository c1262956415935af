"""pytest settings of the benchmark's own tests (``perfbench/tests``)."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: runs on an NVIDIA card; skips where CUDA is absent "
        "(run on the card: python3 -m pytest -q perfbench/tests -m card)")
