"""The benchmark's own tests (``python -m pytest pvbench/tests``): they
import no JAX, so they run on the CPU here and on the card's host alike.
Tests marked ``gpu`` need a CUDA card and decide inside a fixture."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips where there is none")
