"""The benchmark's tests: on the CPU with the kernels' plain versions,
at sizes a test run holds.  Tests marked ``cuda`` need the card and
skip without one (each decides inside the test)."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA card; skips without one")
