"""The benchmark's own tests: ``python -m pytest portbench/tests`` on the CPU;
``python -m pytest portbench/tests -m chip`` on a CUDA card runs the tests
that need one (they skip without it, decided inside each test)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")
