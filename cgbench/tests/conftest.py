"""Settings of the benchmark's own tests (python -m pytest cgbench/tests).

Tests that need a card carry the `cuda` marker and skip without one; the
choice is made per test, in a fixture, never while a module is imported.
"""

import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skipped without one)")


@pytest.fixture(autouse=True)
def _cuda_gate(request):
    if request.node.get_closest_marker("cuda") is not None:
        import torch

        if not torch.cuda.is_available():
            pytest.skip("CUDA test: torch.cuda.is_available() is False")
