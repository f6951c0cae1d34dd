"""The benchmark's own tests. `card` marks a test that needs a CUDA card:
it asks for the `card` fixture, which decides when the test runs (never
while a module is imported) and skips it on a machine without one.

    python -m pytest cardbench/tests -q             # here: card tests skip
    python -m pytest cardbench/tests -q -m card     # on the card
"""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return "cuda"
