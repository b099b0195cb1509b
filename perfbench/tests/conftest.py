"""The benchmark's tests: CPU tests at small sizes, and tests marked
`card` that run on the H100 and skip elsewhere (the decision is made in
the `card` fixture, never while a module is imported).

    python -m pytest perfbench/tests -q            # here: card tests skip
    python -m pytest perfbench/tests -q -m card    # on the card
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda:0")
