"""Shared pytest wiring for the test tree.

Registers the ``--update-golden`` flag used by tests/conformance/test_golden
to regenerate the frozen trajectory fixtures under tests/golden/ — golden
cells are only ever rewritten deliberately, never as a side effect of a
normal run.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips where there is none")


def pytest_addoption(parser):
    parser.addoption(
        "--update-golden", action="store_true", default=False,
        help="regenerate tests/golden/*.npz trajectory fixtures from the "
             "current engines instead of checking against them")


@pytest.fixture
def update_golden(request) -> bool:
    return request.config.getoption("--update-golden")
