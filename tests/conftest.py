import os
import sys

import pytest

# Smoke tests and benches must see exactly ONE device — the 512-device flag
# is set only inside launch/dryrun.py (and subprocess-based dist tests).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: iterative attack sweeps and other long-running tests, "
        "excluded from the default tier-1 run (enable with --run-slow "
        "or RUN_SLOW=1)")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card (the hand-written Hopper kernels); skips "
        "where torch.cuda.is_available() is false")


def pytest_addoption(parser):
    parser.addoption("--run-slow", action="store_true", default=False,
                     help="also run tests marked slow (DLG attack sweeps)")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--run-slow") or os.environ.get("RUN_SLOW") == "1":
        return
    skip = pytest.mark.skip(reason="slow attack sweep; use --run-slow "
                                   "or RUN_SLOW=1")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
