import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

try:  # prefer the real property-testing engine when available
    import hypothesis  # noqa: F401
except ImportError:  # CI image has no hypothesis; alias the local stub
    import _hypothesis_stub

    sys.modules["hypothesis"] = _hypothesis_stub
    sys.modules["hypothesis.strategies"] = _hypothesis_stub.strategies


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc; skips (with a reason) without one")
