"""The harness's tests run on the CPU with the kernels' plain versions;
tests marked ``chip`` need a CUDA card and skip without one (each decides
inside the test, never at import)."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (str(HERE.parents[1]), str(HERE.parent), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips on the CPU with a reason")
