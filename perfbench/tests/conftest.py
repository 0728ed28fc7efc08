"""CPU tests of the benchmark.  Run from the root of a checkout:

    python -m pytest -q perfbench/tests

Tests marked ``card`` need a CUDA card and skip without one (the test
decides, not the collection)."""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
