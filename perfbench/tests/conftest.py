"""CPU tests of the benchmark harness:
    PYTHONPATH=src:. python -m pytest perfbench/tests -q
Tests marked `chip` need a CUDA card and skip without one (decided inside
the test)."""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "chip: needs a CUDA card (skips without one)")
