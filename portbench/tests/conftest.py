"""Settings of the benchmark's own tests: `portbench/` and the repository
root on the path, and the `chip` marker for tests that need the card (they
decide inside the test whether there is one, and skip without)."""
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent.parent))
sys.path.insert(0, str(HERE.parent))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA card; skips without one")
