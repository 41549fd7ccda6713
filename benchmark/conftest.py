"""pytest settings of the benchmark's own tests (benchmark/tests): the
`cuda` marker for tests that need a card; they skip where there is
none, deciding inside the test."""
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
for p in (str(HERE), str(HERE.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips where there is none)")
