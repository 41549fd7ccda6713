"""K6a (csrc/localscan.cu, scan_fragment): chip_smoke.py scan_work with 4
integer operations and one popcount a window position of each active
row. Arguments: see _scan.py."""
import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location(
    "bench_kernel__scan", pathlib.Path(__file__).with_name("_scan.py"))
_scan = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_scan)


def capture(a):
    return _scan.capture_scan(a)


def work(c):
    pos = _scan.counts(c)[0] * c["window"]
    return _scan.scan_bytes(c), 4 * pos, pos
