"""K6c (csrc/localscan.cu, scan_fragment_runs): chip_smoke.py scan_work
with 3 integer operations a window position of each row. Arguments: see
_scan.py."""
import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location(
    "bench_kernel__scan", pathlib.Path(__file__).with_name("_scan.py"))
_scan = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_scan)


def capture(a):
    return _scan.capture_scan(a)


def work(c):
    return _scan.scan_bytes(c), 3 * _scan.counts(c)[0] * c["window"], 0
