"""K6b (csrc/localscan.cu, scan_exact_sites): chip_smoke.py exact_work:
per window word of 16 offsets of each active row of fragment length f,
2 f + 2 integer operations and half a popcount. Arguments: see
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
    words = c["window"] // 16 + (c["window"] % 16 > 0)
    active, fsum = _scan.counts(c)
    if fsum is None:
        fsum = (2 * c["F"] + 2) * active
    return _scan.scan_bytes(c), fsum * words, active * words // 2
