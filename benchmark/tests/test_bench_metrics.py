"""Each metric reader on recorded synthetic readings: a trace of known
busy intervals, spans and hand-kernel launches."""
import json
import pathlib

import pytest
import torch

from harness import manifest, peaks, trace, window

ROOT = pathlib.Path(__file__).resolve().parents[2]


class _Ev:
    def __init__(self, name, s, e, cuda):
        self._n, self._s, self._e, self._c = name, s, e, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._c else DeviceType.CPU


class _Prof:
    """A profile of the card alone: the marker at 5-6 ms (launched at
    host time 1,000 ns, which the trace's clock puts at 5 ms), device
    work at 100-200 ms (a torch op), 150-250 ms (a hand kernel,
    overlapping it), 600-700 ms (a copy) and 1.1 s (past the window's
    end at 1 s)."""

    def __init__(self):
        ms = 10**6
        evs = [_Ev("void at::native::fill<...>", 5 * ms, 6 * ms, True),
               _Ev("void at::native::elementwise_kernel<...>", 100 * ms,
                   200 * ms, True),
               _Ev("void verify_kernel<true>(unsigned int const*)",
                   150 * ms, 250 * ms, True),
               _Ev("Memcpy DtoH (Device -> Pinned)", 600 * ms, 700 * ms,
                   True),
               _Ev("void at::native::x", 1100 * ms, 1200 * ms, True),
               _Ev("cudaLaunchKernel", 50 * ms, 51 * ms, False)]

        class K:
            def events(self_inner):
                return evs

        class P:
            kineto_results = K()
        self.profiler = P()


def test_analyse_a_recorded_trace():
    ms = 10**6
    off = 5 * ms - 1000                 # the trace's clock less the host's
    spans = [(s - off, e - off, n) for s, e, n in [
        (0, 900 * ms, "align"), (300 * ms, 550 * ms, "emit_ms"),
        (900 * ms, 990 * ms, "parse_ms")]]
    d = trace.analyse(_Prof(), ["verify_kernel", "trim_kernel"], 1000,
                      -off, 10**9 - off, spans)
    assert d["window_s"] == pytest.approx(1.0)
    assert d["busy_s"] == pytest.approx(0.25)       # 100-250, 600-700
    assert d["device_s"] == pytest.approx(0.3)
    assert d["hand_s"] == pytest.approx(0.1)
    assert d["n_device_events"] == 4 and d["n_outside"] == 1
    assert d["device_ops"][0][1] == pytest.approx(0.1)
    # gaps, each by the innermost span at its middle: 250-600 (emit_ms
    # inside align), 700-1000 (850: align alone), 0-100
    assert d["idle_gaps"][0] == ["emit_ms", pytest.approx(0.35)]
    assert d["idle_gaps"][1] == ["align", pytest.approx(0.3)]
    assert d["idle_gaps"][2] == ["align", pytest.approx(0.1)]


def _readings(device, bound=None, batches=4):
    spans = window.Spans()
    with spans.span("emit_ms"):
        with spans.span("encode_ms"):
            pass
    spans.self_s = {"emit_ms": 0.2, "encode_ms": 0.04}
    return trace.Readings(spans, batches, device, bound, batches / 2, 2.0)


DEVICE = {"window_s": 1.0, "busy_s": 0.25, "device_s": 0.3, "hand_s": 0.1}


@pytest.mark.parametrize("name,want", [
    ("emit_ms", 50.0), ("encode_ms", 10.0), ("parse_ms", None),
    ("input_wait_ms", None), ("enqueue_ms", None), ("refine_ms", None),
    ("pair_ms", None), ("device_busy_ms", 125.0),
    ("device_idle_share", 75.0), ("torch_op_ms", 100.0),
    ("hand_kernels_roofline", 20.0)])
def test_reader(name, want):
    got = manifest.metric_reader(name).read(_readings(DEVICE, bound=0.02))
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("name", ["device_busy_ms", "device_idle_share",
                                  "torch_op_ms", "hand_kernels_roofline"])
def test_device_readers_find_nothing_without_a_trace(name):
    assert manifest.metric_reader(name).read(_readings(None)) is None


def test_every_per_layer_metric_has_a_reader():
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in man["per_layer"]:
        mod = manifest.metric_reader(m["name"])
        assert callable(mod.read)
        for modname, attr in mod.SPANS:
            import importlib
            assert callable(getattr(importlib.import_module(modname), attr))


def test_spans_self_time():
    spans = window.Spans(intervals=True)
    import time
    with spans.span("a"):
        time.sleep(0.02)
        with spans.span("b"):
            time.sleep(0.03)
    assert spans.self_s["b"] >= 0.03
    assert 0.02 <= spans.self_s["a"] < 0.03 + 0.02
    (b0, b1, b), (a0, a1, a) = spans.intervals
    assert (a, b) == ("a", "b") and a0 < b0 < b1 <= a1


INVALID = 0xFFFFFFFF


def _launch_args(name):
    """CPU tensors shaped as each kernel's launch arguments."""
    t = torch.zeros
    if name == "verify_diagonals":
        d = torch.full((4, 8), INVALID, dtype=torch.int64)
        d[:, :3] = 5
        return (t(10), 10, t(5), 5, None, 0, t(4, 7), t(4, 7),
                torch.full((4,), 100), d, 4, 7, 8, 1, 0, 1, 0, t(4, 8))
    if name == "banded_align":
        return (t(4, 128), torch.full((4,), 100), t(4, 164), t(4), 4, 128,
                164, 32, 0, 1, 3, 4, 1, t(4, 128, 65), t(4), t(4), t(4, 65))
    if name == "traceback":
        return (t(4, 128, 65), t(4), t(4), 4, 128, 65, 32, 12, t(4, 192))
    if name == "chain_dp":
        d = torch.full((4, 8), INVALID, dtype=torch.int64)
        d[:, :2] = 7
        return (d, t(4, 8, 128), t(4, 8, 128), t(4, 8, 128),
                t(4, 8, 128, dtype=torch.bool), 0, torch.full((4,), 100),
                4, 8, 128) + (0,) * 13 + (0,) * 8
    if name.startswith("scan"):
        return (t(10), 10, t(4), t(4, 16), torch.tensor([0, 5, 16, 3]), 4,
                16, 65536, 4, 0, t(4, 4), t(4, 4), 0)
    if name == "end_lanes":
        return (t(4, 128), torch.full((4,), 100)) + (t(3), 3) * 5 + (
            None, 0, 4, 128, 14, 3, 32, 8, 3, 0, 0, 1, 1, None, 0,
            t(8, 16))
    if name == "trim_stage":
        out = torch.zeros((4, 4), dtype=torch.int32)
        out[1] = 100
        out[3] = 2
        return (t(10), 10, t(5), 5, None, 0, t(4, 128), t(4, 128),
                torch.full((4,), 100), t(4), torch.full((4,), 3), None, 4,
                128, 8, 1, 0, 1, 0, 0, 8, 8, 1, None, out)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["verify_diagonals", "banded_align",
                                  "traceback", "chain_dp", "scan_fragment",
                                  "scan_exact_sites", "scan_fragment_runs",
                                  "end_lanes", "trim_stage"])
def test_kernel_work_counts(name):
    rec = trace.Launches()
    seen = []
    args = _launch_args(name)
    with torch.autograd.profiler.profile() as prof:
        rec.wrap(lambda *a: seen.append(a))(name, "cpu", *args)
    # the capture runs no tensor op: its counts come after the window
    assert not [e for e in prof.function_events
                if e.name.startswith("aten::")]
    assert len(seen) == 1 and rec.calls[0][0] == name
    nbytes, ops, popc = rec.mods[name].work(rec.calls[0][1])
    b = rec.bound_s()
    assert 0 < b < 1e-3
    assert b == pytest.approx(peaks.bound_s(nbytes, ops, popc))
    assert rec.calls == [(name, None)]
