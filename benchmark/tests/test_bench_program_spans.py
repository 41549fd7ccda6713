"""The readers of the port's own spans and of the launches a batch: their
values on recorded readings, their wrapping only where the port has the
functions, and a traced run on the CPU that reads them."""
import pathlib

import pytest
import torch

from harness import manifest, port_spans, runner, trace, window
from tests.tiny import tiny_cell

ROOT = pathlib.Path(__file__).resolve().parents[2]
PROGRAM = ("transfer_ms", "result_wait_ms", "row_emit_ms")


def _readings(device=None, batches=4):
    spans = window.Spans()
    for name in PROGRAM:
        with spans.span(name):
            pass
    spans.self_s = {"transfer_ms": 0.1, "result_wait_ms": 0.02,
                    "row_emit_ms": 0.04}
    return trace.Readings(spans, batches, device, None, batches / 2, 2.0)


DEVICE = {"window_s": 1.0, "busy_s": 0.25, "device_s": 0.3, "hand_s": 0.1,
          "n_device_events": 1601, "n_outside": 1}


@pytest.mark.parametrize("name,want", [
    ("transfer_ms", 25.0), ("result_wait_ms", 5.0), ("row_emit_ms", 10.0),
    ("device_ops_per_batch", 800.0)])
def test_reader(name, want):
    got = manifest.metric_reader(name).read(_readings(DEVICE))
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", PROGRAM + ("device_ops_per_batch",))
def test_readers_find_nothing_without_their_readings(name):
    empty = trace.Readings(window.Spans(), 4, None, None, 2, 2.0)
    assert manifest.metric_reader(name).read(empty) is None


def test_where_present():
    have = [("tpumap_torch.gsnap.ladder", "start_fetch"),
            ("tpumap_torch.gsnap.driver", "_emit_rows")]
    assert port_spans.where_present(have) == have


def test_where_present_raises_on_a_missing_function():
    """A port with its program spans that lacks a listed function (one
    renamed or inlined) fails loudly rather than silencing the metric."""
    with pytest.raises(AttributeError, match="no_such_function"):
        port_spans.where_present(
            [("tpumap_torch.gsnap.ladder", "no_such_function")])
    with pytest.raises(ImportError):
        port_spans.where_present([("tpumap_torch.no_such_module", "f")])


@pytest.mark.parametrize("name,attr", [
    ("transfer_ms", "_host_view"), ("result_wait_ms", "_wait_event")])
def test_a_renamed_function_stops_the_metric(monkeypatch, name, attr):
    from tpumap_torch.gsnap import ladder
    assert manifest.metric_reader(name).SPANS
    monkeypatch.delattr(ladder, attr)
    with pytest.raises(AttributeError, match=attr):
        manifest.metric_reader(name)


@pytest.mark.parametrize("name", PROGRAM)
def test_a_port_without_its_spans_is_not_wrapped(monkeypatch, name):
    """A port from before the program spans (no tpumap_torch.utils.trace,
    as at the parent of the change that added them): the metric wraps
    nothing and reads nothing."""
    import sys
    monkeypatch.setitem(sys.modules, "tpumap_torch.utils.trace", None)
    mod = manifest.metric_reader(name)
    assert mod.SPANS == []
    assert mod.read(trace.Readings(window.Spans(), 4, None, None)) is None


def test_traced_cpu_run_reads_the_program_spans(tmp_path):
    c = tiny_cell(tmp_path, "dna_se100")
    res, _checks = runner.run(ROOT, c, 2**31 + 103, 0.5, True,
                              torch.device("cpu"), lambda m: None)
    m = res["metrics"]
    for name in ("transfer_ms", "row_emit_ms", "enqueue_ms", "emit_ms"):
        assert m[name]["value"] > 0, name
    # no card: no wait for one, no profile of one
    assert "result_wait_ms" not in m and "device_ops_per_batch" not in m
    assert res["correct"]
