"""The port's spans and counters (tpumap_torch/utils/trace.py) on its
plain paths: the SAM bytes do not change with a Recorder installed, each
per-batch span and each ladder stage is recorded once a batch, self
time is total time less the spans inside, and the counters reach an
installed Recorder and the drivers' stats dict alike. No JAX here."""
import functools

import numpy as np
import pytest
import torch

from tpumap_torch.gsnap import driver, engine, ladder, paired
from tpumap_torch.index.device import DeviceIndex
from tpumap_torch.utils import trace
from torch_workloads import mixed_workload, sam_text, stream_pairs

torch.set_num_threads(1)
CFG = engine.AlignConfig(top_k=4, max_occ=8)
BATCH = 24             # the workload's 70 reads: 3 batches
PER_BATCH = ("encode", "upload", "enqueue", "fetch", "widen", "mapq",
             "refine", "emit", "emit_rows")
LADDER = ("cascade", "ends", "prevalent", "trim", "indel", "secondary",
          "narrow")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    db, reads, _gfa = mixed_workload(tmp_path_factory.mktemp("ttrace"),
                                     port=True)
    return db, DeviceIndex.from_host(db, "cpu"), reads, stream_pairs(
        db, port=True)


def _single(world, sink, n=None, **kw):
    db, index, reads, _pairs = world
    reads = reads[:n]
    if not sink:
        return sam_text(driver.align_records(db, index, reads, CFG,
                                             batch_size=BATCH, **kw))
    chunks = []
    assert driver.align_records(db, index, reads, CFG, batch_size=BATCH,
                                sink=chunks.append, **kw) == []
    return b"".join(bytes(c) for c in chunks)


def _paired(world, **kw):
    db, index, _reads, pairs = world
    chunks = []
    assert paired.align_paired_records(
        db, index, pairs, CFG, batch_size=8, pairmax=1000,
        sink=chunks.append, **kw) == []
    return b"".join(bytes(c) for c in chunks)


def _run(fn, *args, **kw):
    rec = trace.Recorder(intervals=True)
    with trace.recording(rec):
        out = fn(*args, **kw)
    return rec, out


@pytest.mark.parametrize("path", ["list", "sink", "paired"])
def test_sam_identical_with_a_recorder(world, path):
    if path == "paired":
        want = _paired(world)
        rec, got = _run(_paired, world)
    else:
        want = _single(world, path == "sink")
        rec, got = _run(_single, world, path == "sink")
    assert got == want and rec.calls["enqueue"] > 0


def test_three_batches_record_each_span_three_times(world):
    # the record path: emit_rows runs every batch (in the streamed path
    # only where a row is left to the Python records)
    rec, _ = _run(_single, world, False, n=3 * BATCH)
    assert rec.counters["batches"] == 3
    assert rec.counters["reads"] == len(world[2]) > 2 * BATCH
    for name in PER_BATCH + LADDER:
        assert rec.calls.get(name) == 3, name
    # the card's wait is the only span a CPU run leaves out
    assert "wait" not in rec.calls
    # the ladder stages lie inside enqueue
    enq = [(s, e) for s, e, n in rec.intervals if n == "enqueue"]
    for s, e, name in rec.intervals:
        if name in LADDER:
            assert any(a <= s and e <= b for a, b in enq), name


def _direct_children(intervals):
    """{interval: [its direct children]} of properly nested intervals."""
    kids = {iv: [] for iv in intervals}
    stack = []
    for iv in sorted(intervals, key=lambda v: (v[0], -v[1])):
        while stack and stack[-1][1] <= iv[0]:
            stack.pop()
        if stack:
            kids[stack[-1]].append(iv)
        stack.append(iv)
    return kids


def test_self_time_is_total_less_children(world):
    rec, _ = _run(_single, world, True, n=2 * BATCH)
    kids = _direct_children(rec.intervals)
    self_ns, total_ns = {}, {}
    for iv, ch in kids.items():
        s, e, name = iv
        total_ns[name] = total_ns.get(name, 0) + e - s
        self_ns[name] = self_ns.get(name, 0) + (e - s) - sum(
            c[1] - c[0] for c in ch)
    assert self_ns == rec.self_ns and total_ns == rec.total_ns
    assert sum(rec.calls.values()) == len(rec.intervals)
    assert rec.self_ns["enqueue"] < rec.total_ns["enqueue"]

    # a span with nothing open inside it: self time is its total
    r2 = trace.Recorder()
    with trace.recording(r2):
        with trace.span("a"):
            with trace.span("b"):
                pass
            with trace.span("b"):
                pass
    assert r2.calls == {"a": 1, "b": 2}
    assert r2.self_ns["b"] == r2.total_ns["b"]
    assert r2.self_ns["a"] == r2.total_ns["a"] - r2.total_ns["b"]


def test_overflow_counters_equal_the_result_dicts(world, monkeypatch):
    """Stage 2 cut to 2 rows a batch overflows on the workload's
    unmapped reads: each overflow counter is the sum of its scalar over
    the batches' result dicts, in the Recorder and in stats alike."""
    seen = []
    start_fetch = ladder.start_fetch

    def capture(dev):
        wait = start_fetch(dev)

        def waited():
            res = wait()
            seen.append(res)
            return res
        return waited
    monkeypatch.setattr(ladder, "start_fetch", capture)
    monkeypatch.setattr(ladder, "align_batch_cascaded_packed",
                        functools.partial(engine.align_batch_cascaded_packed,
                                          stage2_rows=2))
    stats = {}
    rec, _ = _run(_single, world, True, stats=stats)
    assert len(seen) == rec.counters["batches"] > 1
    # DNA: no splice-end review, so no amb_* scalars
    have = [k for k in ladder.OVERFLOWS if k in seen[0]]
    assert have == ["stage2_overflow", "indel_tb_overflow", "sec_overflow"]
    for k in have:
        want = sum(int(r[k]) for r in seen)
        assert rec.counters[k] == stats[k] == want, k
    assert rec.counters["stage2_overflow"] > 0
    want_in = sum(int(np.count_nonzero(r["in_sel"])) for r in seen)
    assert rec.counters["indel_rows"] == want_in > 0
    assert 0 < rec.counters["indel_accepted"] <= want_in


@pytest.mark.parametrize("sink", [False, True])
def test_method_counts_sum_to_the_reads(world, sink):
    stats = {}
    rec, _ = _run(_single, world, sink, stats=stats)
    n = len(world[2])
    assert rec.counters == stats
    assert sum(stats.get(m, 0) for m in driver.METHODS) == n
    assert stats["reads"] == stats["rows_native"] + stats["rows_python"] == n
    assert stats["indel"] > 0 and stats["rows_python"] > 0
    # a method count is no more than its rows: indels are emitted from
    # the rows the host accepted
    assert stats["indel"] <= stats["indel_accepted"]


def test_paired_counters_reach_both(world):
    stats = {}
    rec, _ = _run(_paired, world, stats=stats)
    assert rec.counters == stats
    assert stats["reads"] == 2 * len(world[3])
    assert stats["rows_native"] + stats["rows_python"] == stats["reads"]
    assert stats["rescue_rows"] >= 1
    for k in ("stage2_overflow", "indel_tb_overflow"):
        assert k in stats
    assert rec.calls["pair"] == stats["batches"]


@pytest.mark.parametrize("splicing", [False, True])
def test_pair_layer_counters_and_spans(world, splicing):
    """The pair layer's counters (pairs, concordant by the device
    reduction, EXHAUSTIVE, proper as emitted: the lines with 0x2 over
    two) in the Recorder and stats alike, and its rescue and repair
    spans inside pair, once a batch that has such rows."""
    kw = dict(novelsplicing=True, max_intron=10_000) if splicing else {}
    stats = {}
    rec, text = _run(_paired, world, stats=stats, **kw)
    assert rec.counters == stats
    n = len(world[3])
    flags = [int(ln.split(b"\t")[1]) for ln in text.splitlines()]
    assert stats["pairs"] == n
    assert stats["pairs_proper"] == sum(f & 0x2 > 0 for f in flags) // 2 > 0
    assert stats["pairs_exhaustive"] <= n - stats["pairs_concordant"] < n
    # no gapped mate in this workload's proper pairs
    assert "tlen_from_alignment" not in stats
    assert 1 <= rec.calls["rescue"] <= stats["batches"]
    assert rec.calls.get("repair", 0) == (1 if splicing else 0)
    assert stats["repair_rows"] == (1 if splicing else 0)
    pair = [(s, e) for s, e, name in rec.intervals if name == "pair"]
    for s, e, name in rec.intervals:
        if name in ("rescue", "repair"):
            assert any(a <= s and e <= b for a, b in pair), name


def test_no_recorder_records_nothing(world):
    assert trace.span("encode") is trace.NO_SPAN
    assert trace.span("other") is trace.NO_SPAN
    assert not trace.counting_on()
    trace.count("x", 5)
    rec = trace.Recorder()
    _single(world, True, n=BATCH)
    with trace.recording(rec):
        assert trace.counting_on()
        assert trace.span("x") is not trace.NO_SPAN
    assert rec.calls == {} and rec.counters == {}
    assert trace.span("encode") is trace.NO_SPAN


def test_counting_routes_a_dict_once():
    d = {}
    with trace.counting(d), trace.counting(d):
        trace.count("a", 2)
    with trace.counting(None):
        trace.count("a")
    assert d == {"a": 2}
    rec = trace.Recorder()
    with trace.recording(rec), trace.counting(d):
        trace.count("b")
        with trace.span("s"):
            pass
    assert d == {"a": 2, "b": 1} and rec.counters == {"b": 1}
    assert rec.calls == {"s": 1}
