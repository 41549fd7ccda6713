"""The fused ladder's and the fused paired program's CUDA-graph replay
(ladder.align_batch_full, ladder.align_pair_full, utils/graphs.py): on
the CPU, the key a captured program is found by and when a batch
replays; on the card, replay against the eager program.

No JAX here, so the card's tests run without tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graphs.py
"""
import types

import numpy as np
import pytest
import torch

from tpumap_torch import kernels
from tpumap_torch.gsnap import driver, ladder, paired
from tpumap_torch.gsnap.engine import AlignConfig
from tpumap_torch.index.device import DeviceIndex
from tpumap_torch.io.fasta import Record
from tpumap_torch.ops.pathdp import PathScoring
from tpumap_torch.utils import dna
from tpumap_torch.utils.trace import counting
from torch_workloads import mixed_workload, sam_text, stream_pairs

L = 128
GRAPH_COUNTERS = ("ladder_graph_captures", "ladder_graph_replays",
                  "ladder_graph_fallbacks")


def cfg():
    return AlignConfig(top_k=4, max_occ=8)


PAIRMAX = 1000


def ladder_args(B, splicing=False, config=None):
    """align_batch_full's arguments after the batch, as align_records
    builds them (a fresh config and scoring each call)."""
    r_chain = min(max(8192, B // 2), B)
    return (config or cfg(), L, PathScoring(max_intron=200_000), splicing,
            splicing, r_chain, min(max(2048, B // 8), r_chain), min(2048, B))


def pair_args(B, splicing=False, pairmax=PAIRMAX, orientation="FR",
              pairexpect=1000, pairdev=100):
    """align_pair_full's arguments after the batch, as
    align_paired_records builds them."""
    return ladder_args(B, splicing) + (pairmax, orientation, pairexpect,
                                       pairdev)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    db, reads, _gfa = mixed_workload(tmp_path_factory.mktemp("tgraphs"),
                                     port=True)
    return db, reads


def plain_reads(reads):
    """The workload's reads without Ns or qualities."""
    return [Record(r.accession, "", r.sequence) for r in reads
            if "N" not in r.sequence]


def pbatch(records, B, device="cpu"):
    return driver._to_device(driver.make_batch(records, B, L), device)


def mutated(s, step):
    """s with one substitution every step bases."""
    s = list(s)
    for j in range(step // 2, len(s), step):
        s[j] = "ACGT"[("ACGT".index(s[j]) + 1) % 4]
    return "".join(s)


def plain_pairs(db):
    """stream_pairs without qualities, then three pairs whose mate 2 the
    ladder leaves unmapped (a substitution every 10-12 bases) and the
    rescue places in mate 1's window: one key for every batch."""
    g = db.get_seq(0, db.genome_length)
    out = [(Record(a.accession, "", a.sequence),
            Record(b.accession, "", b.sequence))
           for a, b in stream_pairs(db, port=True)]
    for step in (10, 11, 12):
        p = 20000 + 1000 * step
        out.append((Record(f"rs{step}/1", "", g[p:p + 100]),
                    Record(f"rs{step}/2", "", dna.revcomp(
                        mutated(g[p + 300:p + 400], step)))))
    return out


def pair_sam(db, index, pairs, stats=None, sink=False, batch_size=8):
    """align_paired_records' SAM bytes, as records or through a sink."""
    kw = dict(pairmax=PAIRMAX, batch_size=batch_size, stats=stats)
    if not sink:
        return sam_text(r for p in paired.align_paired_records(
            db, index, pairs, cfg(), **kw) for r in p)
    chunks = []
    assert paired.align_paired_records(db, index, pairs, cfg(),
                                       sink=chunks.append, **kw) == []
    return b"".join(bytes(c) for c in chunks)


class CpuGraph:
    """SegmentedGraph's interface on the CPU: the capture and each
    replay run the program."""

    def __init__(self, fn, inputs):
        self.fn = fn

    def __call__(self, inputs):
        return self.fn(inputs)


@pytest.fixture
def cpu_replay(monkeypatch):
    """Every batch engages, and a capture is a CpuGraph."""
    monkeypatch.setattr(ladder, "graph_engages", lambda *a: True)
    monkeypatch.setattr(ladder, "SegmentedGraph", CpuGraph)


# ------------------------------------------------------------ the CPU

def test_key_is_by_value(world):
    _db, reads = world
    pb = pbatch(plain_reads(reads)[:32], 32)
    a, b = ladder_args(32), ladder_args(32)
    assert a[0] is not b[0] and a[2] is not b[2]
    assert ladder.graph_key(pb, a) == ladder.graph_key(pb, b)
    assert hash(ladder.graph_key(pb, a)) == hash(ladder.graph_key(pb, b))


def test_key_differs_by_shape_and_flags(world):
    _db, reads = world
    plain = plain_reads(reads)
    n_read = next(r for r in reads if "N" in r.sequence)
    qual = [Record(r.accession, "", r.sequence, "I" * len(r.sequence))
            for r in plain]
    base = ladder.graph_key(pbatch(plain[:32], 32), ladder_args(32))
    with_n = pbatch(plain[:31] + [n_read], 32)
    assert with_n["pnmask"].shape == with_n["packed"].shape
    others = {
        "pnmask": ladder.graph_key(with_n, ladder_args(32)),
        "quals": ladder.graph_key(pbatch(qual[:32], 32), ladder_args(32)),
        "B": ladder.graph_key(pbatch(plain[:32], 64), ladder_args(64)),
        "run_L": ladder.graph_key(pbatch(plain[:32], 32), (
            ladder_args(32)[0], 160) + ladder_args(32)[2:]),
        "splicing": ladder.graph_key(pbatch(plain[:32], 32),
                                     ladder_args(32, splicing=True)),
    }
    for name, key in others.items():
        assert key != base, name
    assert len(set(others.values())) == len(others)


def test_engages_only_on_one_card_in_standard_mode():
    card = torch.device("cuda", 0)
    index = types.SimpleNamespace(device=card)
    pb = {k: types.SimpleNamespace(device=card)
          for k in ("packed", "pnmask", "lengths")}
    assert ladder.graph_engages(index, pb, cfg(), None, None)
    assert not ladder.graph_engages(index, pb, cfg(), None, object())
    assert not ladder.graph_engages(index, pb, cfg(), {"donor": None}, None)
    assert not ladder.graph_engages(
        index, pb, AlignConfig(mode="cmet-stranded"), None, None)
    assert not ladder.graph_engages(
        index, pb, AlignConfig(snp_tolerant=True), None, None)
    cpu = types.SimpleNamespace(device=torch.device("cpu"))
    assert not ladder.graph_engages(cpu, {"packed": cpu}, cfg(), None, None)
    assert not ladder.graph_engages(index, dict(pb, lengths=cpu), cfg(),
                                    None, None)


@pytest.mark.parametrize("sink", [False, True])
def test_cpu_runs_count_eager_batches(world, monkeypatch, sink):
    """align_records on the CPU: every batch eager and counted, and the
    SAM bytes those of the ladder called directly."""
    db, reads = world
    index = DeviceIndex.from_host(db, "cpu")

    def run():
        stats = {}
        if not sink:
            return sam_text(driver.align_records(
                db, index, reads, cfg(), batch_size=24, stats=stats)), stats
        chunks = []
        driver.align_records(db, index, reads, cfg(), batch_size=24,
                             sink=chunks.append, stats=stats)
        return b"".join(bytes(c) for c in chunks), stats

    got, stats = run()
    assert stats["batches"] == 3 and stats["ladder_eager"] == 3
    assert not set(GRAPH_COUNTERS) & set(stats)
    assert not vars(index).get("_ladder_graphs")
    monkeypatch.setattr(ladder, "align_batch_full", ladder._ladder_full)
    want, stats = run()
    assert got == want and "ladder_eager" not in stats


def test_pair_key_apart_from_the_single_end_key(world, cpu_replay):
    """One batch through both programs, with the replay forced on the
    CPU: two keys on the index, the single-end one graph_key(pbatch,
    args) as before, the pair one led by "pair" and ending with the pair
    arguments; each replay the program's eager result."""
    db, reads = world
    index = DeviceIndex.from_host(db, "cpu")
    pb = pbatch(plain_reads(reads)[:32], 32)
    args, pargs = ladder_args(32), pair_args(32)
    assert pargs[:len(args)] == args
    stats = {}
    with counting(stats):
        single = ladder.fetch_result(ladder.align_batch_full(index, pb,
                                                             *args))
        pair = ladder.fetch_result(ladder.align_pair_full(index, pb,
                                                          *pargs))
    keys = set(vars(index)["_ladder_graphs"])
    assert keys == {ladder.graph_key(pb, args),
                    ladder.graph_key(pb, ("pair",) + pargs)}
    assert stats == {"ladder_graph_captures": 2, "ladder_graph_replays": 2}
    for got, want in ((single, ladder._ladder_full(index, pb, *args)),
                      (pair, ladder._pair_full(index, pb, *pargs))):
        want = ladder.fetch_result(want)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_pair_key_is_by_value_and_by_each_pair_argument(world, cpu_replay):
    """Fresh configs and scorings share a pair key; pairmax, orientation,
    pairexpect and pairdev each make a key of their own."""
    db, reads = world
    index = DeviceIndex.from_host(db, "cpu")
    pb = pbatch(plain_reads(reads)[:16], 16)
    runs = [pair_args(16), pair_args(16), pair_args(16, pairmax=2000),
            pair_args(16, orientation="RF"), pair_args(16, pairexpect=400),
            pair_args(16, pairdev=50)]
    assert runs[0][0] is not runs[1][0] and runs[0][2] is not runs[1][2]
    stats = {}
    with counting(stats):
        for args in runs:
            ladder.align_pair_full(index, pb, *args)
    cache = vars(index)["_ladder_graphs"]
    assert list(cache) == [ladder.graph_key(pb, ("pair",) + a)
                           for a in runs[:1] + runs[2:]]
    assert stats == {"ladder_graph_captures": 5, "ladder_graph_replays": 6}


@pytest.mark.parametrize("sink", [False, True])
def test_cpu_paired_runs_count_eager_batches(world, monkeypatch, sink):
    """align_paired_records on the CPU: every batch eager and counted,
    no graph on the index, and the SAM bytes those of the paired
    program called directly."""
    db, _reads = world
    pairs = plain_pairs(db)
    index = DeviceIndex.from_host(db, "cpu")
    stats = {}
    got = pair_sam(db, index, pairs, stats, sink)
    assert stats["batches"] == 4 and stats["ladder_eager"] == 4
    assert stats["rescued"] >= 3
    assert not set(GRAPH_COUNTERS) & set(stats)
    assert not vars(index).get("_ladder_graphs")
    monkeypatch.setattr(ladder, "align_pair_full", ladder._pair_full)
    stats = {}
    assert pair_sam(db, index, pairs, stats, sink) == got
    assert "ladder_eager" not in stats


# ------------------------------------------------------------ the card

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    kernels.build()
    return torch.device("cuda")


def batches(reads, kind, n=4, B=32, seed=0, pairs=None):
    """n batches of B rows, all of one key: different reads of the
    workload, or given pairs different pairs with their mates
    interleaved; N-free and without qualities, each with an N read
    ("ns"), or each with qualities ("quals")."""
    rng = np.random.default_rng(seed)
    units = [(r,) for r in plain_reads(reads)] if pairs is None else pairs
    n_read = next(r for r in reads if "N" in r.sequence)
    out = []
    for _ in range(n):
        recs = [r for i in rng.permutation(len(units))[:B // len(units[0])]
                for r in units[i]]
        if kind == "ns":
            recs[int(rng.integers(0, B))] = n_read
        if kind == "quals":
            recs = [Record(r.accession, "", r.sequence, "".join(
                chr(33 + int(q)) for q in rng.integers(2, 41, len(r.sequence))))
                for r in recs]
        out.append(recs)
    return out


def replay_against_eager(index, groups, kind, eager, program, args, B=32):
    """Each group of records as one batch through the eager program and
    through program (a replay where a graph engages): the dicts equal key
    for key, in values and dtypes, and each batch makes the eager path's
    hand-kernel launches. Returns the counts and the last batch."""
    stats = {}
    with counting(stats):
        for recs in groups:
            pb = pbatch(recs, B, index.device)
            assert (pb["pnmask"].shape == pb["packed"].shape) == (kind == "ns")
            assert ("quals" in pb) == (kind == "quals")
            before = dict(kernels.LAUNCHES)
            want = ladder.fetch_result(eager(index, pb, *args))
            mid = dict(kernels.LAUNCHES)
            got = ladder.fetch_result(program(index, pb, *args))
            after = dict(kernels.LAUNCHES)
            assert sorted(got) == sorted(want)
            for key in want:
                assert got[key].dtype == want[key].dtype, key
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=key)
            made = {k: mid[k] - before[k] for k in mid}
            assert {k: after[k] - mid[k] for k in mid} == made
            assert made["verify_diagonals"] == 3
            assert made["end_lanes"] == made["trim_stage"] == 1
            if kind == "splicing":
                assert made["chain_dp"] == 2 and made["scan_exact_sites"] == 1
    return stats, pb


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["plain", "ns", "quals", "splicing"])
def test_replay_matches_eager(dev, world, kind):
    """Four batches of different reads on one key: the replayed dict
    equals the eager ladder's, key for key, in values and dtypes, and
    each batch makes the eager path's hand-kernel launches."""
    db, reads = world
    index = DeviceIndex.from_host(db, dev)
    stats, _pb = replay_against_eager(
        index, batches(reads, "plain" if kind == "splicing" else kind), kind,
        ladder._ladder_full, ladder.align_batch_full,
        ladder_args(32, splicing=kind == "splicing"))
    assert stats == {"ladder_graph_captures": 1, "ladder_graph_replays": 4}
    assert len(vars(index)["_ladder_graphs"]) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["plain", "ns", "quals", "splicing"])
def test_pair_replay_matches_eager(dev, world, kind):
    """Four batches of 16 different pairs on one key: the replayed paired
    program's dict equals the eager one's, key for key, in values and
    dtypes, with the same hand-kernel launches, under the pair key."""
    db, reads = world
    index = DeviceIndex.from_host(db, dev)
    args = pair_args(32, splicing=kind == "splicing")
    stats, pb = replay_against_eager(
        index, batches(reads, "plain" if kind == "splicing" else kind,
                       pairs=plain_pairs(db)), kind,
        ladder._pair_full, ladder.align_pair_full, args)
    assert stats == {"ladder_graph_captures": 1, "ladder_graph_replays": 4}
    assert list(vars(index)["_ladder_graphs"]) == [
        ladder.graph_key(pb, ("pair",) + args)]


@pytest.mark.cuda
def test_align_records_captures_once_across_calls(dev, world):
    """Two align_records calls, each with its config and scoring built
    anew: one capture, every batch a replay, and the CPU run's SAM."""
    db, reads = world
    plain = plain_reads(reads)[:64]
    index = DeviceIndex.from_host(db, dev)
    want = sam_text(driver.align_records(
        db, DeviceIndex.from_host(db, "cpu"), plain, cfg(), batch_size=32))
    stats = {}
    for _ in range(2):
        assert sam_text(driver.align_records(
            db, index, plain, cfg(), batch_size=32, stats=stats)) == want
    assert stats["batches"] == 4
    assert stats["ladder_graph_captures"] == 1
    assert stats["ladder_graph_replays"] == 4
    assert "ladder_graph_fallbacks" not in stats
    assert "ladder_eager" not in stats


@pytest.mark.cuda
def test_align_paired_records_captures_once_across_calls(dev, world):
    """Two align_paired_records calls of four batches each (a rescued
    mate among them), one through a sink: one capture, every batch a
    replay, and the CPU run's SAM bytes."""
    db, _reads = world
    pairs = plain_pairs(db)
    want = pair_sam(db, DeviceIndex.from_host(db, "cpu"), pairs)
    index = DeviceIndex.from_host(db, dev)
    stats = {}
    for sink in (False, True):
        assert pair_sam(db, index, pairs, stats, sink) == want
    assert stats["batches"] == 8 and stats["rescued"] >= 6
    assert stats["ladder_graph_captures"] == 1
    assert stats["ladder_graph_replays"] == 8
    assert "ladder_graph_fallbacks" not in stats
    assert "ladder_eager" not in stats


@pytest.mark.cuda
@pytest.mark.parametrize("paired", [False, True])
def test_a_failed_capture_runs_eagerly_and_says_so(dev, world, monkeypatch,
                                                   paired):
    """A ladder or paired program that waits for the card cannot be
    captured: the key warns, counts one fallback and runs eagerly from
    then on, with the eager results, and kernels.launch is the module's
    own again."""
    db, reads = world
    index = DeviceIndex.from_host(db, dev)
    launch, narrow = kernels.launch, ladder.narrow_result

    def syncing(d):
        torch.cuda.synchronize()        # refused under stream capture
        return narrow(d)
    monkeypatch.setattr(ladder, "narrow_result", syncing)
    if paired:
        args, tag = pair_args(32), ("pair",)
        run = (ladder._pair_full, ladder.align_pair_full, args)
    else:
        args, tag = ladder_args(32), ()
        run = (ladder._ladder_full, ladder.align_batch_full, args)
    with pytest.warns(UserWarning, match="capture failed"):
        stats, pb = replay_against_eager(
            index, batches(reads, "plain", n=2, seed=1,
                           pairs=plain_pairs(db) if paired else None),
            "plain", *run)
    assert kernels.launch is launch
    assert stats == {"ladder_graph_fallbacks": 1, "ladder_eager": 2}
    assert vars(index)["_ladder_graphs"] == {
        ladder.graph_key(pb, tag + args): None}
