"""The fused ladder's CUDA-graph replay (ladder.align_batch_full,
utils/graphs.py): on the CPU, the key a captured ladder is found by and
when a batch replays; on the card, replay against the eager ladder.

No JAX here, so the card's tests run without tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graphs.py
"""
import types

import numpy as np
import pytest
import torch

from tpumap_torch import kernels
from tpumap_torch.gsnap import driver, ladder
from tpumap_torch.gsnap.engine import AlignConfig
from tpumap_torch.index.device import DeviceIndex
from tpumap_torch.io.fasta import Record
from tpumap_torch.ops.pathdp import PathScoring
from tpumap_torch.utils.trace import counting
from torch_workloads import mixed_workload, sam_text

L = 128
GRAPH_COUNTERS = ("ladder_graph_captures", "ladder_graph_replays",
                  "ladder_graph_fallbacks")


def cfg():
    return AlignConfig(top_k=4, max_occ=8)


def ladder_args(B, splicing=False, config=None):
    """align_batch_full's arguments after the batch, as align_records
    builds them (a fresh config and scoring each call)."""
    r_chain = min(max(8192, B // 2), B)
    return (config or cfg(), L, PathScoring(max_intron=200_000), splicing,
            splicing, r_chain, min(max(2048, B // 8), r_chain), min(2048, B))


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


# ------------------------------------------------------------ the card

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    kernels.build()
    return torch.device("cuda")


def batches(reads, kind, n=4, B=32, seed=0):
    """n batches of different reads of the workload, all of one key: N-free
    and without qualities, each with an N read ("ns"), or each with
    qualities ("quals")."""
    rng = np.random.default_rng(seed)
    plain = plain_reads(reads)
    n_read = next(r for r in reads if "N" in r.sequence)
    out = []
    for _ in range(n):
        recs = [plain[i] for i in rng.permutation(len(plain))[:B]]
        if kind == "ns":
            recs[int(rng.integers(0, B))] = n_read
        if kind == "quals":
            recs = [Record(r.accession, "", r.sequence, "".join(
                chr(33 + int(q)) for q in rng.integers(2, 41, len(r.sequence))))
                for r in recs]
        out.append(recs)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["plain", "ns", "quals", "splicing"])
def test_replay_matches_eager(dev, world, kind):
    """Four batches of different reads on one key: the replayed dict
    equals the eager ladder's, key for key, in values and dtypes, and
    each batch makes the eager path's hand-kernel launches."""
    db, reads = world
    index = DeviceIndex.from_host(db, dev)
    B = 32
    args = ladder_args(B, splicing=kind == "splicing")
    stats = {}
    with counting(stats):
        for recs in batches(reads, "plain" if kind == "splicing" else kind):
            pb = pbatch(recs, B, dev)
            assert (pb["pnmask"].shape == pb["packed"].shape) == (kind == "ns")
            assert ("quals" in pb) == (kind == "quals")
            before = dict(kernels.LAUNCHES)
            want = ladder.fetch_result(ladder._ladder_full(index, pb, *args))
            mid = dict(kernels.LAUNCHES)
            got = ladder.fetch_result(ladder.align_batch_full(index, pb,
                                                              *args))
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
    assert stats == {"ladder_graph_captures": 1, "ladder_graph_replays": 4}
    assert len(vars(index)["_ladder_graphs"]) == 1


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
def test_a_failed_capture_runs_eagerly_and_says_so(dev, world, monkeypatch):
    """A ladder that waits for the card cannot be captured: the key warns,
    counts one fallback and runs eagerly from then on, with the eager
    results, and kernels.launch is the module's own again."""
    db, reads = world
    index = DeviceIndex.from_host(db, dev)
    launch, narrow = kernels.launch, ladder.narrow_result

    def syncing(d):
        torch.cuda.synchronize()        # refused under stream capture
        return narrow(d)
    monkeypatch.setattr(ladder, "narrow_result", syncing)
    args = ladder_args(32)
    stats = {}
    with counting(stats), pytest.warns(UserWarning, match="capture failed"):
        for recs in batches(reads, "plain", n=2, seed=1):
            pb = pbatch(recs, 32, dev)
            want = ladder.fetch_result(ladder._ladder_full(index, pb, *args))
            got = ladder.fetch_result(ladder.align_batch_full(index, pb,
                                                              *args))
            for key in want:
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=key)
    assert kernels.launch is launch
    assert stats == {"ladder_graph_fallbacks": 1, "ladder_eager": 2}
    assert vars(index)["_ladder_graphs"] == {ladder.graph_key(pb, args): None}
