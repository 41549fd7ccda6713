"""The port's staged path against tpumap's (JAX on the CPU): the same
numpy inputs through both, values and dtypes compared exactly.

- ops: engine.refine_indels (K2 then K3), engine.refine_splices with
  and without known sites (exact ties included: the first best boundary
  wins, as jnp.argmax) and spliceends.find_splice_ends (K6b), on the
  splice-ends world of tests/test_spliceends.py;
- the slice: SAM byte for byte on the six reads of tests/test_fusion.py
  (cross-chromosome, reverse strand, without the flag, an ordinary read,
  inverted forward-first and reverse-first), on test_twopass's learned
  indel read, on the splice-ends world through the staged path, and on
  paired reads through the staged path (known_indels).
"""
import dataclasses

import numpy as np
import pytest
import torch

from tpumap.gsnap import driver as jdriver
from tpumap.gsnap import engine as jengine
from tpumap.gsnap import paired as jpaired
from tpumap.gsnap import spliceends as jse
from tpumap.gsnap.knownindels import KnownIndels as JKnownIndels
from tpumap.gsnap.knownsplicing import KnownSplicing as JKnownSplicing
from tpumap.gsnap.params import INDEL_BAND, INDEL_MARGIN
from tpumap.index import build_db
from tpumap.index.device import DeviceIndex as JaxIndex
from tpumap.io.fasta import Record
from tpumap.utils import dna
from tpumap_torch.gsnap import driver, engine, paired
from tpumap_torch.gsnap import spliceends as se
from tpumap_torch.gsnap.knownindels import KnownIndels
from tpumap_torch.gsnap.knownsplicing import KnownSplicing, known_to_device
from tpumap_torch.index.device import DeviceIndex
from torch_workloads import mixed_workload, sam_text, stream_pairs

torch.set_num_threads(2)


def rand_seq(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def same(port, want):
    """Equal values and dtypes (uint32 diagonals are int64 in the port,
    so those compare by value)."""
    w = np.asarray(want)
    g = port.numpy()
    assert g.shape == w.shape
    if w.dtype != np.uint32:
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
    assert np.array_equal(g.astype(np.int64), w.astype(np.int64))


@pytest.fixture(scope="module")
def se_world(tmp_path_factory):
    """tests/test_spliceends.py's world: introns with a unique short
    residue on either side, and two interchangeable acceptors."""
    root = tmp_path_factory.mktemp("tse")
    rng = np.random.default_rng(91)
    g = list("ACGT"[i] for i in rng.integers(0, 4, 60000))
    g[12000:12002] = list("GT")
    g[12798:12800] = list("AG")
    g[20000:20002] = list("GT")
    g[20998:21000] = list("AG")
    g[30000:30002] = list("GT")
    g[30598:30600] = list("AG")
    g[31198:31200] = list("AG")
    g[31200:31208] = g[30600:30608]
    genome = "".join(g)
    (root / "g.fa").write_text(">chr1\n" + genome + "\n")
    db = build_db(root / "g.fa", name="se", k=13, interval=3)
    return db, JaxIndex.from_host(db), DeviceIndex.from_host(db, "cpu"), \
        genome


# ------------------------------------------------------------------ ops

def test_refine_indels(se_world):
    """Rows with deletions, insertions and none, both orientations, at
    the staged indel stage's shape (a pad_to_bucket row count)."""
    db, ji, ti, genome = se_world
    rng = np.random.default_rng(5)
    L, R = 128, 32
    codes = np.zeros((R, L), np.uint8)
    lengths = np.ones(R, np.int32)
    diags = np.zeros(R, np.uint32)
    for r in range(24):
        p = int(rng.integers(1000, 50000))
        s = genome[p:p + 120]
        if r % 3 == 1:
            s = s[:50] + s[50 + 1 + r % 5:]
        elif r % 3 == 2:
            s = s[:60] + "ACG"[:1 + r % 3] + s[60:]
        s = s[:100 + r % 20]
        codes[r, :len(s)] = dna.encode(s)[0]
        lengths[r] = len(s)
        diags[r] = p
    want = jengine.refine_indels(ji, codes, lengths, diags, INDEL_BAND,
                                 INDEL_MARGIN)
    got = engine.refine_indels(ti, torch.from_numpy(codes),
                               torch.from_numpy(lengths),
                               torch.from_numpy(diags.astype(np.int64)),
                               INDEL_BAND, INDEL_MARGIN)
    for k in ("score", "ops", "start_off"):
        same(got[k], want[k])


def splice_pairs(genome, rng, R=32, P=4):
    """Reads across the world's introns and random ones, each with P
    candidate pairs: the true (exon, exon) diagonals, shuffled ones and
    INVALID lanes; a read of 16 bases whose boundary ties everywhere."""
    L = 100
    codes = np.zeros((R, L), np.uint8)
    nmask = np.zeros((R, L), bool)
    lengths = np.full(R, L, np.int32)
    dA = np.full((R, P), 0xFFFFFFFF, np.uint32)
    dB = np.full((R, P), 0xFFFFFFFF, np.uint32)
    introns = [(12000, 12800), (20000, 21000), (30000, 30600),
               (30000, 31200)]
    for r in range(R):
        don, acc = introns[r % 4]
        q = int(rng.integers(20, 80))
        s = genome[don - q:don] + genome[acc:acc + L - q]
        if r % 5 == 4:
            s = s[:30] + "N" + s[31:]
        c, m = dna.encode(s)
        codes[r], nmask[r] = c, m
        dA[r, 0], dB[r, 0] = don - q, acc - q
        dA[r, 1], dB[r, 1] = don - q + 1, acc - q
        dA[r, 2] = int(rng.integers(0, 59000))
        dB[r, 2] = int(rng.integers(0, 59000))
    # a boundary that moves freely: both diagonals on the same sequence
    lengths[R - 1] = 16
    dA[R - 1, :] = dB[R - 1, :] = 5000
    codes[R - 1, :16] = dna.encode(genome[5000:5016])[0]
    return codes, nmask, lengths, dA, dB


@pytest.mark.parametrize("with_known", [False, True])
def test_refine_splices(se_world, with_known):
    db, ji, ti, genome = se_world
    rng = np.random.default_rng(7 + with_known)
    codes, nmask, lengths, dA, dB = splice_pairs(genome, rng)
    jk = tk = None
    if with_known:
        don = np.array([12000, 30000, 20000], np.uint64)
        acc = np.array([12800, 31200, 21000], np.uint64)
        sense = np.array([1, 1, -1], np.int32)
        jk = JKnownSplicing.from_junctions(don, acc, sense).to_device()
        tk = known_to_device(KnownSplicing.from_junctions(don, acc, sense),
                             "cpu")
    want = jengine.refine_splices(ji, codes, nmask, lengths, dA, dB,
                                  known=jk)
    got = engine.refine_splices(
        ti, torch.from_numpy(codes), torch.from_numpy(nmask),
        torch.from_numpy(lengths), torch.from_numpy(dA.astype(np.int64)),
        torch.from_numpy(dB.astype(np.int64)), known=tk)
    for k in ("qstar", "nmm", "bonus", "sense", "valid"):
        same(got[k], want[k])
    # the tie row: every boundary costs 0 and carries no bonus, so the
    # first (q* = 1) wins
    assert (got["qstar"][-1] == 1).all() and (got["nmm"][-1] == 0).all()
    if with_known:
        assert (got["bonus"].numpy() >= 4.0).any()


def splice_end_rows(genome):
    """(aligned codes by row, rows) of find_splice_ends: unique qend and
    qstart residues, a tied one, a residue at no junction."""
    reads = [genome[12000 - 94:12000] + genome[12800:12806],
             genome[19995:20000] + genome[21000:21095],
             genome[30000 - 92:30000] + genome[30600:30608],
             genome[40000:40100]]
    starts = [12000 - 94, 21000 - 5, 30000 - 92, 40000]
    trims = [(0, 94), (5, 100), (0, 92), (0, 96)]
    codes = {i: dna.encode(s)[0] for i, s in enumerate(reads)}
    rows = [(i, a, tqs, tqe, 100, ("qstart", "qend"))
            for i, (a, (tqs, tqe)) in enumerate(zip(starts, trims))]
    return codes, rows


def test_find_splice_ends(se_world):
    db, ji, ti, genome = se_world
    codes, rows = splice_end_rows(genome)
    for max_intron in (10_000, 700):
        want = jse.find_splice_ends(db, ji, codes, rows, max_intron)
        got = se.find_splice_ends(db, ti, codes, rows, max_intron)
        assert got[0] == want[0]
        assert ({i: [dataclasses.asdict(a) for a in v]
                 for i, v in got[1].items()}
                == {i: [dataclasses.asdict(a) for a in v]
                    for i, v in want[1].items()})
        if max_intron == 10_000:
            assert set(got[0]) == {0, 1} and set(got[1]) == {2}


# ------------------------------------------------------------ the slice

@pytest.fixture(scope="module")
def fusion_world(tmp_path_factory):
    """tests/test_fusion.py's world: two 15 kb chromosomes and a
    breakpoint with no microhomology."""
    d = tmp_path_factory.mktemp("tfus")
    rng = np.random.default_rng(13)
    c1, c2 = rand_seq(rng, 15000), rand_seq(rng, 15000)
    (d / "g.fa").write_text(f">chr1\n{c1}\n>chr2\n{c2}\n")
    db = build_db(d / "g.fa", name="fus", k=13, interval=3)
    p2 = 7000
    while c1[4059] == c2[p2 - 1] or c2[p2] == c1[4060]:
        p2 += 1
    return db, JaxIndex.from_host(db), DeviceIndex.from_host(db, "cpu"), \
        c1, c2, p2


def fusion_read(c1, c2, p2, case):
    return {"cross": c1[4000:4060] + c2[p2:p2 + 40],
            "reverse": dna.revcomp(c1[4000:4060] + c2[p2:p2 + 40]),
            "no_flag": c1[4000:4060] + c2[p2:p2 + 40],
            "ordinary": c1[2000:2100],
            "inv_fwd_first": c1[5000:5050] + dna.revcomp(c1[8000:8050]),
            "inv_rc_first": dna.revcomp(c1[8000:8050]) + c1[5000:5050]}[case]


@pytest.mark.parametrize("case,lines", [
    ("cross", 2), ("reverse", 2), ("no_flag", 1), ("ordinary", 1),
    ("inv_fwd_first", 2), ("inv_rc_first", 2)])
def test_fusion_worlds(fusion_world, case, lines):
    db, ji, ti, c1, c2, p2 = fusion_world
    reads = [Record(case, "", fusion_read(c1, c2, p2, case))]
    kw = {} if case == "no_flag" else {"find_fusions": True}
    want = sam_text(jdriver.align_records(db, ji, reads, **kw))
    assert sam_text(driver.align_records(db, ti, reads, **kw)) == want
    assert want.count(b"\n") == lines


def test_fusion_batch_streamed(fusion_world):
    """All six reads in one batch, with novel splicing, streamed."""
    db, ji, ti, c1, c2, p2 = fusion_world
    reads = [Record(c, "", fusion_read(c1, c2, p2, c))
             for c in ("cross", "reverse", "ordinary", "inv_fwd_first",
                       "inv_rc_first")]
    outs = []
    for mod, index in ((jdriver, ji), (driver, ti)):
        chunks = []
        mod.align_records(db, index, reads, find_fusions=True,
                          novelsplicing=True, sink=chunks.append)
        outs.append(b"".join(chunks))
    assert outs[1] == outs[0] and outs[0].count(b"\n") == 8


def test_known_indel_rescue(tmp_path):
    """test_twopass's read with a 3-base deletion 3 bases from its end:
    only a learned site calls it (--indels-read)."""
    rng = np.random.default_rng(83)
    seq = rand_seq(rng, 6000)
    (tmp_path / "g.fa").write_text(">chr1\n" + seq + "\n")
    db = build_db(tmp_path / "g.fa", name="g", k=12, interval=3)
    p = 1500
    reads = [Record("kd", "", seq[p:p + 97] + seq[p + 100:p + 103]),
             Record("pl", "", seq[p + 900:p + 1000])]
    site = (np.array([p + 97], np.uint64), np.array([-3], np.int32),
            np.array([5], np.int64))
    want = sam_text(jdriver.align_records(db, JaxIndex.from_host(db), reads,
                                          known_indels=JKnownIndels(*site)))
    got = sam_text(driver.align_records(db, DeviceIndex.from_host(db, "cpu"),
                                        reads, known_indels=KnownIndels(*site)))
    assert got == want and b"3D" in want


def test_staged_splice_ends(se_world):
    """The splice-ends world's reads through the staged path, where
    find_splice_ends places the short residues."""
    db, ji, ti, genome = se_world
    reads = [Record(f"r{i}", "", s) for i, s in enumerate(
        [genome[12000 - 94:12000] + genome[12800:12806],
         genome[19995:20000] + genome[21000:21095],
         genome[30000 - 92:30000] + genome[30600:30608],
         genome[12000 - 60:12000] + genome[12800:12840]])]
    none = (np.zeros(0, np.uint64), np.zeros(0, np.int32),
            np.zeros(0, np.int64))
    want = sam_text(jdriver.align_records(
        db, ji, reads, novelsplicing=True, max_intron=10_000,
        known_indels=JKnownIndels(*none)))
    got = sam_text(driver.align_records(
        db, ti, reads, novelsplicing=True, max_intron=10_000,
        known_indels=KnownIndels(*none)))
    assert got == want
    assert b"94M800N6M" in want and b"XA:Z:" in want


@pytest.mark.parametrize("novel", [False, True])
def test_staged_pairs(tmp_path, novel):
    """tests/test_stream.py's pairs through the staged paired path
    (known_indels): the concordance reduction over the cascade's
    candidates, rescue and refine_unsolved."""
    db, _reads, _gfa = mixed_workload(tmp_path)
    pairs = stream_pairs(db)
    none = (np.zeros(0, np.uint64), np.zeros(0, np.int32),
            np.zeros(0, np.int64))
    want = [a.lines() + b.lines() for a, b in jpaired.align_paired_records(
        db, JaxIndex.from_host(db), pairs, jengine.AlignConfig(),
        pairmax=1000, novelsplicing=novel,
        known_indels=JKnownIndels(*none))]
    got = [a.lines() + b.lines() for a, b in paired.align_paired_records(
        db, DeviceIndex.from_host(db, "cpu"), pairs, engine.AlignConfig(),
        pairmax=1000, novelsplicing=novel, known_indels=KnownIndels(*none))]
    assert got == want and len(want) == len(pairs)
