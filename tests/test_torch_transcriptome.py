"""The port's transcriptome-guided path against tpumap's (JAX on the
CPU): the genes map IIT builder (io/iit.py: parse_map_fasta,
build_iit), the Transcriptome over it (build_transcriptome, the
transcript db, map_to_genome, save/load), the transcriptome rung
(align_records(tr=...)) on the world of tests/test_transcriptome.py,
and the remap tags (gsnap/remap.py: XX/XY) single-end and paired on the
worlds of tests/test_remap.py: equal values, SAM byte for byte.
"""
import io

import numpy as np
import pytest
import torch

from tpumap.gsnap import driver as jdriver
from tpumap.gsnap import paired as jpaired
from tpumap.gsnap import remap as jremap
from tpumap.gsnap import transcriptome as jtranscriptome
from tpumap.index import build_db
from tpumap.index.device import DeviceIndex as JaxIndex
from tpumap.io import iit as jiit
from tpumap.io.fasta import Record
from tpumap.utils import dna
from tpumap_torch.gsnap import driver, paired, remap, transcriptome
from tpumap_torch.index.device import DeviceIndex
from tpumap_torch.io import iit
from torch_workloads import sam_text

torch.set_num_threads(2)

PLUS_EXONS = [(2001, 2100), (5001, 5080), (9001, 9120)]
MINUS_EXONS = [(22000, 21901), (18000, 17921)]
GENES = "\n".join(
    [">TRP chr1:2001..9120 gene", "GENEP NM_P"]
    + [f"{s} {e}" for s, e in PLUS_EXONS]
    + [">TRM chr1:22000..17921 gene", "GENEM NM_M"]
    + [f"{s} {e}" for s, e in MINUS_EXONS]) + "\n"


def rand_seq(seed, n):
    rng = np.random.default_rng(seed)
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """tests/test_transcriptome.py's world: a plus gene of three exons
    and a minus gene of two on a 30 kb chromosome; each package's
    Transcriptome (k = 10, interval 1) over its own genes IIT."""
    d = tmp_path_factory.mktemp("ttr")
    seq = rand_seq(11, 30000)
    (d / "g.fa").write_text(">chr1\n" + seq + "\n")
    db = build_db(d / "g.fa", name="trg", k=12, interval=3)
    jtr = jtranscriptome.build_transcriptome(
        db, jiit.build_iit(jiit.parse_map_fasta(io.StringIO(GENES))),
        name="tr", k=10, interval=1)
    ttr = transcriptome.build_transcriptome(
        db, iit.build_iit(iit.parse_map_fasta(io.StringIO(GENES))),
        name="tr", k=10, interval=1)
    return db, seq, jtr, ttr


@pytest.mark.parametrize("text", [
    GENES,
    ">a chrX:10..20 t1 rest of header\nann\n>b chr2:40..30\n"
    ">c 5..9\nx\ny\n>chr10\nACGTACGT\n",
    ">u 1..5\n>v 9..3 t\n"])
def test_build_iit(text):
    """The builder's intervals, divisions in chromosome order, types,
    labels, annotations and rest-of-header lines."""
    want = jiit.build_iit(jiit.parse_map_fasta(io.StringIO(text)))
    got = iit.build_iit(iit.parse_map_fasta(io.StringIO(text)))
    for f in ("version", "divs", "typestrings", "labels", "annotations",
              "restofheaders", "divsort"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.total_nintervals == want.total_nintervals
    for i in range(1, want.total_nintervals + 1):
        assert got.interval(i) == want.interval(i)
    for g, w in zip(got.divdata, want.divdata):
        for f in ("lows", "highs", "signs", "types"):
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_transcriptome_tables(world, tmp_path):
    db, seq, jtr, ttr = world
    for f in ("genome_name", "labels", "genes"):
        assert getattr(ttr, f) == getattr(jtr, f)
    for f in ("chrnum", "strand", "exon_offsets", "exonbounds",
              "exonstarts", "exonlens"):
        a, b = getattr(ttr, f), getattr(jtr, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    n = int(jtr.trdb.genome_length)
    assert ttr.trdb.get_seq(0, n) == jtr.trdb.get_seq(0, n)
    assert np.array_equal(ttr.trdb.offsets, jtr.trdb.offsets)
    assert np.array_equal(ttr.trdb.positions, jtr.trdb.positions)
    for trnum, start, length in ((0, 90, 40), (0, 95, 90), (1, 95, 15),
                                 (1, 0, 180)):
        assert ttr.map_to_genome(trnum, start, length) == \
            jtr.map_to_genome(trnum, start, length)
    ttr.save(str(tmp_path / "trdir"))
    back = transcriptome.Transcriptome.load(str(tmp_path / "trdir"))
    assert back.labels == ttr.labels
    assert back.map_to_genome(0, 90, 40) == jtr.map_to_genome(0, 90, 40)


def tr_reads(seq):
    tp = "".join(seq[s - 1:e] for s, e in PLUS_EXONS)
    tm = "".join(dna.revcomp(seq[e - 1:s]) for s, e in MINUS_EXONS)
    return [Record("rp", "", tp[60:160]), Record("rp3", "", tp[85:285]),
            Record("rm", "", tm[60:160]),
            Record("rmrc", "", dna.revcomp(tm[60:160])),
            Record("gen", "", seq[12000:12100]),
            Record("unm", "", rand_seq(5, 100))]


@pytest.mark.parametrize("novel", [False, True])
def test_tr_rung(world, novel):
    """Reads across one, two and three exons of both genes, a genomic
    read and an unmapped one: the rung's multi-exon records (XG, XS) and
    the XX/XY remap tags on every mapped record."""
    db, seq, jtr, ttr = world
    reads = tr_reads(seq)
    want = sam_text(jdriver.align_records(
        db, JaxIndex.from_host(db), reads, novelsplicing=novel,
        tr=(jtr, JaxIndex.from_host(jtr.trdb))))
    got = sam_text(driver.align_records(
        db, DeviceIndex.from_host(db, "cpu"), reads, novelsplicing=novel,
        tr=(ttr, DeviceIndex.from_host(ttr.trdb, "cpu"))))
    assert got == want
    assert b"40M2900N60M" in want and b"XG:Z:TRP" in want
    assert b"XX:Z:TRP" in want


def test_remap_single(tmp_path):
    """tests/test_remap.py's single-end e2e: a spliced read gets its
    XX tag, a genomic one none."""
    seq = rand_seq(29, 20000)
    (tmp_path / "g.fa").write_text(">chr1\n" + seq + "\n")
    db = build_db(tmp_path / "g.fa", name="rg", k=12, interval=3)
    genes = (">TRX chr1:2001..9120 gene\nGENEX NM_X\n"
             "2001 2100\n5001 5080\n9001 9120\n")
    tseq = seq[2000:2100] + seq[5000:5080] + seq[9000:9120]
    reads = [Record("spliced", "", tseq[60:160]),
             Record("genomic", "", seq[12000:12100]),
             Record("intronic", "", seq[2050:2150])]
    jtr = jtranscriptome.build_transcriptome(
        db, jiit.build_iit(jiit.parse_map_fasta(io.StringIO(genes))),
        name="tr", k=10, interval=1)
    ttr = transcriptome.build_transcriptome(
        db, iit.build_iit(iit.parse_map_fasta(io.StringIO(genes))),
        name="tr", k=10, interval=1)
    outs = [sam_text(jdriver.align_records(
                db, JaxIndex.from_host(db), reads,
                tr=(jtr, JaxIndex.from_host(jtr.trdb)))),
            sam_text(driver.align_records(
                db, DeviceIndex.from_host(db, "cpu"), reads,
                tr=(ttr, DeviceIndex.from_host(ttr.trdb, "cpu"))))]
    assert outs[1] == outs[0]
    assert b"XX:Z:TRX:61..160:S:.1s|s2." in outs[0]


def test_remap_paired(tmp_path):
    """tests/test_remap.py's paired e2e: ends in different exons of one
    transcript get the joint S velocity (the staged paired path; the
    transcript index is not read there)."""
    seq = rand_seq(33, 30000)
    (tmp_path / "g.fa").write_text(">chr1\n" + seq + "\n")
    db = build_db(tmp_path / "g.fa", name="pg", k=12, interval=3)
    genes = (">TRQ chr1:2001..9400 gene\nGENEQ NM_Q\n"
             "2001 2400\n9001 9400\n")
    pairs = [(Record("q0", "", seq[2100:2200]),
              Record("q0", "", dna.revcomp(seq[9100:9200]))),
             (Record("q1", "", seq[2150:2250]),
              Record("q1", "", dna.revcomp(seq[2300:2400]))),
             (Record("q2", "", seq[15000:15100]),
              Record("q2", "", dna.revcomp(seq[15300:15400])))]
    jtr = jtranscriptome.build_transcriptome(
        db, jiit.build_iit(jiit.parse_map_fasta(io.StringIO(genes))),
        name="tr", k=10, interval=1)
    ttr = transcriptome.build_transcriptome(
        db, iit.build_iit(iit.parse_map_fasta(io.StringIO(genes))),
        name="tr", k=10, interval=1)
    want = [a.lines() + b.lines() for a, b in jpaired.align_paired_records(
        db, JaxIndex.from_host(db), pairs, pairmax=10000, tr=(jtr, None))]
    got = [a.lines() + b.lines() for a, b in paired.align_paired_records(
        db, DeviceIndex.from_host(db, "cpu"), pairs, pairmax=10000,
        tr=(ttr, None))]
    assert got == want
    assert "XX:Z:TRQ:101..200:S:.1." in want[0]


@pytest.mark.parametrize("segs", [
    [(2010, 2050)], [(1050, 1100), (2000, 2040)], [(1050, 1130)],
    [(990, 1030)], [(2070, 2085), (3000, 3020)], [(5010, 5050)]])
def test_remapper(segs):
    """TranscriptRemapper.remap and the tags on a hand-made plus gene
    and minus gene (tests/test_remap.py's tables)."""
    def tables(mod):
        return [mod.Transcriptome(
            trdb=None, genome_name="g", labels=["TRP", "TRM"],
            genes=["GP", "GM"], chrnum=np.array([0, 0], np.int32),
            strand=np.array([1, -1], np.int8),
            exon_offsets=np.array([0, 3, 5], np.int64),
            exonbounds=np.array([100, 180, 280, 50, 150], np.int64),
            exonstarts=np.array([1000, 2000, 3000, 6049, 5099], np.uint64),
            exonlens=np.array([100, 80, 100, 50, 100], np.int64))]
    jr = jremap.TranscriptRemapper(tables(jtranscriptome)[0])
    tr_ = remap.TranscriptRemapper(tables(transcriptome)[0])
    jv, jinv = jr.remap(segs)
    tv, tinv = tr_.remap(segs)
    assert remap.xx_tags(tv, tinv) == jremap.xx_tags(jv, jinv)
    assert [h.exon_string() for h in tv] == [h.exon_string() for h in jv]
