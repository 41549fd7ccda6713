"""align_records' computation options through the port against tpumap
(JAX on the CPU), SAM byte for byte, each case through both paths: the
fused ladder, and the staged path, which both packages take when given
a KnownIndels (here an empty one, so it changes nothing but the path;
tpumap driver.py:1434-1437).

The worlds are those of tpumap's own tests: test_circular (reads across
a circular chromosome's origin), test_computation_options (-Z, -Y,
--indel-endlength, --query-unk-mismatch, FASTQ-quality MAPQ and
--merge-distant-samechr), test_indels and test_splice (with
use_localdb=False and a max_intron under the intron), test_default_flags
at npaths=100 in list and sink mode, and one read in each length bucket
from 150 to 600 bases (driver.pad_to_bucket).
"""
import numpy as np
import pytest
import torch

from tpumap.gsnap import driver as jdriver
from tpumap.gsnap import engine as jengine
from tpumap.gsnap.knownindels import KnownIndels as JKnownIndels
from tpumap.index import build_db
from tpumap.index.device import DeviceIndex as JaxIndex
from tpumap.io.fasta import Record
from tpumap_torch.gsnap import driver, engine
from tpumap_torch.gsnap.knownindels import KnownIndels
from tpumap_torch.index.device import DeviceIndex
from torch_workloads import sam_text

torch.set_num_threads(2)
PATHS = ("fused", "staged")


def rand_seq(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def no_indels(cls):
    return cls(np.zeros(0, np.uint64), np.zeros(0, np.int32),
               np.zeros(0, np.int64))


def both(db, reads, path, cfg=None, **kw):
    """tpumap's and the port's SAM of one align_records call (list mode,
    or with sink=True the streamed bytes), on the given path."""
    ji, ti = JaxIndex.from_host(db), DeviceIndex.from_host(db, "cpu")
    sink = kw.pop("sink", False)
    jkw, tkw = dict(kw), dict(kw)
    if path == "staged":
        jkw["known_indels"] = no_indels(JKnownIndels)
        tkw["known_indels"] = no_indels(KnownIndels)
    jcfg = jengine.AlignConfig(**(cfg or {}))
    tcfg = engine.AlignConfig(**(cfg or {}))
    if sink:
        outs = []
        for mod, index, cfg_, kws in ((jdriver, ji, jcfg, jkw),
                                      (driver, ti, tcfg, tkw)):
            chunks = []
            mod.align_records(db, index, reads, cfg_, sink=chunks.append,
                              **kws)
            outs.append(b"".join(chunks))
        return outs
    return (sam_text(jdriver.align_records(db, ji, reads, jcfg, **jkw)),
            sam_text(driver.align_records(db, ti, reads, tcfg, **tkw)))


@pytest.fixture(scope="module")
def circ(tmp_path_factory):
    """test_circular's world: a linear chromosome and a circular one."""
    d = tmp_path_factory.mktemp("tcirc")
    rng = np.random.default_rng(43)
    lin, c = rand_seq(rng, 12000), rand_seq(rng, 5000)
    (d / "g.fa").write_text(f">lin\n{lin}\n>plasmid\n{c}\n")
    db = build_db(d / "g.fa", name="c", k=13, interval=3,
                  circular={"plasmid"})
    return db, [Record("o", "", c[-60:] + c[:40]),
                Record("w", "", c[100:200]),
                Record("l", "", lin[2000:2100])]


@pytest.fixture(scope="module")
def knobs(tmp_path_factory):
    """test_computation_options' world (a 20 kb chromosome)."""
    d = tmp_path_factory.mktemp("tknobs")
    seq = rand_seq(np.random.default_rng(23), 20000)
    (d / "g.fa").write_text(">chr1\n" + seq + "\n")
    return build_db(d / "g.fa", name="g", k=12, interval=3), seq, d


def knob_reads(seq, option):
    p = 3000
    if option == "deletion":            # a 12-base deletion
        return [Record("d12", "", seq[p:p + 50] + seq[p + 62:p + 112])]
    if option == "insertion":           # a 7-base insertion
        return [Record("i7", "", seq[p:p + 50] + "ACGTACG"
                       + seq[p + 50:p + 93])]
    if option == "end_deletion":        # a deletion 3 bases from the end
        return [Record("de", "", seq[p:p + 97] + seq[p + 100:p + 103])]
    s = list(seq[5000:5080])            # 12 Ns scattered
    for k in range(0, 60, 5):
        s[k] = "N"
    return [Record("nn", "", "".join(s))]


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("option,kw,cfg", [
    ("deletion", {}, None), ("deletion", {"max_deletions": 20}, None),
    ("insertion", {}, None), ("insertion", {"max_insertions": 8}, None),
    ("end_deletion", {}, None), ("end_deletion", {"indel_endlength": 2},
                                 None),
    ("unk", {}, {"query_unk_mismatch": True}),
    ("unk", {}, {"query_unk_mismatch": False})])
def test_indel_and_unknown_base_options(knobs, option, kw, cfg, path):
    db, seq, _d = knobs
    want, got = both(db, knob_reads(seq, option), path, cfg, **kw)
    assert got == want and want.count(b"\n") == 1


@pytest.mark.parametrize("path", PATHS)
def test_circular_origin(circ, path):
    db, reads = circ
    want, got = both(db, reads, path)
    assert got == want and b"plasmid\t4941\t" in want


@pytest.mark.parametrize("path", PATHS)
def test_quality_weighted_mapq(knobs, tmp_path, path):
    """test_computation_options' near-duplicate genome; the same read
    with its mismatches on low and on high qualities, and as FASTA."""
    _db, seq, _d = knobs
    p = 7000
    dup = list(seq[p:p + 100])
    dup[40] = "ACGT"[("ACGT".index(dup[40]) + 1) % 4]
    (tmp_path / "g.fa").write_text(
        ">chr1\n" + seq + "TTTT" + "".join(dup) + seq[:500] + "\n")
    db = build_db(tmp_path / "g.fa", name="g", k=12, interval=3)
    s = list(seq[p:p + 100])
    for j in (20, 60):
        s[j] = "ACGT"[("ACGT".index(s[j]) + 1) % 4]
    read = "".join(s)

    def qual(low):
        q = ["5"] * 100
        for j in (20, 60):
            q[j] = "#" if low else "I"
        return "".join(q)
    reads = [Record("lo", "", read, qual(True)),
             Record("hi", "", read, qual(False))]
    want, got = both(db, reads, path)
    assert got == want
    want, got = both(db, [Record("fa", "", read)], path)
    assert got == want


@pytest.mark.parametrize("path", PATHS)
def test_merge_distant_samechr(knobs, path):
    """A 15,000-base colinear split past max_intron: primary and
    supplementary records, or one N line with merge_distant_samechr
    (fusions take the staged path in both packages either way)."""
    db, seq, _d = knobs
    reads = [Record("m1", "", seq[1000:1060] + seq[16000:16040])]
    for merge in (False, True):
        want, got = both(db, reads, path, find_fusions=True,
                         max_intron=5000, merge_distant_samechr=merge)
        assert got == want
        assert want.count(b"\n") == (1 if merge else 2)


@pytest.fixture(scope="module")
def indel_world(tmp_path_factory):
    """test_indels' world: 30 reads with 3-base deletions, 2-base
    insertions or none, every other one reverse-complemented."""
    d = tmp_path_factory.mktemp("tindel")
    rng = np.random.default_rng(77)
    seq = rand_seq(rng, 30000)
    (d / "g.fa").write_text(">chr1\n" + seq + "\n")
    comp = str.maketrans("ACGT", "TGCA")
    recs = []
    for r in range(30):
        p = int(rng.integers(0, len(seq) - 120))
        kind = r % 3
        if kind == 1:
            s = list(seq[p:p + 103])
            del s[40:43]
        elif kind == 2:
            s = list(seq[p:p + 98])
            s[50:50] = ["A", "C"]
        else:
            s = list(seq[p:p + 100])
        s = "".join(s[:100])
        if r % 2 == 0:
            s = s.translate(comp)[::-1]
        recs.append(Record(f"r{r}_{kind}", "", s))
    return build_db(d / "g.fa", name="g", k=12, interval=3), recs


@pytest.fixture(scope="module")
def splice_world(tmp_path_factory):
    """test_splice's world: 20 reads across a 1,000-base GT..AG intron."""
    d = tmp_path_factory.mktemp("tsplice")
    rng = np.random.default_rng(99)
    seq = rand_seq(rng, 50000)
    seq = seq[:10000] + "GT" + seq[10002:10998] + "AG" + seq[11000:]
    (d / "g.fa").write_text(">chr1\n" + seq + "\n")
    comp = str.maketrans("ACGT", "TGCA")
    recs = []
    for r in range(20):
        split = int(rng.integers(20, 80))
        s = seq[10000 - split:10000] + seq[11000:11000 + 100 - split]
        if r % 2 == 0:
            s = s.translate(comp)[::-1]
        recs.append(Record(f"s{r}_{split}", "", s))
    return build_db(d / "g.fa", name="g", k=12, interval=3), recs


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("world,kw", [
    ("indel", {}),
    ("indel", {"novelsplicing": True, "use_localdb": False,
               "max_intron": 500}),
    ("splice", {"novelsplicing": True}),
    ("splice", {"novelsplicing": True, "use_localdb": False}),
    ("splice", {"novelsplicing": True, "max_intron": 500})])
def test_indel_and_splice_worlds(indel_world, splice_world, world, kw, path):
    db, recs = indel_world if world == "indel" else splice_world
    want, got = both(db, recs, path, **kw)
    assert got == want and want.count(b"\n") == len(recs)
    if world == "splice" and kw.get("max_intron") is None:
        assert want.count(b"1000N") == len(recs)


@pytest.fixture(scope="module")
def defaults_world(tmp_path_factory):
    """test_default_flags' world: a 2 kb segment duplicated, 30 unique
    reads and 10 from the duplicated segment (two loci each)."""
    root = tmp_path_factory.mktemp("tdefaults")
    rng = np.random.default_rng(99)
    seq = rand_seq(rng, 40_000)
    dup_src, dup_dst = 5_000, 25_000
    seq = seq[:dup_dst] + seq[dup_src:dup_src + 2_000] + seq[dup_dst + 2_000:]
    (root / "genome.fa").write_text(">chr1\n" + "\n".join(
        seq[i:i + 60] for i in range(0, len(seq), 60)) + "\n")
    reads = []
    for r in range(30):
        p = int(rng.integers(0, 20_000 - 150))
        if dup_src - 150 < p < dup_src + 2_000:
            p = 2_500 + r
        reads.append(Record(f"u{r}", "", seq[p:p + 150]))
    for r in range(10):
        p = dup_src + 100 + 170 * r
        reads.append(Record(f"m{r}", "", seq[p:p + 150]))
    return build_db(root / "genome.fa", name="g", k=13, interval=3), reads


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("sink", [False, True])
def test_default_flags_npaths(defaults_world, sink, path):
    """npaths=100: list mode carries the ten multimappers' secondaries;
    sink mode drops them in both packages (copied behaviour, ROADMAP
    queue 3)."""
    db, reads = defaults_world
    want, got = both(db, reads, path, npaths=100, sink=sink)
    assert got == want
    assert want.count(b"\n") == (40 if sink else 50)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("length", [150, 180, 250, 300, 500, 600])
def test_length_buckets(knobs, length, path):
    """One read a length bucket (160, 192, 256, 384, 512, 1024 bases of
    batch row), each with a substitution and a 2-base deletion."""
    _db, seq, d = knobs
    db = build_db(d / "g.fa", name="g", k=12, interval=3)
    p = 2000 + length
    s = list(seq[p:p + length // 2] + seq[p + length // 2 + 2:
                                          p + length + 2])
    s[length // 4] = "ACGT"[("ACGT".index(s[length // 4]) + 1) % 4]
    want, got = both(db, [Record(f"b{length}", "", "".join(s))], path)
    assert got == want and want.count(b"\n") == 1
