"""The port's two-pass alignment against tpumap's (JAX on the CPU):
junction and insert-length harvesting from SAM records, the learned
KnownSplicing and KnownIndels tables (and their dump/load round trip),
and two_pass_align on the world of tests/test_twopass.py, where a
junction learned from a well-anchored read rescues one whose second
anchor is too short to seed: the records byte for byte, the tables
equal.
"""
import numpy as np
import pytest
import torch

from tpumap.gsnap import twopass as jtwopass
from tpumap.gsnap.knownindels import KnownIndels as JKnownIndels
from tpumap.gsnap.knownsplicing import KnownSplicing as JKnownSplicing
from tpumap.index import build_db
from tpumap.index.device import DeviceIndex as JaxIndex
from tpumap.io.fasta import Record
from tpumap.io.sam import SamRecord as JSamRecord
from tpumap_torch.gsnap import driver, twopass
from tpumap_torch.gsnap.knownindels import KnownIndels
from tpumap_torch.gsnap.knownsplicing import KnownSplicing
from tpumap_torch.index.device import DeviceIndex
from tpumap_torch.io.sam import SamRecord
from torch_workloads import sam_text

torch.set_num_threads(2)
E1, E2, EXLEN = 5000, 60000, 50
SITES = ("donor", "acceptor", "antidonor", "antiacceptor", "junctions",
         "anti_junctions")


class _FakeDB:
    chrom_names = ["chr1", "chr2"]
    chrom_offsets = np.asarray([0, 30000, 60000], dtype=np.uint64)


RECS = [("a", 0, "chr1", 101, 30, "50M200N50M", ["XS:A:+"], 0),
        ("b", 16, "chr1", 101, 30, "50M200N50M", ["XS:A:+"], 0),
        ("c", 0, "chr2", 11, 30, "10M5D20M100N70M", ["XS:A:-"], 0),
        ("d", 4, "*", 0, 0, "*", [], 0),
        ("e", 0, "chr1", 500, 30, "100M", [], 0),
        ("f", 99, "chr1", 1, 30, "50M2I48M", [], 300),
        ("f", 147, "chr1", 201, 30, "100M", [], -300),
        ("g", 99, "chr1", 96, 30, "55M3D45M", [], 500),
        ("h", 0, "chr2", 40, 30, "30M300N70M", ["XS:A:?"], 0)]


def records(cls):
    return [cls(q, f, r, p, m, c, tags=list(t), tlen=tl)
            for q, f, r, p, m, c, t, tl in RECS]


def same_arrays(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def same_tables(ks, jks):
    for f in SITES:
        same_arrays(getattr(ks, f), getattr(jks, f))


@pytest.mark.parametrize("min_support", [1, 2])
def test_harvest(min_support):
    """junctions_from_sam, learn_knownsplicing, KnownIndels.from_sam and
    analyze_insertlengths on the same records."""
    got = twopass.junctions_from_sam(_FakeDB(), records(SamRecord),
                                     min_support)
    want = jtwopass.junctions_from_sam(_FakeDB(), records(JSamRecord),
                                       min_support)
    for g, w in zip(got, want):
        same_arrays(g, w)
    same_tables(twopass.learn_knownsplicing(_FakeDB(), records(SamRecord),
                                            min_support),
                jtwopass.learn_knownsplicing(_FakeDB(),
                                             records(JSamRecord),
                                             min_support))
    ki = KnownIndels.from_sam(_FakeDB(), records(SamRecord), min_support)
    jki = JKnownIndels.from_sam(_FakeDB(), records(JSamRecord), min_support)
    for f in ("coords", "lengths", "counts"):
        same_arrays(getattr(ki, f), getattr(jki, f))
    for lo, hi in ((150, 151), (0, 100), (140, 160), (30000, 40000)):
        assert ki.any_in(lo, hi) == jki.any_in(lo, hi)
        assert ki.near(lo) == jki.near(lo)
    assert (twopass.analyze_insertlengths(records(SamRecord))
            == jtwopass.analyze_insertlengths(records(JSamRecord)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """tests/test_twopass.py's world: an intron longer than the salvage
    window whose boundary ties without knowledge."""
    d = tmp_path_factory.mktemp("ttp")
    rng = np.random.default_rng(7)
    g = list("ACGT"[i] for i in rng.integers(0, 4, 80000))
    g[E2 - 1] = g[E1 + EXLEN - 1]
    g[E1 + EXLEN] = "A"
    g[E1 + EXLEN + 1] = "A"
    g[E2 - 3] = "T"
    g[E2 - 2] = "T"
    seq = "".join(g)
    (d / "g.fa").write_text(">chr1\n" + seq + "\n")
    db = build_db(d / "g.fa", name="tp", k=13, interval=3)
    return db, seq


def test_two_pass_align(world, tmp_path):
    """Pass 1 (fused) learns the junction and any indels; pass 2 (the
    staged path, with the learned tables) rescues the short-anchor read;
    the tables dump and load back, and drive the same rescue."""
    db, seq = world
    p = 30000
    reads = [Record("t", "", seq[E1 + 10:E1 + EXLEN] + seq[E2:E2 + 60]),
             Record("s", "", seq[E1 + 12:E1 + EXLEN] + seq[E2:E2 + 12]),
             Record("d", "", seq[p:p + 50] + seq[p + 53:p + 103]),
             Record("u", "", seq[p + 500:p + 600])]
    out = []
    for mod, index, sub in (
            (jtwopass, JaxIndex.from_host(db), "j"),
            (twopass, DeviceIndex.from_host(db, "cpu"), "t")):
        recs, ks = mod.two_pass_align(
            db, index, reads, batch_size=64,
            splices_dump=str(tmp_path / f"sp{sub}"),
            indels_dump=str(tmp_path / f"in{sub}"))
        out.append((sam_text(recs), ks))
    (want, jks), (got, ks) = out
    assert got == want
    same_tables(ks, jks)
    assert len(ks.junctions) == 1 and b"54950N" in want and b"3D" in want
    ks2 = KnownSplicing.load(str(tmp_path / "spt.npz"))
    same_tables(ks2, JKnownSplicing.load(str(tmp_path / "spj.npz")))
    ki = KnownIndels.load(str(tmp_path / "int"))
    jki = JKnownIndels.load(str(tmp_path / "inj"))
    for f in ("coords", "lengths", "counts"):
        same_arrays(getattr(ki, f), getattr(jki, f))
    assert ki.nsites == 1
    again = sam_text(driver.align_records(
        db, DeviceIndex.from_host(db, "cpu"), reads[1:2], known=ks2,
        known_indels=ki, novelsplicing=True, batch_size=64))
    assert again == b"".join(ln + b"\n" for ln in want.splitlines()
                             if ln.startswith(b"s\t"))
