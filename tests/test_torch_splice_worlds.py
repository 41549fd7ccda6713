"""The port's RNA path against tpumap (JAX on CPU) on the splice worlds
of tests/test_spliceends.py, tests/test_salvage_recall.py and
tests/test_localscan.py.

Each world's genome is one chromosome of a shared index and its reads
run through align_records(novelsplicing=True) in one batch, so tpumap
compiles one program; the port's SAM, in list and sink modes, must be
byte-identical to tpumap's for every world's reads.
"""
import numpy as np
import pytest
import torch

from tpumap.gsnap import driver as jdriver
from tpumap.gsnap import engine as jengine
from tpumap.index import build_db
from tpumap.index.device import DeviceIndex as JaxIndex
from tpumap.io.fasta import Record
from tpumap.utils import dna
from tpumap_torch.gsnap import driver, engine
from tpumap_torch.index.device import DeviceIndex
from torch_workloads import sam_text

torch.set_num_threads(1)
MAX_INTRON = 60_000       # covers every world's introns (50 kbp the longest)
EXLEN = 88


def spliceends_world():
    """Unique short residues on both read ends, tied acceptors (XA:Z:),
    a clean read, a noncanonical boundary tie and a canonical one under
    microhomology."""
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
    s = "".join(g)
    bad = ("GT", "GC", "AT", "CT")
    bad_a = ("AG", "AC", "GC", "AT")
    e1 = next(p for p in range(40050, 40800)
              if all(s[q:q + 2] not in bad for q in range(p - 4, p + 3)))
    e2 = next(p for p in range(42000, 42800)
              if all(s[q - 2:q] not in bad_a for q in range(p - 4, p + 3)))
    return s, [s[12000 - 94:12000] + s[12800:12806],
               s[19995:20000] + s[21000:21095],
               s[30000 - 92:30000] + s[30600:30608],
               s[5000:5100],
               s[e1 - 88:e1 - 1] + s[e2 - 1] + s[e2:e2 + 12],
               s[12000 - 88:12000] + s[12800:12812]]


def salvage_world():
    """Short tail exons of 13, 10 and 7 bases over eight GT..AG introns."""
    rng = np.random.default_rng(7)
    g = list("ACGT"[i] for i in rng.integers(0, 4, 60_000))
    introns = []
    for a in range(15_000, 55_000, 5_000):
        b = a + 1_500
        g[a], g[a + 1], g[b - 2], g[b - 1] = "G", "T", "A", "G"
        introns.append((a, b))
    s = "".join(g)
    reads = []
    for m in (13, 10, 7):
        for k in range(8):
            a, b = introns[(m + k) % len(introns)]
            reads.append(s[a - (100 - m):a] + s[b:b + m])
    return s, reads


def localscan_world(past_32k: bool):
    """12-bp suffix and prefix exons found by the window scans, and a
    reverse-strand read; past_32k puts the second exon 50 kbp away."""
    if past_32k:
        rng = np.random.default_rng(31)
        g = list("".join("ACGT"[i] for i in rng.integers(0, 4, 80000)))
        e1, e2 = 4000, 54100
        g[e1 + EXLEN:e1 + EXLEN + 2] = "GT"
        g[e2 - 2:e2] = "AG"
        s = "".join(g)
    else:
        rng = np.random.default_rng(29)
        s = "".join("ACGT"[i] for i in rng.integers(0, 4, 40000))
        e1, e2 = 4000, 9000
    return s, [s[e1:e1 + EXLEN] + s[e2:e2 + 12],
               s[e1 + EXLEN - 12:e1 + EXLEN] + s[e2:e2 + EXLEN],
               dna.revcomp(s[e1:e1 + EXLEN] + s[e2:e2 + 12])]


WORLDS = {"spliceends": spliceends_world, "salvage": salvage_world,
          "localscan": lambda: localscan_world(False),
          "localscan_past_32k": lambda: localscan_world(True)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The shared index, tpumap's SAM lines and the port's (list and
    sink) per world."""
    fa = tmp_path_factory.mktemp("tworlds") / "g.fa"
    reads, owner, text = [], [], []
    for name, make in WORLDS.items():
        seq, rs = make()
        text.append(f">{name}\n{seq}\n")
        reads += [Record(f"{name}{i}", "", r) for i, r in enumerate(rs)]
        owner += [name] * len(rs)
    fa.write_text("".join(text))
    db = build_db(fa, name="worlds", k=13, interval=3)
    kw = dict(novelsplicing=True, max_intron=MAX_INTRON, batch_size=64)
    want = sam_text(jdriver.align_records(db, JaxIndex.from_host(db), reads,
                                          jengine.AlignConfig(), **kw))
    ti = DeviceIndex.from_host(db, "cpu")
    got = sam_text(driver.align_records(db, ti, reads, engine.AlignConfig(),
                                        **kw))
    chunks = []
    driver.align_records(db, ti, reads, engine.AlignConfig(),
                         sink=chunks.append, **kw)

    def by_world(blob):
        lines = blob.decode().splitlines()
        assert len(lines) == len(reads)
        out = {}
        for w, ln in zip(owner, lines):
            out.setdefault(w, []).append(ln)
        return out

    return by_world(want), {False: by_world(got),
                            True: by_world(b"".join(bytes(c)
                                                    for c in chunks))}


@pytest.mark.parametrize("sink", [False, True])
@pytest.mark.parametrize("world", list(WORLDS))
def test_world_sam_identical(runs, world, sink):
    want, got = runs
    assert got[sink][world] == want[world]
    cigars = [ln.split("\t")[5] for ln in want[world]]
    if world == "spliceends":
        assert cigars[0] == "94M800N6M"
        assert "XA:Z:" in want[world][2] and cigars[2].endswith("S")
        assert "N" not in cigars[4]              # the tie demoted
    elif world == "salvage":
        assert sum("1500N" in c for c in cigars) >= 12
    else:
        gap = 54100 - 4000 - EXLEN if world.endswith("32k") else 9000 - 4000 \
            - EXLEN
        assert all(f"{gap}N" in c for c in cigars)
