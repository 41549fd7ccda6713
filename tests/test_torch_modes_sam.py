"""SAM of the port's alignment modes and SNP tolerance against tpumap's.

align_records and align_paired_records must give tpumap's bytes, in
list and sink modes: the reads of tests/test_modes.py's world as cmet,
atoi and ttoc libraries (both strands, substitutions, an N); cmet reads
of a repeated block with -n 3 (secondaries in the strand's space);
tests/test_snps.py's world with and without SNP tolerance (XW/XV);
cmet with novel splicing on the stream workload's spliced genome; cmet
and SNP-tolerant pairs; and gsnap_cli.main with --mode and -v, which
exits 2 on a database without a SNP index. tpumap runs once per
configuration (module fixtures).
"""
import io
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

from tpumap.gsnap import driver as jdriver
from tpumap.gsnap import engine as jengine
from tpumap.gsnap import paired as jpaired
from tpumap.index import build_db
from tpumap.index.device import DeviceIndex as JaxIndex
from tpumap.io.fasta import Record
from tpumap.utils import dna
from tpumap_torch.cli import gsnap_cli
from tpumap_torch.gsnap import driver, engine, paired
from tpumap_torch.index.device import DeviceIndex
from tpumap_torch.ops.mode import add_mode_index
from torch_workloads import (convert, mixed_workload, mode_pairs, mode_reads,
                             mode_world, sam_text, write_fasta)

torch.set_num_threads(1)
MODES = ["cmet-stranded", "atoi-stranded", "ttoc-stranded"]


def pair_text(pairs) -> bytes:
    return b"".join((a.lines() + b.lines()).encode() for a, b in pairs)


def port_sam(db, ti, recs, cfg, sink, pairs=False, **kw):
    fn = paired.align_paired_records if pairs else driver.align_records
    if not sink:
        out = fn(db, ti, recs, engine.AlignConfig(**cfg), **kw)
        return pair_text(out) if pairs else sam_text(out)
    chunks = []
    assert fn(db, ti, recs, engine.AlignConfig(**cfg), sink=chunks.append,
              **kw) == []
    return b"".join(bytes(c) for c in chunks)


def tpumap_sam(db, ji, recs, cfg, pairs=False, **kw):
    if pairs:
        return pair_text(jpaired.align_paired_records(
            db, ji, recs, jengine.AlignConfig(**cfg), **kw))
    return sam_text(jdriver.align_records(db, ji, recs,
                                          jengine.AlignConfig(**cfg), **kw))


# ------------------------------------------------------ the worlds

@pytest.fixture(scope="module")
def modes(tmp_path_factory):
    """test_modes' world; tpumap's SAM of each mode's reads, and of the
    cmet pairs and the SNP-carrying pairs with SNP tolerance."""
    db, seq, coords, alts = mode_world(tmp_path_factory.mktemp("tmsam"))
    ji = JaxIndex.from_host(db)
    reads = {m: mode_reads(seq, m, 40, 21 + i) for i, m in enumerate(MODES)}
    snp_reads = mode_reads(seq, None, 24, 31, snps=(coords, alts), name="s")
    want = {m: tpumap_sam(db, ji, reads[m], dict(mode=m)) for m in MODES}
    prs = mode_pairs(seq, "cmet-stranded", 24, 41)
    want["pairs"] = tpumap_sam(db, ji, prs, dict(mode="cmet-stranded"),
                               pairs=True, pairmax=1000)
    snp_pairs = [(a, Record(b.accession, "", dna.revcomp(a.sequence)))
                 for a, b in zip(snp_reads[0::2], snp_reads[1::2])]
    want["snp_pairs"] = tpumap_sam(db, ji, snp_pairs,
                                   dict(snp_tolerant=True), pairs=True,
                                   pairmax=1000)
    return db, DeviceIndex.from_host(db, "cpu"), reads, prs, snp_pairs, want


@pytest.mark.parametrize("sink", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_mode_reads_sam(modes, mode, sink):
    db, ti, reads, _prs, _sp, want = modes
    got = port_sam(db, ti, reads[mode], dict(mode=mode), sink)
    assert got == want[mode]
    lines = [ln.split("\t") for ln in got.decode().splitlines()]
    assert sum(not int(f[1]) & 4 for f in lines) >= 36
    assert {int(f[1]) & 16 for f in lines} == {0, 16}
    # conversions are matches in the strand's space (NM:i:0 on clean reads)
    assert sum("NM:i:0" in ln for ln in got.decode().splitlines()) >= 20


@pytest.mark.parametrize("sink", [False, True])
@pytest.mark.parametrize("run", ["pairs", "snp_pairs"])
def test_mode_and_snp_pairs_sam(modes, run, sink):
    """cmet pairs count conversions as mismatches in NM/MD (tpumap's pair
    emitters take no space); SNP-tolerant pairs."""
    db, ti, _reads, prs, snp_pairs, want = modes
    cfg = (dict(mode="cmet-stranded") if run == "pairs"
           else dict(snp_tolerant=True))
    got = port_sam(db, ti, prs if run == "pairs" else snp_pairs, cfg, sink,
                   pairs=True, pairmax=1000)
    assert got == want[run]
    flags = [int(ln.split("\t")[1]) for ln in got.decode().splitlines()]
    assert sum(f & 2 != 0 for f in flags) >= len(flags) // 2


@pytest.fixture(scope="module")
def repeats(tmp_path_factory):
    """A 400-bp block copied three times (test_torch_slice's repeats
    genome) with the ct/ga tables; cmet reads of the block multimap."""
    rng = np.random.default_rng(8)
    base = "".join("ACGT"[i] for i in rng.integers(0, 4, 30000))
    block = base[1000:1400]
    seq = base[:9000] + block + base[9400:20000] + block + base[20400:]
    root = tmp_path_factory.mktemp("tmrep")
    db = build_db(write_fasta(root / "g.fa", seq), name="g", k=12,
                  interval=3)
    for space in ("ct", "ga"):
        add_mode_index(db, space)
    reads = [Record(f"rep{i}", "", convert(
        block[10 * i:10 * i + 100] if i % 2 else
        dna.revcomp(block[10 * i:10 * i + 100]), "cmet-stranded"))
        for i in range(20)]
    cfg = dict(mode="cmet-stranded", top_k=4, max_occ=8)
    want = tpumap_sam(db, JaxIndex.from_host(db), reads, cfg, npaths=3,
                      batch_size=32)
    return db, reads, cfg, want, root


@pytest.mark.parametrize("sink", [False, True])
def test_cmet_secondaries_sam(repeats, sink):
    db, reads, cfg, want, _root = repeats
    got = port_sam(db, DeviceIndex.from_host(db, "cpu"), reads, cfg, sink, npaths=3,
                   batch_size=32)
    assert got == want and b"HI:i:2" in got


@pytest.fixture(scope="module")
def snps(tmp_path_factory):
    """tests/test_snps.py's world (20 kbp, k=13, 12 SNPs every 20 bp)
    and its reads, plus reads across the cluster; tpumap's SAM with and
    without SNP tolerance."""
    rng = np.random.default_rng(3)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 20000))
    root = tmp_path_factory.mktemp("tmsnp")
    db = build_db(write_fasta(root / "g.fa", seq), name="s", k=13,
                  interval=3)
    coords = np.arange(5000, 5240, 20, dtype=np.int64)
    code = {b: i for i, b in enumerate("ACGT")}
    alts = np.asarray([(code[seq[c]] + 1) % 4 for c in coords], np.uint8)
    db.add_snp_index(coords, alts)
    alt = list(seq[5000:5240])
    for c, a in zip(coords, alts):
        alt[c - 5000] = "ACGT"[a]
    alt = "".join(alt)
    recs = [Record("alt", "", alt), Record("ref", "", seq[5000:5240]),
            Record("alt1mm", "", "ACGT"[("ACGT".index(alt[105]) + 1) % 4]
                   .join([alt[:105], alt[106:]]))]
    recs += mode_reads(seq, None, 20, 51, snps=(coords, alts), name="s")
    ji = JaxIndex.from_host(db)
    want = {tol: tpumap_sam(db, ji, recs, dict(snp_tolerant=tol))
            for tol in (False, True)}
    return db, recs, want, root


@pytest.mark.parametrize("sink", [False, True])
@pytest.mark.parametrize("tol", [False, True])
def test_snp_world_sam(snps, tol, sink):
    db, recs, want, _root = snps
    got = port_sam(db, DeviceIndex.from_host(db, "cpu"), recs,
                   dict(snp_tolerant=tol), sink)
    assert got == want[tol]
    first = got.decode().splitlines()[0]
    assert ("XV:i:12" in first and "XW:i:0" in first) == tol


def test_cmet_novel_splicing_sam(tmp_path):
    """cmet with novel splicing: the chain stage runs in standard space,
    as tpumap's does; CpG-methylated conversions on both strands."""
    db, reads, _gfa = mixed_workload(tmp_path)
    for space in ("ct", "ga"):
        add_mode_index(db, space)
    recs = [Record(r.accession, "", convert(
        dna.revcomp(r.sequence) if i % 2 else r.sequence, "cmet-stranded",
        cpg=True), r.quality) for i, r in enumerate(reads)]
    cfg = dict(mode="cmet-stranded", top_k=4, max_occ=8)
    want = tpumap_sam(db, JaxIndex.from_host(db), recs, cfg,
                      novelsplicing=True, batch_size=32)
    ti = DeviceIndex.from_host(db, "cpu")
    for sink in (False, True):
        assert port_sam(db, ti, recs, cfg, sink, novelsplicing=True,
                        batch_size=32) == want
    # the chain stage compares in standard space, where the conversions
    # are mismatches: the spliced reads come out soft-clipped, not split
    cigars = [ln.split(b"\t")[5] for ln in want.splitlines()
              if ln.startswith(b"spl")]
    assert len(cigars) == 12 and not any(b"N" in c for c in cigars)
    assert sum(b"S" in c for c in cigars) >= 6


# ------------------------------------------------------ entry point

def run_main(argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = gsnap_cli.main(argv + ["-n", "1"])
    body = "".join(ln + "\n" for ln in out.getvalue().splitlines()
                   if not ln.startswith("@"))
    return rc, body.encode(), err.getvalue()


def test_main_mode_and_snps_cpu(repeats, snps):
    """--mode cmet-stranded on the repeats db and -v on the SNP db give
    tpumap's SAM; -v on a db without a SNP index exits 2."""
    db, reads, _cfg, _want, root = repeats
    db.save(str(root / "db"))
    (root / "r.fa").write_text("".join(f">{r.accession}\n{r.sequence}\n"
                                       for r in reads))
    rc, body, _ = run_main(["-D", str(root / "db"), str(root / "r.fa"),
                            "--device", "cpu", "--mode", "cmet-stranded"])
    assert rc == 0
    assert body == tpumap_sam(db, JaxIndex.from_host(db), reads,
                              dict(mode="cmet-stranded"))
    sdb, srecs, swant, sroot = snps
    sdb.save(str(sroot / "db"))
    (sroot / "r.fa").write_text("".join(f">{r.accession}\n{r.sequence}\n"
                                        for r in srecs))
    rc, body, _ = run_main(["-D", str(sroot / "db"), str(sroot / "r.fa"),
                            "--device", "cpu", "-v"])
    assert rc == 0 and body == swant[True]
    rc, body, err = run_main(["-D", str(root / "db"), str(root / "r.fa"),
                              "--device", "cpu", "-v"])
    assert rc == 2 and body == b""
    assert "-v requires a SNP-tolerant database" in err


def test_main_without_snp_db_exits_2(repeats):
    """The gsnap CLI module's exit code is main's: 2 for -v without a
    SNP index."""
    _db, _reads, _cfg, _want, root = repeats
    if not (root / "db" / "meta.json").exists():
        repeats[0].save(str(root / "db"))
    r = subprocess.run([sys.executable, "-m", "tpumap_torch.cli.gsnap_cli",
                        "-D", str(root / "db"), str(root / "missing.fa"),
                        "--device", "cpu", "-v"], capture_output=True,
                       timeout=300)
    assert r.returncode == 2, r.stderr.decode()[-2000:]
    assert b"tpumap-snpindex" in r.stderr
