"""The port's GMAP paths against tpumap's, JAX on the CPU and the port's
plain versions: exon chains field by field, output as bytes.

- stage 1: find_regions_bulk on test_stage1_regions' repeat world, and
  in cmet mode on a db with its ct and ga tables;
- align_cdna / align_cdna_both on the worlds of test_gmap_e2e (three
  exons, minus strand), test_gmap_stage3 (microexons, a clean intron,
  the chance-anchor zap, an indel cDNA) and test_gmap_mode;
- align_queries_bulk on the 80-exon query of test_gmap_e2e, on
  test_gmap_options' repetitive-region world, and on a world of 25 cDNAs
  on two chromosomes (both strands, a tandem-repeat query);
- gmap_cli.main against tpumap's on test_gmap_options' world: -f 1, 2,
  3, samse, the default (-n 5) and -n 1, -A, -S, -f 4, -x and -g, byte
  for byte but for the echoed command line (the port's has --device
  cpu); an option tpumap rejects, rejected alike.
"""
import io
from contextlib import redirect_stdout
from dataclasses import asdict

import numpy as np
import pytest
import torch

from test_gmap_mode import _world as mode_world
from test_gmap_stage3 import _genome_with_microexon
from tpumap.cli import gmap_cli as jcli
from tpumap.gmap import engine as jengine
from tpumap.gmap import stage1 as jstage1
from tpumap.index import build_db
from tpumap.index.device import DeviceIndex as JDeviceIndex
from tpumap.utils import dna
from tpumap_torch.cli import gmap_cli
from tpumap_torch.gmap import engine, stage1
from tpumap_torch.index.device import DeviceIndex
from torch_workloads import gmap_world

torch.set_num_threads(2)


def rand_genome(seed, n):
    rng = np.random.default_rng(seed)
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def chain_dict(c):
    return None if c is None else asdict(c)


def hits(res):
    return [None if h is None else (asdict(h[0]), h[1]) for h in res]


# ------------------------------------------------------------- stage 1

@pytest.fixture(scope="module")
def repeat_world(tmp_path_factory):
    """test_stage1_regions' world: a 6-exon gene over ~20 kb and a 60 bp
    repeat every 4 kb over 160 kb of a 200 kb genome (k = 12)."""
    root = tmp_path_factory.mktemp("s1")
    rng = np.random.default_rng(21)
    g = list("ACGT"[i] for i in rng.integers(0, 4, 200_000))
    gene = "".join("ACGT"[i] for i in rng.integers(0, 4, 360))
    for e, p in enumerate(5000 + 4000 * e for e in range(6)):
        g[p:p + 60] = list(gene[60 * e:60 * e + 60])
    rep = "".join("ACGT"[i] for i in rng.integers(0, 4, 60))
    for p in range(32_000, 192_000, 4000):
        g[p:p + 60] = list(rep)
    (root / "g.fa").write_text(">chr1\n" + "".join(g) + "\n")
    db = build_db(root / "g.fa", name="s1adv", k=12, interval=3)
    return db, gene, rep, "".join(g)


@pytest.mark.parametrize("cfg", [
    dict(maxtotallen=6000, sample_interval=1),
    dict(maxtotallen=25_000, sample_interval=1),
    dict(maxtotallen=5000, sample_interval=1, max_occ=64),
    dict(),
    dict(max_occ=64, keep_overabundant=True),
])
def test_find_regions_bulk(repeat_world, cfg):
    db, gene, rep, g = repeat_world
    queries = [dna.encode(s) for s in (gene, rep, dna.revcomp(gene),
                                       g[150_000:150_700], rep * 3)]
    want = jstage1.find_regions_bulk(JDeviceIndex.from_host(db), queries,
                                     jstage1.Stage1Config(**cfg))
    got = stage1.find_regions_bulk(DeviceIndex.from_host(db, "cpu"), queries,
                                   stage1.Stage1Config(**cfg))
    assert got == want and any(want)


def test_find_regions_bulk_cmet(tmp_path):
    """Stage 1's mode branch: converted cDNAs seed the plus rows in the
    ct space and the minus rows in the ga space, each against its mode
    table of the db."""
    rng = np.random.default_rng(31)
    g = "".join("ACGT"[i] for i in rng.integers(0, 4, 60_000))
    (tmp_path / "g.fa").write_text(">chr1\n" + g + "\n")
    db = build_db(tmp_path / "g.fa", name="cm", k=12, interval=3)
    db.add_mode_index("ct")
    db.add_mode_index("ga")
    gene = g[10_000:10_300] + g[12_000:12_250]
    queries = [dna.encode(s) for s in (
        gene.replace("C", "T"), dna.revcomp(gene).replace("C", "T"),
        g[40_000:40_400])]
    cfg = dict(mode="cmet-stranded")
    want = jstage1.find_regions_bulk(JDeviceIndex.from_host(db), queries,
                                     jstage1.Stage1Config(**cfg))
    got = stage1.find_regions_bulk(DeviceIndex.from_host(db, "cpu"), queries,
                                   stage1.Stage1Config(**cfg))
    assert got == want and all(want)


# ----------------------------------------------------- single regions

def three_exon():
    g = rand_genome(3, 12000)
    g = (g[:1180] + "GT" + g[1182:1998] + "AG" + g[2000:2250] + "GT"
         + g[2252:3998] + "AG" + g[4000:])
    return g, g[1000:1180] + g[2000:2250] + g[4000:4100]


def minus_strand():
    g = rand_genome(4, 6000)
    g = g[:1200] + "GT" + g[1202:2998] + "AG" + g[3000:]
    return g, dna.revcomp(g[1000:1200] + g[3000:3220])


def microexon(sense):
    micro = "TTACGGA" if sense else "CATGACCT"
    g = _genome_with_microexon(11 if sense else 12, micro, sense=sense)
    return g, g[1000:1200] + micro + g[3000:3200]


def clean_intron():
    g = rand_genome(13, 6000)
    e1, e2 = g[1000:1200], g[3000:3200]
    g = g[:1200] + "GT" + g[1202:2998] + "AG" + g[3000:]
    return g, e1 + e2


def zap():
    rng = np.random.default_rng(14)
    g = list("ACGT"[i] for i in rng.integers(0, 4, 40000))
    g[1197:1206] = list("CAGGTAAGT")
    g[29985:30001] = list("T" * 13 + "AGG")
    g = "".join(g)
    query = g[1000:1200] + g[30000:30200]
    return g[:15000] + query[197:205] + g[15008:], query


def indel_cdna():
    g = rand_genome(15, 8000)
    return g, g[1000:1200] + g[1203:1300] + "ACGT" + g[1300:1400]


def mode_case(seed, conv):
    g, q = mode_world(seed)
    return g, conv(q)


WORLDS = {
    "three_exon": (three_exon, "both", "standard"),
    "minus_strand": (minus_strand, "both", "standard"),
    "microexon_sense": (lambda: microexon(True), "plus", "standard"),
    "microexon_antisense": (lambda: microexon(False), "plus", "standard"),
    "clean_intron": (clean_intron, "plus", "standard"),
    "zap": (zap, "plus", "standard"),
    "indel_cdna": (indel_cdna, "plus", "standard"),
    "cmet_plus": (lambda: mode_case(21, lambda q: q.replace("C", "T")),
                  "both", "cmet-stranded"),
    "cmet_minus": (lambda: mode_case(
        22, lambda q: dna.revcomp(q).replace("C", "T")), "both",
        "cmet-stranded"),
    "atoi_plus": (lambda: mode_case(23, lambda q: q.replace("A", "G")),
                  "both", "atoi-stranded"),
    "standard_rejects_cmet": (lambda: mode_case(
        21, lambda q: q.replace("C", "T")), "both", "standard"),
}


@pytest.mark.parametrize("name", list(WORLDS))
def test_align_cdna_worlds(name):
    """align_cdna_both (both strands) or align_cdna (plus) of the port on
    the CPU gives tpumap's ExonChain, every field."""
    make, how, mode = WORLDS[name]
    g, q = make()
    qc, qn = dna.encode(q)
    gc, gn = dna.encode(g)
    if how == "both":
        want = jengine.align_cdna_both(qc, qn, gc, gn,
                                       jengine.GmapConfig(mode=mode))
        got = engine.align_cdna_both(qc, qn, gc, gn,
                                     engine.GmapConfig(mode=mode),
                                     device="cpu")
    else:
        want = jengine.align_cdna(qc, qn, gc, gn, jengine.GmapConfig())
        got = engine.align_cdna(qc, qn, gc, gn, engine.GmapConfig(),
                                device="cpu")
    assert chain_dict(got) == chain_dict(want)
    assert name == "standard_rejects_cmet" or len(got.exons) >= 1


def test_align_cdna_regions_and_pairs():
    """Several regions of one query in one pass (both orientations), as
    align_query_paths sends them."""
    g, q = three_exon()
    gm, qm = minus_strand()
    qc, qn = dna.encode(q)
    regions = []
    for seq, strand, off in ((g, 0, 0), (gm, 1, 50_000), (g[500:], 0, 500)):
        c, n = dna.encode(seq)
        regions.append((c, n.astype(bool), strand, off))
    want = jengine.align_cdna_regions(qc, qn, regions, jengine.GmapConfig())
    got = engine.align_cdna_regions(qc, qn, regions, engine.GmapConfig(),
                                    device="cpu")
    assert [chain_dict(c) for c in got] == [chain_dict(c) for c in want]


# ---------------------------------------------------------- bulk path

def test_bulk_80_exons(tmp_path):
    """test_gmap_e2e's 80-exon 8 kbp query (k = 13): one window of Rp =
    131,072 and S = 512 segments."""
    g = rand_genome(77, 300_000)
    (tmp_path / "g.fa").write_text(">chr1\n" + g + "\n")
    db = build_db(tmp_path / "g.fa", name="long", k=13, interval=3)
    q = "".join(g[5000 + 1100 * e:5100 + 1100 * e] for e in range(80))
    enc = [dna.encode(q)]
    want = jcli.align_queries_bulk(db, JDeviceIndex.from_host(db), enc)
    got = gmap_cli.align_queries_bulk(db, DeviceIndex.from_host(db, "cpu"),
                                      enc)
    assert hits(got) == hits(want)
    assert len(got[0][0].exons) == 80


def test_bulk_repetitive_fallback(tmp_path):
    """test_gmap_options' tandem-repeat world: every oligo overabundant,
    so only the keep_overabundant retry aligns the query."""
    rng = np.random.default_rng(71)
    unit = "".join("ACGT"[i] for i in rng.integers(0, 4, 31))
    flank1 = "".join("ACGT"[i] for i in rng.integers(0, 4, 3000))
    flank2 = "".join("ACGT"[i] for i in rng.integers(0, 4, 3000))
    genome = flank1 + unit * 200 + flank2
    (tmp_path / "g.fa").write_text(">chr1\n" + genome + "\n")
    db = build_db(tmp_path / "g.fa", name="rep", k=12, interval=3)
    enc = [dna.encode(genome[3000 + 31 * 5:3000 + 31 * 5 + 250])]
    want = jcli.align_queries_bulk(db, JDeviceIndex.from_host(db), enc)
    got = gmap_cli.align_queries_bulk(db, DeviceIndex.from_host(db, "cpu"),
                                      enc)
    assert hits(got) == hits(want)
    assert got[0][0].coverage >= 0.9 * 250


def test_bulk_world(tmp_path):
    db, recs, _qfa = gmap_world(tmp_path)
    enc = [dna.encode(r.sequence) for r in recs]
    want = jcli.align_queries_bulk(db, JDeviceIndex.from_host(db), enc)
    got = gmap_cli.align_queries_bulk(db, DeviceIndex.from_host(db, "cpu"),
                                      enc)
    assert hits(got) == hits(want)
    assert sum(h is not None for h in got) >= len(recs) - 1
    assert any(h[0].strand == 1 for h in got if h is not None)


def test_bulk_world_past_the_gap_table(tmp_path):
    """align_queries_bulk at max_intron = 10^8 (past K7a's gap-cost
    table on the card, queue 3 F1): tpumap's chains and -f 3 GFF3."""
    from tpumap.io import gff3 as jgff3
    from tpumap_torch.io import gff3

    db, recs, _qfa = gmap_world(tmp_path)
    enc = [dna.encode(r.sequence) for r in recs]
    want = jcli.align_queries_bulk(
        db, JDeviceIndex.from_host(db), enc,
        jengine.GmapConfig(max_intron=100_000_000))
    got = gmap_cli.align_queries_bulk(
        db, DeviceIndex.from_host(db, "cpu"), enc,
        engine.GmapConfig(max_intron=100_000_000))
    assert hits(got) == hits(want)

    def text(mod, res):
        out = []
        for rec, h in zip(recs, res):
            if h is not None:
                c, off = h
                ci = db.chrnum(off + c.exons[0].gstart)
                out.append(mod.match_cdna(
                    c, rec.accession, db.chrom_names[ci], "tpumap",
                    chrom_offset=off - int(db.chrom_offsets[ci]),
                    qlen=len(rec.sequence)))
        return "".join(out)
    assert text(gff3, got) == text(jgff3, want)
    assert sum(h is not None for h in got) >= len(recs) - 1


# ---------------------------------------------------------------- main

@pytest.fixture(scope="module")
def options_world(tmp_path_factory):
    """test_gmap_options' world (a 12 kb genome with a canonical intron,
    built by tpumap's build_cli), with its cDNA, the cDNA reverse
    complemented, and a query that aligns nowhere."""
    d = tmp_path_factory.mktemp("gopts")
    rng = np.random.default_rng(41)
    g = list("".join("ACGT"[i] for i in rng.integers(0, 4, 12000)))
    g[3080:3082] = "GT"
    g[3278:3280] = "AG"
    genome = "".join(g)
    (d / "g.fa").write_text(">chr1\n" + genome + "\n")
    cdna = genome[3000:3080] + genome[3280:3360]
    (d / "q.fa").write_text(f">q1\n{cdna}\n>q2 rc\n{dna.revcomp(cdna)}\n"
                            f">j\n{'AC' * 40}\n")
    from tpumap.cli.build_cli import main as build_main
    build_main(["-D", str(d), "-d", "g", "-k", "12", "-q", "3",
                str(d / "g.fa")])
    return d


def main_outputs(argv):
    """tpumap's main's stdout on argv, with the port's echoed command
    line, and the port's (--device cpu)."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        jcli.main(argv)
    want = buf.getvalue().replace("tpumap-gmap " + " ".join(argv),
                                  "tpumap-gmap " + " ".join(
                                      argv + ["--device", "cpu"]))
    buf = io.StringIO()
    with redirect_stdout(buf):
        gmap_cli.main(argv + ["--device", "cpu"])
    return want, buf.getvalue()


@pytest.mark.parametrize("fmt", [["-f", "1"], ["-f", "2"], ["-f", "3"],
                                 ["-f", "samse"], [], ["-n", "1"]])
def test_main_matches_tpumap(options_world, fmt):
    """The default -n 5 (tpumap's per-query path) and -n 1 (the bulk
    path) give tpumap's bytes."""
    d = options_world
    want, got = main_outputs(["-D", str(d / "g"), "-d", "g", *fmt,
                              str(d / "q.fa")])
    assert got == want
    assert want.count("q1") >= 1 and "q2" in want


@pytest.mark.parametrize("argv", [["-n", "5"], ["-A"], ["-S"], ["-f", "4"],
                                  ["--chimera-margin", "30"],
                                  ["-g", "g.fa"]])
def test_main_unported_options_raise(options_world, argv):
    """Options past the bulk path (-n 5, -A, -S, -f 4, chimeras, a
    genomic segment): tpumap's bytes (tests/test_torch_gmap_cli.py holds
    every other option to tpumap's)."""
    d = options_world
    argv = [str(d / a) if a.endswith(".fa") else a for a in argv]
    want, got = main_outputs(argv + ["-D", str(d / "g"), str(d / "q.fa")])
    assert got == want and "q1" in want


@pytest.mark.parametrize("argv", [["-f", "5"], ["--no-such-option"],
                                  ["-I", "3"]])
def test_main_rejects_what_tpumap_rejects(options_world, argv, capsys):
    """An option tpumap's parser rejects makes both mains exit with
    argparse's usage error."""
    d = options_world
    codes = []
    for main in (jcli.main, gmap_cli.main):
        with pytest.raises(SystemExit) as e:
            main(argv + ["-D", str(d / "g"), str(d / "q.fa"), "--device",
                         "cpu"] if main is gmap_cli.main else
                 argv + ["-D", str(d / "g"), str(d / "q.fa")])
        codes.append(e.value.code)
    assert codes == [2, 2]
    assert capsys.readouterr().err.count("error:") == 2


def test_main_needs_the_card_unless_asked(options_world, monkeypatch):
    d = options_world
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        gmap_cli.main(["-D", str(d / "g"), str(d / "q.fa")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.align_cdna(*dna.encode("ACGT" * 40),
                          *dna.encode("ACGT" * 100))
