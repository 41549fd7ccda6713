"""GMAP as users run it: the port's gmap CLI against tpumap's, JAX on the
CPU and the port's plain versions.

Function level, value for value and string for string:
- align_query_paths (npaths 1, 3 and 5; test_chimera's duplicated-locus
  world and the cDNAs of torch_workloads.gmap_world) and
  align_query_to_db;
- align_query_chimera, breakpoint and refine_breakpoint on test_chimera's
  two-chromosome world and its exon-exon world;
- alignfmt.print_alignment, continuous_fmt, continuous_by_exon_body and
  coords_fmt on a plus and a minus chain, invertmode 0, 1 and 2;
- the SAM options (apply_sam_options, extended_cigar, strip_zero_m) and
  the IIT range queries (get, div_index).

main, byte for byte but for the echoed command line (the port's ends
in --device cpu): one parametrised test whose cases are argument lists
over the worlds of test_gmap_options, test_chimera, test_invertmode,
test_gmap_mode and gmap_world, with the files that --failed-input and
--split-output write compared too; and an option neither parser takes.
"""
import dataclasses
import io
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from test_gmap_mode import _world as mode_world
from tpumap.cli import gmap_cli as jcli
from tpumap.cli.build_cli import main as build_main
from tpumap.cli.iit_cli import store_main
from tpumap.gmap import chimera as jchimera
from tpumap.gmap import engine as jengine
from tpumap.gmap import stage1 as jstage1
from tpumap.gmap import translation as jtranslation
from tpumap.index import GenomeDB as JGenomeDB
from tpumap.index import build_db
from tpumap.index.device import DeviceIndex as JDeviceIndex
from tpumap.io import alignfmt as jalignfmt
from tpumap.io import iit as jiit
from tpumap.io import sam as jsam
from tpumap.utils import dna
from tpumap_torch.cli import gmap_cli
from tpumap_torch.gmap import chimera, engine, stage1, translation
from tpumap_torch.index.build import GenomeDB
from tpumap_torch.index.device import DeviceIndex
from tpumap_torch.io import alignfmt, iit, sam
from torch_workloads import gmap_world

torch.set_num_threads(2)


def rand_seq(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def paths_of(res):
    return [(dataclasses.asdict(c), o) for c, o in res]


@pytest.fixture(autouse=True)
def reset_translation():
    """main sets the genetic code and the alternate starts of both
    packages' translation tables; every test starts and ends with the
    standard ones."""
    for mod in (translation, jtranslation):
        mod.set_translation_code(1)
        mod.set_alt_start_codons(False)
    yield
    for mod in (translation, jtranslation):
        mod.set_translation_code(1)
        mod.set_alt_start_codons(False)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world of the main cases, built once by tpumap and saved:
    test_gmap_options' 12 kb genome with a canonical intron (its cDNA,
    the cDNA reverse complemented, a query that aligns nowhere; built by
    tpumap's build_cli), gmap_world's 25 cDNAs on two chromosomes,
    test_chimera's duplicated locus and two-chromosome chimera, a map
    and a splice-site IIT written by tpumap, and test_gmap_mode's
    world as a genomic FASTA and a bisulfite cDNA."""
    d = tmp_path_factory.mktemp("gcli")
    rng = np.random.default_rng(41)
    g = list(rand_seq(rng, 12000))
    g[3080:3082] = "GT"
    g[3278:3280] = "AG"
    genome = "".join(g)
    (d / "g.fa").write_text(">chr1\n" + genome + "\n")
    cdna = genome[3000:3080] + genome[3280:3360]
    (d / "q.fa").write_text(f">q1\n{cdna}\n>q2 rc\n{dna.revcomp(cdna)}\n"
                            f">j\n{'AC' * 40}\n")
    build_main(["-D", str(d), "-d", "g", "-k", "12", "-q", "3",
                str(d / "g.fa")])
    (d / "gw").mkdir()
    gdb, _recs, gq = gmap_world(d / "gw")
    gdb.save(str(d / "gw" / "db"))
    # test_chimera's worlds
    rng = np.random.default_rng(17)
    c1, c2 = rand_seq(rng, 20000), rand_seq(rng, 20000)
    (d / "chim.fa").write_text(f">chr1\n{c1}\n>chr2\n{c2}\n")
    build_db(d / "chim.fa", name="chim", k=12, interval=3).save(
        str(d / "chim"))
    (d / "chimq.fa").write_text(
        f">chimeric\n{c1[3000:3100] + c1[5000:5100] + c2[8000:8120]}\n"
        f">spliced\n{c1[3000:3100] + c1[5000:5100]}\n"
        f">inverted\n{c1[6000:6150] + dna.revcomp(c2[12000:12130])}\n"
        f">none\n{'GT' * 50}\n")
    (d / "dup.fa").write_text(">chr1\n" + c1[:15000] + c1[3000:3400]
                              + c1[15400:] + "\n")
    build_db(d / "dup.fa", name="dup", k=12, interval=3).save(str(d / "dup"))
    (d / "dupq.fa").write_text(f">q\n{c1[3000:3400]}\n>r\n"
                               f"{dna.revcomp(c1[9000:9300])}\n")
    (d / "map.src").write_text(">gene1 chr1:3001..3360 t\nannot\n"
                               ">gene2 chr1:3100..3200 t\n"
                               ">gene3 chr1:2000..2500 u\n"
                               ">gene4 chr1:5000..4400 t\n"
                               ">gene5 chr1:9000..9500 t\n")
    with redirect_stdout(io.StringIO()):
        store_main(["-o", str(d / "mymap"), str(d / "map.src")])
    sites = "".join(
        f">i{i} chr{1 + (i % 2)}:{a}..{a + 300}\n"
        for i, a in enumerate(range(2000, 60000, 2500)))
    jiit.build_iit(jiit.parse_map_fasta(io.StringIO(sites))).write(
        str(d / "sp.iit"))
    mg, mq = mode_world(21)
    (d / "mg.fa").write_text(">m\n" + mg + "\n")
    (d / "mq.fa").write_text(f">bis\n{mq.replace('C', 'T')}\n>bisrc\n"
                             f"{dna.revcomp(mq).replace('C', 'T')}\n")
    return {"D": str(d / "g"), "Q": str(d / "q.fa"), "G": str(d / "g.fa"),
            "GWD": str(d / "gw" / "db"), "GWQ": str(gq),
            "CHD": str(d / "chim"), "CHQ": str(d / "chimq.fa"),
            "DUPD": str(d / "dup"), "DUPQ": str(d / "dupq.fa"),
            "MAP": str(d / "mymap.iit"), "SP": str(d / "sp.iit"),
            "MG": str(d / "mg.fa"), "MQ": str(d / "mq.fa"),
            "GSEQ": genome[3000:3400], "CSEQ": cdna,
            "SELF": f">s\n{genome[100:400]}\n",
            "PAIR": f">g\n{genome[3000:3400]}\n>c\n{cdna}\n"}


def run_main(main, argv, stdin=None):
    """(return value, stdout) of one main run, stdin given as text."""
    buf = io.StringIO()
    old = sys.stdin
    try:
        if stdin is not None:
            sys.stdin = io.StringIO(stdin)
        with redirect_stdout(buf):
            rc = main(argv)
    finally:
        sys.stdin = old
    return rc, buf.getvalue()


def assert_main_parity(argv, stdin=None, tmp_path=None):
    """tpumap's main and the port's (--device cpu) on argv: the same
    return value and stdout but for the echoed command line; "{OUT}" in
    argv names each package's own output directory, whose files must
    match too. Returns tpumap's stdout and files."""
    def args_for(pkg):
        if tmp_path is None:
            return list(argv)
        (tmp_path / pkg).mkdir(exist_ok=True)
        return [a.replace("{OUT}", str(tmp_path / pkg)) for a in argv]
    jargv, targv = args_for("j"), args_for("t") + ["--device", "cpu"]
    jrc, want = run_main(jcli.main, jargv, stdin)
    trc, got = run_main(gmap_cli.main, targv, stdin)
    assert trc == jrc
    assert got == want.replace("tpumap-gmap " + " ".join(jargv),
                               "tpumap-gmap " + " ".join(targv))
    if tmp_path is not None:
        jfiles = sorted(p.name for p in (tmp_path / "j").iterdir())
        assert jfiles == sorted(p.name for p in (tmp_path / "t").iterdir())
        for name in jfiles:
            text = (tmp_path / "j" / name).read_text()
            assert (tmp_path / "t" / name).read_text() == text, name
            want += text
    return want


# --------------------------------------------------- per-query paths

@pytest.fixture(scope="module")
def gw(tmp_path_factory):
    """gmap_world by tpumap, with both packages' indexes on the CPU."""
    db, recs, _qfa = gmap_world(tmp_path_factory.mktemp("gwq"))
    return (db, JDeviceIndex.from_host(db), DeviceIndex.from_host(db, "cpu"),
            [dna.encode(r.sequence) for r in recs])


@pytest.mark.parametrize("npaths", [1, 3, 5])
def test_align_query_paths_world(gw, npaths):
    """Every cDNA of gmap_world (both strands, a tandem-repeat query)."""
    db, jindex, tindex, enc = gw
    n_multi = 0
    for qc, qn in enc:
        want = jcli.align_query_paths(db, jindex, qc, qn, npaths=npaths)
        got = gmap_cli.align_query_paths(db, tindex, qc, qn, npaths=npaths)
        assert paths_of(got) == paths_of(want)
        n_multi += len(got) > 1
    assert npaths > 1 or n_multi == 0


@pytest.mark.parametrize("npaths", [1, 3, 5])
def test_align_query_paths_duplicated_locus(tmp_path, npaths):
    """test_gmap_npaths' world: a cDNA whose locus is duplicated 12 kb
    away reports both placements from npaths 2 on; --strand and
    --chrsubset filters too."""
    rng = np.random.default_rng(17)
    c1 = rand_seq(rng, 20000)
    (tmp_path / "g.fa").write_text(
        ">chr1\n" + c1[:15000] + c1[3000:3400] + c1[15400:] + "\n")
    db = build_db(tmp_path / "g.fa", name="dup", k=12, interval=3)
    jindex, tindex = JDeviceIndex.from_host(db), DeviceIndex.from_host(
        db, "cpu")
    for q, kw in ((c1[3000:3400], {}), (dna.revcomp(c1[3000:3400]), {}),
                  (c1[3000:3400], dict(strand=1)),
                  (c1[3000:3400], dict(chr_range=(0, 10_000)))):
        qc, qn = dna.encode(q)
        want = jcli.align_query_paths(db, jindex, qc, qn, npaths=npaths,
                                      **kw)
        got = gmap_cli.align_query_paths(db, tindex, qc, qn, npaths=npaths,
                                         **kw)
        assert paths_of(got) == paths_of(want)
        if not kw:
            assert len(got) == min(npaths, 2)


def test_align_query_to_db(gw):
    db, jindex, tindex, enc = gw
    for qc, qn in enc[:8] + [dna.encode("GT" * 60)]:
        jc, jo = jcli.align_query_to_db(db, jindex, qc, qn)
        tc, to = gmap_cli.align_query_to_db(db, tindex, qc, qn)
        assert (to, None if tc is None else dataclasses.asdict(tc)) == (
            jo, None if jc is None else dataclasses.asdict(jc))


# ----------------------------------------------------------- chimeras

@pytest.fixture(scope="module")
def chim(tmp_path_factory):
    """test_chimera's world: two random 20 kb chromosomes."""
    d = tmp_path_factory.mktemp("chim")
    rng = np.random.default_rng(17)
    c1, c2 = rand_seq(rng, 20000), rand_seq(rng, 20000)
    (d / "g.fa").write_text(f">chr1\n{c1}\n>chr2\n{c2}\n")
    db = build_db(d / "g.fa", name="chim", k=12, interval=3)
    return db, JDeviceIndex.from_host(db), DeviceIndex.from_host(db, "cpu"), \
        c1, c2


def exonexon_world(tmp_path):
    """test_exonexon_breakpoint_refinement's genome: a strong donor at
    the end of a chr1 exon and the same bases before a chr2 exon, so
    microhomology blurs the join."""
    rng = np.random.default_rng(99)
    g1 = list(rand_seq(rng, 20000))
    g2 = list(rand_seq(rng, 20000))
    g1[4997:5000] = list("CAG")
    g1[5000:5006] = list("GTAAGT")
    g2[7974:7994] = list("T" * 20)
    g2[7994:8000] = g1[4994:5000]
    g2[8000:8006] = g1[5000:5006]
    s1, s2 = "".join(g1), "".join(g2)
    (tmp_path / "g.fa").write_text(f">chr1\n{s1}\n>chr2\n{s2}\n")
    db = build_db(tmp_path / "g.fa", name="ee", k=12, interval=3)
    return db, s1[4940:5000] + s2[8000:8060]


def chimera_queries(c1, c2):
    return [c1[3000:3100] + c1[5000:5100] + c2[8000:8120],
            c1[3000:3100] + c1[5000:5100],
            c2[2000:2090] + c1[11000:11200],
            c1[6000:6150] + dna.revcomp(c2[12000:12130]),
            dna.revcomp(c1[3000:3100] + c2[8000:8120]),
            "GT" * 50]


@pytest.mark.parametrize("margin", [30, 60])
def test_align_query_chimera(chim, margin):
    """Pieces, breakpoints and the exon-exon refinement of each query,
    chimeric on one or both strands or not at all."""
    db, jindex, tindex, c1, c2 = chim
    n_two = 0
    for q in chimera_queries(c1, c2):
        qc, qn = dna.encode(q)
        want = jchimera.align_query_chimera(
            db, jindex, qc, qn, jengine.GmapConfig(), jstage1.Stage1Config(),
            chimera_margin=margin)
        got = chimera.align_query_chimera(
            db, tindex, qc, qn, engine.GmapConfig(), stage1.Stage1Config(),
            chimera_margin=margin)
        assert paths_of(got) == paths_of(want)
        assert chimera.breakpoint(got, len(q)) == jchimera.breakpoint(
            want, len(q))
        n_two += len(got) == 2
        if len(got) == 2:
            assert chimera.refine_breakpoint(db, got, len(q), qcodes=qc) == \
                jchimera.refine_breakpoint(db, want, len(q), qcodes=qc)
            assert chimera.refine_breakpoint(db, got, len(q)) == \
                jchimera.refine_breakpoint(db, want, len(q))
    assert n_two >= 3


def test_chimera_exonexon_refinement(tmp_path):
    db, q = exonexon_world(tmp_path)
    qc, qn = dna.encode(q)
    want = jchimera.align_query_chimera(
        db, JDeviceIndex.from_host(db), qc, qn, jengine.GmapConfig(),
        jstage1.Stage1Config(), chimera_margin=30)
    got = chimera.align_query_chimera(
        db, DeviceIndex.from_host(db, "cpu"), qc, qn, engine.GmapConfig(),
        stage1.Stage1Config(), chimera_margin=30)
    assert paths_of(got) == paths_of(want) and len(got) == 2
    found = chimera.refine_breakpoint(db, got, len(q))
    assert found == jchimera.refine_breakpoint(db, want, len(q))
    assert found[0] == 59


# ----------------------------------------------------- alignment text

def display_chains():
    """(name, genome, cDNA) of a plus-strand chain with an intron and a
    minus-strand one (test_invertmode's world), and one with an indel."""
    rng = np.random.default_rng(41)
    g = list(rand_seq(rng, 12000))
    g[3080:3082] = "GT"
    g[3278:3280] = "AG"
    g = "".join(g)
    rng = np.random.default_rng(17)
    m = list(rand_seq(rng, 6000))
    m[2080:2082] = "GT"
    m[2278:2280] = "AG"
    m = "".join(m)
    rng = np.random.default_rng(15)
    n = rand_seq(rng, 8000)
    return [("plus", g, g[3000:3080] + g[3280:3360]),
            ("minus", m, dna.revcomp(m[2000:2080] + m[2280:2360])),
            ("indel", n, n[1000:1200] + n[1203:1300] + "ACGT" + n[1300:1400])]


@pytest.mark.parametrize("case", ["plus", "minus", "indel"])
@pytest.mark.parametrize("invertmode", [0, 1, 2])
def test_alignment_text(case, invertmode):
    """print_alignment (-A, -S, its options), continuous_fmt (-3),
    continuous_by_exon_body (-4) and coords_fmt (-f 9) of the port on
    its own chain equal tpumap's on tpumap's chain."""
    _name, g, q = next(c for c in display_chains() if c[0] == case)
    qc, qn = dna.encode(q)
    gc, gn = dna.encode(g)
    jc = jengine.align_cdna_both(qc, qn, gc, gn, jengine.GmapConfig())
    tc = engine.align_cdna_both(qc, qn, gc, gn, engine.GmapConfig(),
                                device="cpu")
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.strand == (case == "minus")
    aligned = dna.revcomp_codes(qc) if tc.strand else qc
    kws = [dict(invertmode=invertmode),
           dict(invertmode=invertmode, summary_only=True, chrname="chr1"),
           dict(invertmode=invertmode, wraplength=60, nomargin=True,
                nolengths=True, ngap=5),
           dict(invertmode=invertmode, fulllength=True, genome_offset=1000),
           dict(invertmode=invertmode, cdsstart=2)]
    for kw in kws:
        want = jalignfmt.print_alignment(case, jc, aligned, gc, len(qc), **kw)
        assert alignfmt.print_alignment(case, tc, aligned, gc, len(qc),
                                        **kw) == want
    assert alignfmt.continuous_fmt(case, tc, aligned, gc, len(qc),
                                   genome_offset=7,
                                   invertmode=invertmode) == \
        jalignfmt.continuous_fmt(case, jc, aligned, gc, len(qc),
                                 genome_offset=7, invertmode=invertmode)
    assert alignfmt.continuous_by_exon_body(
        tc, aligned, gc, len(qc), invertmode=invertmode) == \
        jalignfmt.continuous_by_exon_body(jc, aligned, gc, len(qc),
                                          invertmode=invertmode)
    assert alignfmt.coords_fmt(case, tc, aligned, gc, len(qc),
                               genome_offset=invertmode) == \
        jalignfmt.coords_fmt(case, jc, aligned, gc, len(qc),
                             genome_offset=invertmode)


@pytest.mark.parametrize("code,alt", [(2, False), (1, True), (6, True)])
def test_alignment_text_translation(code, alt):
    """The aa rows read translation._ACTIVE: --translation-code and
    --alt-start-codons reach both packages' alignment text alike."""
    _name, g, q = display_chains()[0]
    qc, qn = dna.encode(q)
    gc, gn = dna.encode(g)
    chain = engine.align_cdna_both(qc, qn, gc, gn, engine.GmapConfig(),
                                   device="cpu")
    jchain = jengine.align_cdna_both(qc, qn, gc, gn, jengine.GmapConfig())
    for mod in (translation, jtranslation):
        mod.set_translation_code(code)
        mod.set_alt_start_codons(alt)
    assert alignfmt.print_alignment("p", chain, qc, gc, len(qc)) == \
        jalignfmt.print_alignment("p", jchain, qc, gc, len(qc))


# ------------------------------------------------- SAM options, IIT

def test_sam_options_match():
    cases = [("10M2D5M3I4M", "3A6^TC5C3G3"), ("5S20M", "20"),
             ("0M10M0M", "10"), ("12M1000N8M", "4T7G7"), ("*", ""),
             ("8=2X", "8A0C")]
    for cigar, md in cases:
        assert sam.extended_cigar(cigar, md) == jsam.extended_cigar(cigar, md)
        assert sam.strip_zero_m(cigar) == jsam.strip_zero_m(cigar)
    for opts in (dict(extended_cigar_p=True), dict(use_0m=False),
                 dict(force_xs_dir=True), dict(sparse_secondaries=True),
                 dict(multiple_primaries=True),
                 dict(cigar_action="noprint")):
        recs = []
        for mod in (sam, jsam):
            sec = mod.SamRecord("r", 256, "chr1", 9, 0, "0M10M", seq="A" * 10,
                                qual="I" * 10, tags=["NM:i:1", "MD:Z:3A6",
                                                     "XS:A:?"])
            rec = mod.SamRecord("r", 0, "chr1", 5, 30, "4M1000N6M",
                                seq="ACGTACGTAC" + "A", qual="I" * 11,
                                tags=["NM:i:1", "MD:Z:3A6", "XS:A:?"],
                                secondaries=[sec])
            mod.apply_sam_options(rec, **opts)
            recs.append(rec.lines())
        assert recs[0] == recs[1]


def test_iit_queries_match(worlds):
    ti, ji = iit.IIT.read(worlds["MAP"]), jiit.IIT.read(worlds["MAP"])
    for div in ("chr1", "chr2", ""):
        assert ti.div_index(div) == ji.div_index(div)
        for x, y in ((1, 12000), (3050, 3150), (4500, 4600), (9600, 9700),
                     (3360, 3360)):
            assert np.array_equal(ti.get(div, x, y), ji.get(div, x, y))
    assert len(ti.get("chr1", 3050, 3150)) == 2


# -------------------------------------------------------------- main

MAIN_CASES = {
    # the default path (-n 5), the bulk path, -n 3, chimeras
    "default": (["-D", "{GWD}", "{GWQ}"], None),
    "n1": (["-n", "1", "-D", "{GWD}", "{GWQ}"], None),
    "n3_dup": (["-n", "3", "-f", "1", "-D", "{DUPD}", "{DUPQ}"], None),
    "n5_dup": (["-f", "3", "-D", "{DUPD}", "{DUPQ}"], None),
    "x30_f1": (["-x", "30", "-f", "1", "-D", "{CHD}", "{CHQ}"], None),
    "x30_f3": (["-x", "30", "-f", "3", "-D", "{CHD}", "{CHQ}"], None),
    # the text formats
    "A": (["-A", "-D", "{GWD}", "{GWQ}"], None),
    "S": (["-S", "-D", "{GWD}", "{GWQ}"], None),
    "3": (["-3", "-D", "{GWD}", "{GWQ}"], None),
    "4": (["-4", "-D", "{D}", "{Q}"], None),
    "E_cdna": (["-E", "cdna", "-D", "{D}", "{Q}"], None),
    "E_genomic": (["-E", "genomic", "-D", "{D}", "{Q}"], None),
    "E_cdna+introns": (["-E", "cdna+introns", "-D", "{D}", "{Q}"], None),
    "E_genomic+introns": (["-E", "genomic+introns", "-D", "{D}", "{Q}"],
                          None),
    "P": (["-P", "-D", "{GWD}", "{GWQ}"], None),
    "Q": (["-Q", "-D", "{D}", "{Q}"], None),
    # -f
    "f4": (["-f", "4", "-D", "{GWD}", "{GWQ}"], None),
    "f6": (["-f", "6", "-D", "{GWD}", "{GWQ}"], None),
    "f_introns": (["-f", "introns", "-D", "{GWD}", "{GWQ}"], None),
    "f7": (["-f", "7", "-D", "{D}", "{Q}"], None),
    "f8": (["-f", "8", "-D", "{D}", "{Q}"], None),
    "f9": (["-f", "9", "-D", "{D}", "{Q}"], None),
    "f_samse": (["-f", "samse", "-D", "{GWD}", "{GWQ}"], None),
    "f_sampe": (["-f", "sampe", "-D", "{D}", "{Q}"], None),
    "f_bedpe": (["-f", "bedpe", "-D", "{D}", "{Q}"], None),
    # one genomic sequence
    "g": (["-g", "{G}", "-S", "{Q}"], None),
    "cmdline": (["-A", "--cmdline", "{GSEQ}", "{CSEQ}"], None),
    "selfalign": (["-S", "-1"], "SELF"),
    "pairalign": (["-A", "-2"], "PAIR"),
    "cmet_g": (["--mode", "cmet-stranded", "-S", "-g", "{MG}", "{MQ}"],
               None),
    # computation options
    "nosplicing": (["--nosplicing", "-S", "-D", "{D}", "{Q}"], None),
    "min_intronlength": (["--min-intronlength", "300", "-S", "-D", "{D}",
                          "{Q}"], None),
    "max_deletionlength": (["--max-deletionlength", "250", "-S", "-D",
                            "{D}", "{Q}"], None),
    "strand_plus": (["--strand", "plus", "-D", "{GWD}", "{GWQ}"], None),
    "strand_minus": (["--strand", "minus", "-S", "-D", "{D}", "{Q}"], None),
    "z_sense_force": (["-z", "sense_force", "-D", "{GWD}", "{GWQ}"], None),
    "z_antisense_force": (["-z", "antisense_force", "-D", "{GWD}",
                           "{GWQ}"], None),
    "z_sense_filter": (["-z", "sense_filter", "-S", "-D", "{D}", "{Q}"],
                       None),
    "z_antisense_filter": (["-z", "antisense_filter", "-S", "-D", "{D}",
                            "{Q}"], None),
    "require_splicedir": (["--require-splicedir", "-D", "{GWD}", "{GWQ}"],
                          None),
    "suboptimal_score": (["--suboptimal-score", "0.2", "-f", "1", "-D",
                          "{DUPD}", "{DUPQ}"], None),
    "trim_end_exons": (["--trim-end-exons", "150", "-D", "{GWD}", "{GWQ}"],
                       None),
    "quiet_if_excessive": (["--quiet-if-excessive", "-n", "1", "-x", "30",
                            "-f", "1", "-D", "{CHD}", "{CHQ}"], None),
    "part": (["-q", "1/3", "-D", "{GWD}", "{GWQ}"], None),
    "min_coverage_identity": (["--min-trimmed-coverage", "0.9",
                               "--min-identity", "0.99", "-D", "{GWD}",
                               "{GWQ}"], None),
    # input and output management
    "nofails": (["--nofails", "-S", "-D", "{D}", "{Q}"], None),
    "failsonly": (["--failsonly", "-D", "{D}", "{Q}"], None),
    "failed_input": (["--failed-input", "{OUT}/failed.fa", "-D", "{D}",
                      "{Q}"], None),
    "split_output": (["--split-output", "{OUT}/split", "-x", "30", "-f",
                      "1", "-D", "{CHD}", "{CHQ}"], None),
    "split_output_paths": (["--split-output", "{OUT}/s", "-D", "{DUPD}",
                            "{DUPQ}"], None),
    "chrsubset": (["-c", "chr2", "-D", "{GWD}", "{GWQ}"], None),
    "chrsubset_unknown": (["-c", "chrX", "-D", "{GWD}", "{GWQ}"], None),
    # maps and known splicing
    "map": (["-S", "-m", "{MAP}", "-D", "{D}", "{Q}"], None),
    "mapexons_nflanking": (["-A", "-m", "{MAP}", "--mapexons",
                            "--nflanking", "1", "-D", "{D}", "{Q}"], None),
    "splicing": (["-s", "{SP}", "-D", "{GWD}", "{GWQ}"], None),
    # alignment display
    "I1": (["-A", "-I", "1", "-D", "{GWD}", "{GWQ}"], None),
    "I2": (["-A", "-I", "2", "-D", "{GWD}", "{GWQ}"], None),
    "wraplength": (["-A", "--wraplength", "60", "-D", "{D}", "{Q}"], None),
    "nomargin": (["-A", "--nomargin", "-D", "{D}", "{Q}"], None),
    "nolengths": (["-A", "--nolengths", "-D", "{D}", "{Q}"], None),
    "introngap": (["-A", "--introngap", "5", "-D", "{D}", "{Q}"], None),
    # GFF3 and SAM shaping
    "gff3_separators": (["-f", "2", "--gff3-add-separators", "0", "-D",
                         "{D}", "{Q}"], None),
    "gff3_swap_phase": (["-f", "2", "--gff3-swap-phase", "1", "-D", "{GWD}",
                         "{GWQ}"], None),
    "no_sam_headers": (["-f", "samse", "--no-sam-headers", "-D", "{D}",
                        "{Q}"], None),
    "sam_extended_cigar": (["-f", "samse", "--sam-extended-cigar", "-D",
                            "{GWD}", "{GWQ}"], None),
    "force_xs_dir": (["-f", "samse", "--force-xs-dir", "--sam-use-0M", "0",
                      "-D", "{D}", "{Q}"], None),
    "quality_shift": (["-f", "samse", "-j", "5", "--quality-protocol",
                       "illumina", "-D", "{D}", "{Q}"], None),
    "read_groups": (["-f", "samse", "--read-group-id", "rg7",
                     "--read-group-name", "s1", "--read-group-library",
                     "lib", "--read-group-platform", "ILLUMINA", "-D", "{D}",
                     "{Q}"], None),
    # translation and the rest
    "md5": (["--md5", "-D", "{D}", "{Q}"], None),
    "translation_code": (["--translation-code", "2", "-A", "-D", "{GWD}",
                          "{GWQ}"], None),
    "alt_start_codons": (["--alt-start-codons", "-P", "-D", "{GWD}",
                          "{GWQ}"], None),
    "cdsstart": (["-a", "3", "-A", "-D", "{D}", "{Q}"], None),
    "fulllength": (["-F", "-A", "-D", "{GWD}", "{GWQ}"], None),
    "compat_flags": (["-t", "4", "-B", "5", "-O", "--prunelevel", "1",
                      "-k", "12", "-d", "gw", "-D", "{GWD}", "{GWQ}"], None),
    "kmer_mismatch": (["-k", "14", "-D", "{GWD}", "{GWQ}"], None),
}


@pytest.mark.parametrize("case", list(MAIN_CASES))
def test_main_parity(worlds, case, tmp_path):
    """tpumap's main and the port's (--device cpu): byte-identical output
    but for the echoed command line, the same return value, and the
    same files where the case writes any."""
    argv, stdin = MAIN_CASES[case]
    argv = [a.format(**worlds) if "{" in a and "{OUT}" not in a else a
            for a in argv]
    out = assert_main_parity(argv, worlds[stdin] if stdin else None,
                             tmp_path if any("{OUT}" in a for a in argv)
                             else None)
    assert out or case in ("chrsubset_unknown", "kmer_mismatch")


def test_main_version_and_check(capsys):
    with pytest.raises(SystemExit) as e:
        gmap_cli.main(["--version"])
    assert e.value.code == 0
    assert capsys.readouterr().out.startswith("tpumap_torch-gmap 0.1.0 ")
    # --check verifies the card and the kernels' build: where there is
    # no card it says so and fails
    rc = gmap_cli.main(["--check"])
    err = capsys.readouterr().err
    assert "numpy integer assumptions ok" in err
    assert rc == (0 if torch.cuda.is_available() else 1)


def test_main_time(worlds, capsys):
    gmap_cli.main(["--time", "-D", worlds["D"], worlds["Q"], "--device",
                   "cpu"])
    assert "Aligned 3 queries in" in capsys.readouterr().err


def test_main_loads_the_ports_db(worlds):
    """The db tpumap's build_cli wrote loads through the port's GenomeDB
    with tpumap's arrays."""
    a, b = JGenomeDB.load(worlds["D"]), GenomeDB.load(worlds["D"])
    assert a.genome_length == b.genome_length
    assert np.array_equal(a.get_codes(0, a.genome_length),
                          b.get_codes(0, b.genome_length))
