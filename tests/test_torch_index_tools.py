"""The index and map tools that make the gsnap CLI's inputs: the port's
build_cli, iit_cli (store, get, dump), snpindex_cli, modeindex_cli
(cmetindex, atoiindex), trindex_cli and converters against tpumap's, on
the same inputs (test_converters' and test_iit's, and one genome).

Files are compared byte for byte, .npz arrays by value; each package's
GenomeDB.load and IIT.read read the files the other wrote."""
import io
import pathlib
import sys
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

from test_converters import (DBSNP_LINES, ENSEMBL_LINES, GENCODE, GFF3, GTF,
                             GTF_LINES, GVF_LINES)
from test_iit import MULTI
from tpumap.cli import build_cli as jbuild_cli
from tpumap.cli import converters as jconverters
from tpumap.cli import iit_cli as jiit_cli
from tpumap.cli import modeindex_cli as jmodeindex_cli
from tpumap.cli import snpindex_cli as jsnpindex_cli
from tpumap.cli import trindex_cli as jtrindex_cli
from tpumap.gsnap.transcriptome import Transcriptome as JTranscriptome
from tpumap.index.build import GenomeDB as JGenomeDB
from tpumap.io.iit import IIT as JIIT
from tpumap_torch.cli import (build_cli, converters, iit_cli, modeindex_cli,
                              snpindex_cli, trindex_cli)
from tpumap_torch.gsnap.transcriptome import Transcriptome
from tpumap_torch.index.build import GenomeDB
from tpumap_torch.io.iit import IIT

PKGS = {"j": dict(build=jbuild_cli, conv=jconverters, iit=jiit_cli,
                  mode=jmodeindex_cli, snp=jsnpindex_cli, tr=jtrindex_cli),
        "t": dict(build=build_cli, conv=converters, iit=iit_cli,
                  mode=modeindex_cli, snp=snpindex_cli, tr=trindex_cli)}


def run(main, argv, stdin=""):
    """(return value, stdout, stderr) of one tool run."""
    out, err = io.StringIO(), io.StringIO()
    old = sys.stdin
    sys.stdin = io.StringIO(stdin)
    try:
        with redirect_stdout(out), redirect_stderr(err):
            rc = main(argv)
    finally:
        sys.stdin = old
    return rc, out.getvalue(), err.getvalue()


def tree(d: pathlib.Path) -> dict:
    """Every file under d: .npz as {name: array}, the rest as bytes."""
    files = {}
    for p in sorted(d.rglob("*")):
        if p.is_dir():
            continue
        key = str(p.relative_to(d))
        if p.suffix == ".npz":
            with np.load(p) as z:
                files[key] = {k: z[k] for k in z.files}
        else:
            files[key] = p.read_bytes()
    return files


def assert_trees_equal(a: pathlib.Path, b: pathlib.Path):
    ta, tb = tree(a), tree(b)
    assert sorted(ta) == sorted(tb)
    for k, v in ta.items():
        if isinstance(v, dict):
            assert sorted(tb[k]) == sorted(v), k
            for n in v:
                assert tb[k][n].dtype == v[n].dtype and np.array_equal(
                    tb[k][n], v[n]), (k, n)
        else:
            assert tb[k] == v, k


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """Two chromosomes with N runs (one circular), as FASTA."""
    d = tmp_path_factory.mktemp("tools")
    rng = np.random.default_rng(8)
    a = "".join("ACGT"[i] for i in rng.integers(0, 4, 12_000))
    a = a[:4000] + "N" * 30 + a[4030:9000] + "nRY" + a[9003:]
    m = "".join("ACGT"[i] for i in rng.integers(0, 4, 3_000))
    (d / "g.fa").write_text(f">chr1 primary\n{a}\n>chrM\n{m[:1500]}\n"
                            f"{m[1500:]}\n")
    return d


@pytest.fixture(scope="module")
def dbs(genome):
    """The genome built by both build_clis (-k 12, chrM circular, the
    .genomecomp), then SNP-tolerant (a VCF through vcf_iit and iit_store
    of the same package), with the cmet and atoi tables, and a
    transcriptome of GENCODE's genes moved onto chr1."""
    seq = (genome / "g.fa").read_text().split("\n")[1]
    vcf = "##fileformat=VCFv4.2\n" + "".join(
        f"chr1\t{p}\trs{p}\t{seq[p - 1]}\t"
        f"{'ACGT'[('ACGT'.index(seq[p - 1]) + 1) % 4]}\t.\t.\t.\n"
        for p in range(101, 12_000, 413) if seq[p - 1] in "ACGT")
    vcf += "chr1\t200\tbad\tN\tA\t.\t.\t.\n"
    genes = GENCODE.replace("chr2", "chr1").replace("9000", "8000")
    out = {}
    for pkg, mods in PKGS.items():
        d = genome / pkg
        d.mkdir()
        rc, _o, err = run(mods["build"].main,
                          ["-D", str(d), "-d", "g", "-k", "12", "-q", "3",
                           "-c", "chrM", "--write-genomecomp",
                           str(genome / "g.fa")])
        _rc, text, _e = run(mods["conv"].vcf_iit_main, [], vcf)
        (d / "snps.txt").write_text(text)
        run(mods["iit"].store_main, ["-o", str(d / "snps"),
                                     str(d / "snps.txt")])
        (d / "gsnp").mkdir()
        for p in (d / "g").iterdir():
            (d / "gsnp" / p.name).write_bytes(p.read_bytes())
        rcs = run(mods["snp"].main, ["-D", str(d / "gsnp"),
                                     str(d / "snps.iit")])
        run(mods["mode"].main_cmet, ["-D", str(d / "gsnp")])
        run(mods["mode"].main_atoi, ["-D", str(d / "gsnp")])
        _rc, text, _e = run(mods["conv"].gff3_genes_main, [], genes)
        (d / "genes.txt").write_text(text)
        run(mods["iit"].store_main, ["-o", str(d / "genes"),
                                     str(d / "genes.txt")])
        trrun = run(mods["tr"].main, ["-D", str(d / "g"), "-c", "tr",
                                      str(d / "genes.iit")])
        # the messages name the package's own directory
        rcs, trrun = ([x.replace(str(d), "") if isinstance(x, str)
                       else x for x in r] for r in (rcs, trrun))
        out[pkg] = (d, (rc, err.replace(str(d), "")), rcs, trrun)
    return out


def test_build_cli_matches(dbs):
    """The db directories (arrays by value) and .genomecomp bytes; the
    transcriptome under it; each package loads the other's db."""
    (jd, jrun, _js, jtr), (td, trun, _ts, ttr) = dbs["j"], dbs["t"]
    assert trun == jrun
    assert ttr == jtr
    assert_trees_equal(jd / "g", td / "g")
    comp = (td / "g" / "g.genomecomp").read_bytes()
    L = GenomeDB.load(str(td / "g")).genome_length
    assert len(comp) == 4 * (3 * ((L + 31) // 32) + 2)
    for load, other in ((JGenomeDB.load, td), (GenomeDB.load, jd)):
        db = load(str(other / "g"))
        assert db.chrom_names == ["chr1", "chrM"] and db.k == 12
        assert bool(db.circularp[1]) and not bool(db.circularp[0])
    jt = JTranscriptome.load(str(td / "g" / "g.transcripts" / "tr"))
    tt = Transcriptome.load(str(jd / "g" / "g.transcripts" / "tr"))
    assert tt.labels == jt.labels
    assert np.array_equal(tt.exonbounds, jt.exonbounds)


def test_build_cli_auto_k(genome, tmp_path):
    """-k 0 picks k from the input size and says so on stderr."""
    got = []
    for pkg, mods in PKGS.items():
        rc, out, err = run(mods["build"].main,
                           ["-D", str(tmp_path / pkg), "-d", "a",
                            str(genome / "g.fa")])
        got.append((rc, out, err.replace(str(tmp_path / pkg), "")))
        assert "Auto-selected k=" in err
    assert got[1] == got[0]
    assert_trees_equal(tmp_path / "j", tmp_path / "t")


def test_snp_and_mode_indexes_match(dbs):
    """snpindex (a VCF entry whose reference base is N is skipped with
    the same warning) and the cmet and atoi tables."""
    (jd, _jr, js, _jt), (td, _tr, ts, _tt) = dbs["j"], dbs["t"]
    assert ts[0] == js[0] == 0
    assert ts[2] == js[2]
    assert_trees_equal(jd / "gsnp", td / "gsnp")
    db = GenomeDB.load(str(jd / "gsnp"))
    assert sorted(db.mode_indexes) == ["ag", "ct", "ga", "snp", "tc"]
    jdb = JGenomeDB.load(str(td / "gsnp"))
    assert sorted(jdb.mode_indexes) == sorted(db.mode_indexes)


def test_snps_from_iit_matches(dbs):
    (jd, *_), (td, *_) = dbs["j"], dbs["t"]
    jc, ja = jsnpindex_cli.snps_from_iit(JIIT.read(str(jd / "snps.iit")),
                                         JGenomeDB.load(str(jd / "g")))
    tc, ta = snpindex_cli.snps_from_iit(IIT.read(str(td / "snps.iit")),
                                        GenomeDB.load(str(td / "g")))
    for a, b in ((jc, tc), (ja, ta)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert len(tc) > 20


def test_add_mode_index_method_matches(dbs):
    """GenomeDB.add_mode_index (the port's method over its ops/mode.py)
    gives tpumap's table in every space."""
    jd = dbs["j"][0]
    jdb, tdb = JGenomeDB.load(str(jd / "g")), GenomeDB.load(str(jd / "g"))
    for space in ("ct", "ga", "ag", "tc"):
        jdb.add_mode_index(space)
        tdb.add_mode_index(space)
        for a, b in zip(jdb.mode_indexes[space], tdb.mode_indexes[space]):
            assert a.dtype == b.dtype and np.array_equal(a, b), space


# ------------------------------------------------------------ iit_cli

STORE_CASES = {
    "div": ([], MULTI),
    "univ": (["-1"], MULTI),
    "sort_none": (["-s", "none"], MULTI),
    "sort_alpha": (["-s", "alpha"], MULTI),
    "sort_numeric_alpha": (["-s", "numeric-alpha"], MULTI),
    "version2": (["-v", "2"], MULTI),
    "no_divs": ([], ">a 100..200 t\nannot a\n>b 150..170\n>c 500..400 u\n"
                    ">d 90\n"),
    "gff3": (["-G"], "chr1\tt\tgene\t100\t900\t.\t+\t.\tID=g1;Name=foo\n"
                     "chr1\tt\texon\t100\t400\t.\t-\t.\tID=e1\n"
                     "chr2\tt\texon\t10\t40\t.\t+\t.\tName=x\n"),
    "gff3_label": (["-G", "-l", "Name"],
                   "chr1\tt\tgene\t100\t900\t.\t+\t.\tID=g1;Name=foo\n"
                   "chr1\tt\texon\t100\t400\t.\t-\t.\tID=e1\n"),
    "splicesites": ([], None),
}
QUERIES = [["chr1:900..1600"], ["chr2:350..350"], ["1500"], ["GENE3"],
           ["-L", "GENE1"], ["-A", "chr1", "1000", "2000"],
           ["-S", "chr1:1..5000"], ["-E", "chr1:1000..2000"], ["150", "160"],
           ["chrX:1..5"], []]


@pytest.mark.parametrize("case", list(STORE_CASES))
def test_iit_store_get_dump_match(tmp_path, case):
    """iit_store's .iit bytes in the div and univ formats (sorts,
    versions, GFF3 input with its labels, a splice-site map from
    gff3_splicesites), iit_get's queries and iit_dump's forms, and each
    package's reader on the other's file."""
    flags, text = STORE_CASES[case]
    if text is None:
        _rc, text, _e = run(jconverters.gff3_splicesites_main, [], GFF3)
    (tmp_path / "in.txt").write_text(text)
    for pkg, mods in PKGS.items():
        assert run(mods["iit"].store_main, flags + [
            "-o", str(tmp_path / pkg), str(tmp_path / "in.txt")])[0] == 0
    want = (tmp_path / "j.iit").read_bytes()
    assert (tmp_path / "t.iit").read_bytes() == want
    if case == "version2":
        # tpumap's writer puts a division table into a file of every
        # version; its reader expects none before version 3. The port
        # copies both (ROADMAP queue 3)
        for read in (JIIT.read, IIT.read):
            with pytest.raises(ValueError, match="truncated"):
                read(str(tmp_path / "t.iit"))
        return
    for q in QUERIES:
        assert run(iit_cli.get_main, [str(tmp_path / "t.iit")] + q) == \
            run(jiit_cli.get_main, [str(tmp_path / "t.iit")] + q), q
    for f in ([], ["-S"], ["-A"], ["-L"]):
        assert run(iit_cli.dump_main, f + [str(tmp_path / "j.iit")]) == \
            run(jiit_cli.dump_main, f + [str(tmp_path / "j.iit")]), f
    j, t = JIIT.read(str(tmp_path / "t.iit")), IIT.read(str(tmp_path /
                                                            "j.iit"))
    assert (t.version, t.divs, t.labels, t.annotations, t.typestrings) == \
        (j.version, j.divs, j.labels, j.annotations, j.typestrings)
    for i in range(1, t.total_nintervals + 1):
        assert t.interval(i) == j.interval(i)
        assert t.header_line(i) == j.header_line(i)
    for div in t.divs:
        for x, y in ((0, 10**6), (100, 160), (1500, 1500)):
            assert list(t.get(div, x, y)) == list(j.get(div, x, y))
            for ty in range(len(t.typestrings)):
                assert list(t.get_typed(div, x, y, ty)) == \
                    list(j.get_typed(div, x, y, ty))
    for lab in set(t.labels):
        assert list(t.find(lab)) == list(j.find(lab))


def test_iit_cli_dispatch(tmp_path):
    """python -m tpumap_torch.cli.iit_cli store|get|dump."""
    import subprocess
    (tmp_path / "m.fa").write_text(MULTI)
    repo = pathlib.Path(__file__).resolve().parent.parent
    kw = dict(cwd=tmp_path, capture_output=True, text=True,
              env={"PYTHONPATH": str(repo), "PATH": "/usr/bin:/bin"})
    subprocess.run([sys.executable, "-m", "tpumap_torch.cli.iit_cli",
                    "store", "-o", "m", "m.fa"], check=True, **kw)
    r = subprocess.run([sys.executable, "-m", "tpumap_torch.cli.iit_cli",
                        "dump", "m.iit"], check=True, **kw)
    assert r.stdout == run(jiit_cli.dump_main, [str(tmp_path / "m.iit")])[1]


# --------------------------------------------------------- converters

PSL = "\t".join(["200", "0", "0", "0", "0", "0", "1", "300", "+", "tx1",
                 "200", "0", "200", "chr1", "50000", "999", "1499", "2",
                 "100,100,", "0,100,", "999,1399,"]) + "\n" + "\t".join(
    ["150", "0", "0", "0", "0", "0", "2", "500", "-", "tx2", "150", "0",
     "150", "chr2", "50000", "2999", "3799", "3", "50,50,50,", "0,50,100,",
     "2999,3399,3749,"]) + "\n"

CONVERTER_CASES = {
    "gff3_splicesites": (GFF3, []), "gff3_introns": (GFF3, []),
    "gff3_genes": (GENCODE, []), "gff3_genes_plain": (GFF3, []),
    "gtf_splicesites": (GTF, []), "gtf_introns": (GTF, []),
    "gtf_genes": (GTF, []), "psl_splicesites": (PSL, []),
    "psl_introns": (PSL, []), "psl_genes": (PSL, []),
    "vcf_iit": ("##fileformat=VCFv4.2\n"
                "chr1\t150\trs1\tA\tG\t.\tPASS\t.\n"
                "chr1\t200\t.\tC\tT,G\t.\tPASS\t.\n"
                "chr1\t300\trs3\tAT\tA\t.\tPASS\t.\n", []),
    "dbsnp_iit": (DBSNP_LINES, ["-"]),
    "dbsnp_iit_weight": (DBSNP_LINES, ["-w", "3", "-c", "chr1", "-"]),
    "gvf_iit": (GVF_LINES, ["-"]),
    "ensembl_genes": (ENSEMBL_LINES, ["-"]),
    "gtf_transcript_splicesites": (GTF_LINES, ["-E", "-"]),
    "gtf_transcript_splicesites_plain": (GTF_LINES, ["-"]),
}


@pytest.mark.parametrize("case", list(CONVERTER_CASES))
def test_converter_matches(case):
    """Every converter main on test_converters' inputs, through the
    dispatching main: stdout and return value."""
    text, args = CONVERTER_CASES[case]
    tool = case.replace("_plain", "").replace("_weight", "")
    want = run(jconverters.main, [tool] + args, text)
    assert run(converters.main, [tool] + args, text) == want
    assert want[0] == 0 and want[1], case


def test_md_coords_and_dispatch_match(tmp_path):
    md = tmp_path / "seq_contig.md"
    md.write_text("9606\tchr1\t1\t1000\t+\tCTG1\tC57BL/6J\n"
                  "9606\tchr1\t1001\t2000\t-\tCTG2\tC57BL/6J\n"
                  "9606\tchr2\t1\t500\t+\tCTG3\tother\n")
    for pkg, mod in (("j", jconverters), ("t", converters)):
        for strain in ([], ["--strain", "C57BL/6J"]):
            out = tmp_path / f"{pkg}{len(strain)}.txt"
            mod.md_coords_main(["-c", "5,1,2,3,4", "-o", str(out)] + strain
                               + [str(md)])
    for n in (0, 2):
        assert (tmp_path / f"t{n}.txt").read_bytes() == \
            (tmp_path / f"j{n}.txt").read_bytes()
    for argv in ([], ["-h"], ["nosuch"]):
        j = run(jconverters.main, argv)
        t = run(converters.main, argv)
        assert t[0] == j[0]
        assert t[2].replace("tpumap_torch.", "tpumap.") == j[2]
