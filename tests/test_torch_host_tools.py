"""The last host tools of the port against tpumap's, on the same inputs:
cat_cli (test_cat's world: cat_dbs and main's database), get_genome_cli
(regions forward and reverse, whole chromosomes, -S on an alternate
genome and -m with a map), fa_coords_cli (linear and circular contigs,
stdout and -o) and io/fastread.py (test_native's cases: FASTQ, multi-line
FASTA, max_len, gzip, and a malformed FASTQ the tokenizer rejects),
output for output."""
import gzip

import numpy as np
import pytest

from test_cat import world  # noqa: F401  (test_cat's fixture)
from test_torch_index_tools import assert_trees_equal, run
from tpumap.cli import cat_cli as jcat_cli
from tpumap.cli import fa_coords_cli as jfa_coords_cli
from tpumap.cli import get_genome_cli as jget_genome_cli
from tpumap.io import fastread as jfastread
from tpumap_torch.cli import cat_cli, fa_coords_cli, get_genome_cli
from tpumap_torch.index.build import build_db
from tpumap_torch.io import fastread


def test_cat_dbs_matches(world):  # noqa: F811
    from tpumap.index import build_db as jbuild_db
    d = world
    want = jcat_cli.cat_dbs([jbuild_db(d / "g1.fa", name="g1", k=10,
                                       interval=3),
                             jbuild_db(d / "g2.fa", name="g2", k=10,
                                       interval=3)], "all")
    got = cat_cli.cat_dbs([build_db(d / "g1.fa", name="g1", k=10,
                                    interval=3),
                           build_db(d / "g2.fa", name="g2", k=10,
                                    interval=3)], "all")
    assert got.chrom_names == want.chrom_names
    for key in ("chrom_offsets", "circularp", "genome_packed",
                "genome_nmask", "offsets", "positions"):
        a, b = getattr(want, key), getattr(got, key)
        assert a.dtype == b.dtype and np.array_equal(a, b), key
    with pytest.raises(ValueError, match="share k"):
        cat_cli.cat_dbs([build_db(d / "g1.fa", name="g1", k=10, interval=3),
                         build_db(d / "g2.fa", name="g2", k=9, interval=3)],
                        "bad")


def test_cat_main_matches(world, tmp_path):  # noqa: F811
    d = world
    for name, k in (("g1", 10), ("g2", 10)):
        build_db(d / f"{name}.fa", name=name, k=k,
                 interval=3).save(str(tmp_path / name))
    ins = [str(tmp_path / "g1"), str(tmp_path / "g2")]
    for who, main in (("j", jcat_cli.main), ("t", cat_cli.main)):
        rc, out, err = run(main, ["-d", "all", "-D", str(tmp_path / who)]
                           + ins)
        assert rc == 0 and not out
        assert err.startswith("Concatenated 2 databases: 3 contigs")
    assert_trees_equal(tmp_path / "j", tmp_path / "t")


@pytest.fixture(scope="module")
def genome_world(tmp_path_factory):
    """Two chromosomes saved as a db, with an alternate genome (a SNP
    every 50 bp in chr1:1001..1500) and a map of two intervals."""
    from tpumap_torch.io.iit import build_iit, parse_map_fasta
    d = tmp_path_factory.mktemp("getgenome")
    rng = np.random.default_rng(41)
    s1 = "".join("ACGT"[i] for i in rng.integers(0, 4, 20000))
    s2 = "".join("ACGTN"[i] for i in rng.integers(0, 5, 3001))
    (d / "g.fa").write_text(f">chr1\n{s1}\n>chr2\n{s2}\n")
    db = build_db(d / "g.fa", name="g", k=10, interval=3)
    db.save(str(d / "g"))
    codes = db.get_codes(0, db.genome_length).copy()
    codes[1000:1500:50] = (codes[1000:1500:50] + 1) % 4
    from tpumap_torch.utils import dna
    db.genomealt_packed = dna.pack_2bit(codes)
    db.save(str(d / "gs"))
    build_iit(parse_map_fasta(__import__("io").StringIO(
        ">a chr1:101..300\nfirst\n>b chr2:11..40\nsecond\n"))).write(
        str(d / "m.iit"))
    return d


@pytest.mark.parametrize("argv", [
    ["-D", "g", "-d", "g", "chr1:101..160"],
    ["-D", "g", "-d", "g", "chr1:160..101"],
    ["-D", "g", "-d", "g", "chr1:19941..20000"],
    ["-D", "g", "chr2"],
    ["-D", "g", "chr2:3001"],
    ["-D", "gs", "-S", "chr1:990..1200"],
    ["-D", "gs", "-S", "chr1:1200..990"],
    ["-D", "g", "-m", "m.iit", "chr1:150..250"],
    ["-D", "g", "-m", "m", "chr2:1..3001"],
], ids=["fwd", "rev", "end", "whole", "one", "snp", "snp_rev", "map",
        "map_noext"])
def test_get_genome_matches(genome_world, argv):
    d = genome_world
    argv = [str(d / a) if i and argv[i - 1] in ("-D", "-m") else a
            for i, a in enumerate(argv)]
    want = run(jget_genome_cli.main, argv)
    got = run(get_genome_cli.main, argv)
    assert got == want and want[1]


def test_fa_coords_matches(tmp_path):
    rng = np.random.default_rng(3)
    fa = tmp_path / "c.fa"
    fa.write_text("".join(
        f">{n} some desc\n" + "\n".join(
            "".join("ACGT"[i] for i in rng.integers(0, 4, 60))
            for _ in range(m)) + "\n"
        for n, m in (("chr1", 5), ("chrM", 2), ("scaf_7", 1))))
    fa2 = tmp_path / "d.fa"
    fa2.write_text(">extra\nACGTACGTNN\n")
    for argv in ([str(fa)], ["-c", "chrM,scaf_7", str(fa), str(fa2)]):
        assert run(fa_coords_cli.main, argv) == run(jfa_coords_cli.main,
                                                    argv)
    for who, main in (("j", jfa_coords_cli.main), ("t", fa_coords_cli.main)):
        assert run(main, ["-o", str(tmp_path / f"{who}.coords"), "-c",
                          "chrM", str(fa)])[:2] == (0, "")
    assert (tmp_path / "t.coords").read_bytes() == \
        (tmp_path / "j.coords").read_bytes()


# ----------------------------------------------------------- fastread

def _reads(tmp_path, kind):
    rng = np.random.default_rng(1 if kind == "fastq" else 2)
    if kind == "fastq":
        recs = []
        for i in range(50):
            L = int(rng.integers(30, 150))
            seq = "".join("ACGTN"[j] for j in rng.integers(0, 5, L))
            recs.append(f"@read{i} extra stuff\n{seq}\n+\n{'F' * L}\n")
        p = tmp_path / "r.fq"
        p.write_text("".join(recs))
        return p
    if kind == "fasta_multiline":
        out = []
        for i in range(10):
            L = int(rng.integers(100, 400))
            seq = "".join("ACGT"[j] for j in rng.integers(0, 4, L))
            wrapped = "\n".join(seq[k:k + 60] for k in range(0, L, 60))
            out.append(f">ctg{i} desc\n{wrapped}\n")
        p = tmp_path / "g.fa"
        p.write_text("".join(out))
        return p
    if kind == "fasta_single":
        p = tmp_path / "s.fa"
        p.write_text("".join(f">s{i}\n{'ACGTN'[i % 5] * (20 + i)}\n"
                             for i in range(12)))
        return p
    if kind == "gzip":
        p = tmp_path / "r.fq.gz"
        with gzip.open(p, "wt") as f:
            f.write("@a\nACGT\n+\nIIII\n@b desc\nNNAC\n+\nIIII\n")
        return p
    # a FASTQ record cut short: the tokenizer rejects the file
    p = tmp_path / "bad.fq"
    p.write_text("@a\nACGT\n+\nIIII\n@b\nACGT\n")
    return p


@pytest.mark.parametrize("kind,max_len", [
    ("fastq", None), ("fastq", 40), ("fasta_multiline", None),
    ("fasta_single", None), ("fasta_single", 24), ("gzip", None),
    ("malformed", None)])
def test_load_reads_arrays_matches(tmp_path, kind, max_len):
    p = str(_reads(tmp_path, kind))
    try:
        want = jfastread.load_reads_arrays(p, max_len)
    except Exception as e:           # noqa: BLE001 - compared below
        with pytest.raises(type(e)):
            fastread.load_reads_arrays(p, max_len)
        return
    names, quals, batch = fastread.load_reads_arrays(p, max_len)
    assert names == want[0] and quals == want[1]
    assert sorted(batch) == sorted(want[2])
    for key, a in want[2].items():
        assert batch[key].dtype == a.dtype and np.array_equal(batch[key], a)


def test_load_reads_arrays_needs_the_native_library(tmp_path, monkeypatch):
    import tpumap_torch.native as native
    monkeypatch.setattr(native, "get_lib", lambda: None)
    with pytest.raises(RuntimeError, match="native tokenizer"):
        fastread.load_reads_arrays(str(_reads(tmp_path, "fastq")))
