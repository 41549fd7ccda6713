"""The port stands alone: it imports nothing of tpumap and nothing of JAX,
runs where neither can be imported, and its copies of tpumap's host
modules give tpumap's results on the same inputs.

(a) an AST walk of every module of tpumap_torch, of chip_smoke.py and of
    phase_ab.py, function-local imports included;
(b) a subprocess where JAX and tpumap are refused: every port module
    imports (the staged path's knownindels, transcriptome, remap and
    twopass, and the multi-device parallel modules among them), the
    index-sharded aligner and align_records through a MeshContext run,
    and align_records (DNA, RNA and the staged path
    with fusions), align_paired_records and main --device cpu give the
    SAM of the port's in-process runs on tpumap's objects (which
    test_torch_slice/splice/paired/staged hold to tpumap's own SAM);
(c) the copies against tpumap: build_db, FASTA/FASTQ reading, the IIT
    reader with KnownSplicing.from_splicing_iit, the host library's batch
    encoder, the SAM header and records as text, and GMAP's MaxEnt
    models (read from the port's own copy of the tables), translation
    and canonical splice scoring;
and DeviceIndex.from_host's default device, the card; and the port's
GMAP main (--device cpu) where JAX and tpumap cannot be imported.
"""
import ast
import dataclasses
import gzip
import io
from contextlib import redirect_stdout
import pathlib
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpumap_torch
from tpumap.gmap import maxent as jmaxent
from tpumap.gmap import translation as jtranslation
from tpumap.gsnap import driver as jdriver
from tpumap.gsnap.knownsplicing import KnownSplicing as JKnownSplicing
from tpumap.index import build as jbuild
from tpumap.io import fasta as jfasta
from tpumap.io import iit as jiit
from tpumap.io import sam as jsam
from tpumap.io import sam_bulk as jsam_bulk
from tpumap.ops import splice as jsplice
from tpumap_torch.gmap import maxent, translation
from tpumap_torch.gsnap import driver
from tpumap_torch.gsnap.knownsplicing import KnownSplicing
from tpumap_torch.index import build
from tpumap_torch.index.device import DeviceIndex
from tpumap_torch.io import fasta, iit, sam, sam_bulk
from tpumap_torch.ops import splice
from torch_workloads import (NO_TPUMAP, gmap_world, mixed_workload, sam_text,
                             sharded_diags, stream_pairs)

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "tpumap_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "phase_ab.py"]


def imported_modules(path: pathlib.Path) -> list[str]:
    """Every module an import statement of the file names, at any depth."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_tpumap_or_jax_import(path):
    bad = [m for m in imported_modules(path)
           if m.split(".")[0] in ("tpumap", "jax")]
    assert not bad, bad


def test_chip_smoke_helpers_import_no_tpumap(tmp_path):
    """The repo scripts chip_smoke.py imports from (gmap_bench.py,
    staged_bench.py; their main() runs tpumap as the reference, and
    chip_smoke.py refuses JAX and tpumap) import neither at module level,
    and each name chip_smoke.py takes from them is defined there."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    taken = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.ImportFrom) and node.level == 0
                and (REPO / f"{node.module}.py").exists()):
            taken.setdefault(node.module, set()).update(
                a.name for a in node.names)
    assert {"gmap_bench", "staged_bench"} <= set(taken)
    for mod, names in taken.items():
        body = ast.parse((REPO / f"{mod}.py").read_text()).body
        top = [n for n in body if isinstance(n, (ast.Import, ast.ImportFrom))]
        mods = [a.name for n in top if isinstance(n, ast.Import)
                for a in n.names] + [n.module for n in top
                                     if isinstance(n, ast.ImportFrom)]
        assert not [m for m in mods if m.split(".")[0] in ("tpumap", "jax")]
        defined = {n.name for n in body if isinstance(
            n, (ast.FunctionDef, ast.ClassDef))} | {
            t.id for n in body if isinstance(n, ast.Assign)
            for t in n.targets if isinstance(t, ast.Name)}
        assert names <= defined, (mod, names - defined)


def test_import_walk_sees_local_imports(tmp_path):
    """The walk catches an import inside a function body."""
    f = tmp_path / "m.py"
    f.write_text("def f():\n    from tpumap.io import sam\n"
                 "    import jax.numpy\n")
    assert imported_modules(f) == ["tpumap.io", "jax.numpy"]


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """The stream workload built by tpumap, and the port's SAM on it: DNA,
    RNA, paired, and DNA without the qualities (as main reads the FASTA
    of the reads)."""
    root = tmp_path_factory.mktemp("iso")
    db, reads, _gfa = mixed_workload(root)
    ti = DeviceIndex.from_host(db, "cpu")
    kw = dict(config=driver.AlignConfig(top_k=4, max_occ=8), batch_size=32)
    dna = sam_text(driver.align_records(db, ti, reads, **kw))
    rna = sam_text(driver.align_records(db, ti, reads, novelsplicing=True,
                                        **kw))
    noq = sam_text(driver.align_records(
        db, ti, [jfasta.Record(r.accession, "", r.sequence) for r in reads],
        **kw))
    staged = sam_text(driver.align_records(
        db, ti, reads, novelsplicing=True, find_fusions=True, **kw))
    from tpumap_torch.gsnap.paired import align_paired_records
    chunks = []
    align_paired_records(db, ti, stream_pairs(db), batch_size=16,
                         pairmax=1000, sink=chunks.append,
                         config=kw["config"])
    return (dna, rna, b"".join(bytes(c) for c in chunks), noq, staged,
            sharded_diags(db, reads, kw["config"]))


def test_port_runs_without_tpumap_and_jax(mixed, tmp_path):
    dna, rna, pe, noq, staged, shard = mixed
    mods = sorted(m.name for m in pkgutil.walk_packages(
        tpumap_torch.__path__, "tpumap_torch."))
    assert {"tpumap_torch.native", "tpumap_torch.io.sam",
            "tpumap_torch.io.iit", "tpumap_torch.gsnap.knownindels",
            "tpumap_torch.gsnap.transcriptome", "tpumap_torch.gsnap.remap",
            "tpumap_torch.gsnap.twopass", "tpumap_torch.parallel.mesh",
            "tpumap_torch.parallel.pipeline", "tpumap_torch.parallel.sharded",
            "tpumap_torch.parallel.large",
            "tpumap_torch.parallel.distributed",
            "tpumap_torch.parallel.outmerge", "tpumap_torch.cli.cat_cli",
            "tpumap_torch.cli.get_genome_cli",
            "tpumap_torch.cli.fa_coords_cli",
            "tpumap_torch.io.fastread"} <= set(mods)
    script = NO_TPUMAP + f"""
import importlib, io, pathlib
from contextlib import redirect_stdout
sys.path[:0] = [{str(REPO)!r}, {str(REPO / "tests")!r}]
import torch
torch.set_num_threads(1)
for m in {mods!r}:
    importlib.import_module(m)
from torch_workloads import mixed_workload, stream_pairs
from tpumap_torch.gmap import maxent, translation
from tpumap_torch.cli import gsnap_cli
from tpumap_torch.gsnap import driver
from tpumap_torch.gsnap.paired import align_paired_records
from tpumap_torch.index.device import DeviceIndex
root = pathlib.Path({str(tmp_path)!r})
db, reads, _ = mixed_workload(root, port=True)
ti = DeviceIndex.from_host(db, "cpu")
cfg = driver.AlignConfig(top_k=4, max_occ=8)
out = sys.stdout.buffer
for novel in (False, True):
    driver.align_records(db, ti, reads, cfg, batch_size=32,
                         novelsplicing=novel, sink=out.write)
    out.write(b"=====\\n")
align_paired_records(db, ti, stream_pairs(db, port=True), cfg,
                     batch_size=16, pairmax=1000, sink=out.write)
out.write(b"=====\\n")
driver.align_records(db, ti, reads, cfg, batch_size=32, novelsplicing=True,
                     find_fusions=True, sink=out.write)
out.write(b"=====\\n")
db.save(str(root / "db"))
(root / "r.fa").write_text("".join(f">{{r.accession}}\\n{{r.sequence}}\\n"
                                   for r in reads))
buf = io.StringIO()
with redirect_stdout(buf):
    gsnap_cli.main(["-D", str(root / "db"), str(root / "r.fa"), "--device",
                    "cpu", "--batch-size", "32", "-n", "1"])
out.write(buf.getvalue().encode())
out.write(b"=====\\n")
from torch_workloads import sharded_diags
out.write(sharded_diags(db, reads, cfg))
out.write(b"=====\\n")
from tpumap_torch.parallel import mesh, pipeline
ctx = pipeline.MeshContext(mesh.make_mesh(devices=[torch.device("cpu")] * 4),
                           db)
driver.align_records(db, ctx.index, reads, cfg, batch_size=32,
                     sink=out.write, device_ctx=ctx)
assert sys.modules["jax"] is None
assert not [m for m in sys.modules if m.split(".")[0] == "tpumap"]
"""
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr.decode()[-3000:]
    (got_dna, got_rna, got_pe, got_staged, got_main, got_shard,
     got_mesh) = r.stdout.split(b"=====\n")
    assert got_dna == dna and got_rna == rna and got_pe == pe
    assert got_shard == shard and got_mesh == dna
    assert got_staged == staged
    body = [ln for ln in got_main.decode().splitlines()
            if not ln.startswith("@")]
    assert body == noq.decode().splitlines()


# ------------------------------------------------------ the copies

def genome_text(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """One FASTA (two chromosomes, N runs, one circular) built by both
    packages."""
    d = tmp_path_factory.mktemp("dbs")
    rng = np.random.default_rng(4)
    a = genome_text(rng, 9000)
    a = a[:3000] + "N" * 40 + a[3040:7000] + "nnRY" + a[7004:]
    b = genome_text(rng, 5000)
    (d / "g.fa").write_text(f">chrA desc\n{a}\n>chrM\n{b[:2500]}\n{b[2500:]}\n")
    kw = dict(name="g", k=12, interval=3, circular={"chrM"})
    return (jbuild.build_db(str(d / "g.fa"), **kw),
            build.build_db(str(d / "g.fa"), **kw), d)


def assert_db_equal(jdb, tdb):
    for f in dataclasses.fields(jdb):
        a, b = getattr(jdb, f.name), getattr(tdb, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        elif isinstance(a, dict):
            assert sorted(a) == sorted(b), f.name
            for s in a:
                for x, y in zip(a[s], b[s]):
                    assert x.dtype == y.dtype and np.array_equal(x, y), s
        else:
            assert a == b, f.name


def test_build_db_matches(dbs):
    jdb, tdb, d = dbs
    assert_db_equal(jdb, tdb)
    assert tdb.genome_length == jdb.genome_length
    for u in (0, 2999, 3020, 9000, 9000 + 2600, jdb.genome_length - 1):
        assert tdb.chrpos(u) == jdb.chrpos(u)
        assert tdb.get_seq(u, 1) == jdb.get_seq(u, 1)
    assert tdb.get_seq(2990, 80) == jdb.get_seq(2990, 80)
    for u, n in ((0, 0), (2990, 80), (31, 33), (0, jdb.genome_length),
                 (6990, 30), (jdb.genome_length - 5, 5)):
        want = jdb.get_nmask(u, n)
        got = tdb.get_nmask(u, n)
        assert got.dtype == want.dtype and np.array_equal(got, want), (u, n)
    coords = np.array([5, 3100, 8000, 10_000], np.int64)
    alts = np.array([1, 2, 3, 0], np.uint8)
    assert jdb.add_snp_index(coords, alts) == tdb.add_snp_index(coords, alts)
    assert_db_equal(jdb, tdb)
    # each package loads what the other saved
    tdb.save(str(d / "t"))
    jdb.save(str(d / "j"))
    assert_db_equal(jbuild.GenomeDB.load(str(d / "t")),
                    build.GenomeDB.load(str(d / "j")))
    seqs = [("x", "ACGTNACGT" * 30), ("y", "TTGCA" * 40)]
    for j, t in zip(jbuild.build_kmer_index(*jbuild.dna.encode(seqs[0][1]),
                                            k=5, interval=2),
                    build.build_kmer_index(*build.dna.encode(seqs[0][1]),
                                           k=5, interval=2)):
        assert j.dtype == t.dtype and np.array_equal(j, t)
    assert_db_equal(jbuild.build_db_from_seqs(seqs, k=5),
                    build.build_db_from_seqs(seqs, k=5))


def test_fasta_fastq_reading_matches(tmp_path):
    fa = tmp_path / "r.fa"
    fa.write_text("\n>r1 first read\nACGT\nNNAC\n>r2\r\nGGGT\r\n>r3  x y\n")
    fq = tmp_path / "r.fq"
    fq.write_text("@q1 d\nACGTN\n+\nIIII#\n\n@q2\nTT\n+q2\n!!\n")
    gz = tmp_path / "r.fq.gz"
    gz.write_bytes(gzip.compress(fq.read_bytes()))
    for pj, pt, path in ((jfasta.read_fasta, fasta.read_fasta, fa),
                         (jfasta.read_fastq, fasta.read_fastq, fq),
                         (jfasta.read_seqs, fasta.read_seqs, fa),
                         (jfasta.read_seqs, fasta.read_seqs, gz)):
        want = [dataclasses.astuple(r) for r in pj(path)]
        assert want and [dataclasses.astuple(r) for r in pt(path)] == want
    with pytest.raises(ValueError):
        list(fasta.read_fastq(fa))


@pytest.mark.parametrize("level", ["site", "intron"])
def test_iit_and_known_splicing_match(dbs, tmp_path, level):
    """A site-level map (typed donor/acceptor entries, both strands) and
    an intron-level one, written by tpumap's iit_store, read by both
    packages and turned into KnownSplicing."""
    jdb, tdb, _d = dbs
    if level == "site":
        text = (">d1 chrA:100..101 donor\n>a1 chrA:400..401 acceptor\n"
                ">d2 chrA:901..900 donor\n>a2 chrA:601..600 acceptor\n"
                ">d3 chrM:50..51 donor\n>x chrZ:5..6 donor\n")
    else:
        text = (">i1 chrA:100..400\n>i2 chrA:900..600\n"
                ">i3 chrM:1000..1200\n")
    entries = jiit.parse_map_fasta(io.StringIO(text))
    path = tmp_path / "sp.iit"
    jiit.build_iit(entries).write(str(path))
    ji, ti = jiit.IIT.read(str(path)), iit.IIT.read(str(path))
    assert (ti.version, ti.divs, ti.typestrings, ti.labels) == (
        ji.version, ji.divs, ji.typestrings, ji.labels)
    for a, b in zip(ji.divdata, ti.divdata):
        for f in ("lows", "highs", "signs", "types"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
    jk = JKnownSplicing.from_splicing_iit(ji, jdb)
    tk = KnownSplicing.from_splicing_iit(ti, tdb)
    for f in dataclasses.fields(jk):
        a, b = getattr(jk, f.name), getattr(tk, f.name)
        assert a.dtype == b.dtype and np.array_equal(a, b), f.name
    assert len(tk.donor) + len(tk.antidonor) >= 2


def test_batch_encoder_matches():
    """make_batch through the host library's encode_packed_batch (codes,
    N flags, packed words, quals) equals tpumap's on the same records."""
    rng = np.random.default_rng(9)
    recs = []
    for i in range(40):
        n = int(rng.integers(0, 130))
        s = "".join("ACGTNacgtnRY"[j] for j in rng.integers(0, 12, n))
        q = ("".join(chr(33 + int(x)) for x in rng.integers(0, 42, n))
             if i % 3 else None)
        recs.append((f"r{i}", s, q))
    assert driver.native.get_lib() is not None
    for quals in (False, True):
        jb = jdriver.make_batch(
            [jfasta.Record(a, "", s, q if quals else None)
             for a, s, q in recs], 48, 128)
        tb = driver.make_batch(
            [fasta.Record(a, "", s, q if quals else None)
             for a, s, q in recs], 48, 128)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert np.array_equal(np.asarray(jb[k]), np.asarray(tb[k])), k


def test_sam_text_matches(dbs):
    """The SAM header and each record shape as text, per-record and bulk
    (the C emitters), from both packages' modules on their own dbs."""
    jdb, tdb, _d = dbs
    assert sam.header(tdb, "x -y", rg="g1", rg_name="s") == jsam.header(
        jdb, "x -y", rg="g1", rg_name="s")
    assert "@PG\tID:tpumap\tPN:tpumap\tVN:0.1.0" in sam.header(tdb)
    read = jdb.get_seq(1000, 60)
    mut = read[:10] + ("A" if read[10] != "A" else "C") + read[11:]
    ks_args = ([1035], [1235], [1])
    jk, tk = JKnownSplicing.from_junctions(*ks_args), \
        KnownSplicing.from_junctions(*ks_args)
    cases = [
        ("ungapped_record", ("q", mut, "I" * 60, 1000, 0, 40, 1), {}),
        ("ungapped_record", ("q", mut, None, 1000, 1, 3, 1),
         dict(q_start=2, q_end=55)),
        ("ungapped_record", ("q", mut, None, 1000, 0, 3, 1),
         dict(space="ct")),
        ("gapped_record", ("q", read, "J" * 60, 1000, 1, 20,
                           [0] * 20 + [1] * 2 + [0] * 20 + [2] * 3
                           + [0] * 18), {}),
        ("path_record", ("q", read, None, [(0, 1000), (35, 1200)], 0, 60,
                         0, 30), dict(known=None)),
        ("path_record", ("q", read, None, [(0, 1000), (35, 1200)], 0, 60,
                         0, 30), dict(known="k")),
        ("path_record", ("q", read, None, [(2, 1000), (30, 1004),
                                           (40, 1002)], 2, 58, 1, 30), {}),
    ]
    for name, args, kw in cases:
        jkw = {k: (jk if v == "k" else v) for k, v in kw.items()}
        tkw = {k: (tk if v == "k" else v) for k, v in kw.items()}
        want = getattr(jsam, name)(jdb, *args, **jkw).line()
        assert getattr(sam, name)(tdb, *args, **tkw).line() == want, name
    assert sam.unmapped_record("q", read, None).line() == \
        jsam.unmapped_record("q", read, None).line()
    # the bulk ungapped emitter
    B, L = 3, 64
    recs_j = [jfasta.Record(f"b{i}", "", read) for i in range(B)]
    recs_t = [fasta.Record(f"b{i}", "", read) for i in range(B)]
    codes = np.zeros((B, L), np.uint8)
    codes[:, :60] = jbuild.dna.encode(read)[0]
    args = (codes, np.zeros((B, L), bool), np.full(B, 60, np.int32),
            np.array([1000, 1001, 5000], np.uint64), np.array([0, 1, 0]),
            np.array([40, 3, 0]), np.array([1, 2, 1]),
            np.array([0, 3, 0]), np.array([60, 60, 50]),
            np.array([1, 1, 0], np.uint8))
    want = jsam_bulk.emit_ungapped_bulk(jdb, recs_j, *args)
    assert want is not None
    assert sam_bulk.emit_ungapped_bulk(tdb, recs_t, *args) == want


def test_device_index_defaults_to_the_card(dbs):
    """from_host puts the index on the card when no device is named, and
    raises (never falls back to the CPU) where there is no CUDA device."""
    _jdb, tdb, _d = dbs
    if torch.cuda.is_available():
        assert DeviceIndex.from_host(tdb).genome_packed.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DeviceIndex.from_host(tdb)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DeviceIndex.from_jax_arrays({})
    assert DeviceIndex.from_host(tdb, "cpu").genome_packed.device.type == "cpu"


def test_gmap_main_runs_without_tpumap_and_jax(tmp_path):
    """gmap_cli.main --device cpu where JAX and tpumap cannot be
    imported gives the in-process run's GFF3 and PSL."""
    from tpumap_torch.cli import gmap_cli
    db, _recs, qfa = gmap_world(tmp_path, port=True)
    db.save(str(tmp_path / "db"))
    argvs = [["-D", str(tmp_path / "db"), "-f", fmt, str(qfa), "--device",
              "cpu"] for fmt in ("3", "1")]
    want = []
    for argv in argvs:
        buf = io.StringIO()
        with redirect_stdout(buf):
            gmap_cli.main(argv)
        want.append(buf.getvalue())
    script = NO_TPUMAP + f"""
import io
from contextlib import redirect_stdout
sys.path[:0] = [{str(REPO)!r}]
import torch
torch.set_num_threads(1)
from tpumap_torch.cli import gmap_cli
for argv in {argvs!r}:
    buf = io.StringIO()
    with redirect_stdout(buf):
        gmap_cli.main(argv)
    sys.stdout.write(buf.getvalue() + "=====\\n")
assert sys.modules["jax"] is None
assert not [m for m in sys.modules if m.split(".")[0] == "tpumap"]
"""
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr.decode()[-3000:]
    got = r.stdout.decode().split("=====\n")[:2]
    assert got == want and "cDNA_match" in want[0]


def test_gsnap_main_and_tools_run_without_tpumap_and_jax(tmp_path):
    """Where JAX and tpumap cannot be imported, the port's index and map
    tools (build_cli, the converters, iit_cli store, trindex_cli,
    snpindex_cli, modeindex_cli) make gsnap_cli_world's inputs, and
    gsnap_cli.main --device cpu gives the in-process run's SAM on them:
    DNA, -N 1 -s, paired, -c, -v and cmet."""
    from tpumap_torch.cli import gsnap_cli
    from torch_workloads import gsnap_cli_world
    lists = [["{R}"], ["-N", "1", "-s", "{SS}", "{R}"], ["{R1}", "{R2}"],
             ["-c", "tr", "{R}"], ["-A", "default", "{R}"]]

    def argvs(w):
        return ([["-D", w["D"], "--device", "cpu"]
                 + [a.format(**w) for a in x] for x in lists]
                + [["-D", w["SNPD"], "-v", w["R"], "--device", "cpu"],
                   ["-D", w["CMETD"], "--mode", "cmet-stranded", w["R"],
                    "--device", "cpu"]])

    (tmp_path / "a").mkdir()
    w = gsnap_cli_world(tmp_path / "a", port=True)
    want = []
    for argv in argvs(w):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert gsnap_cli.main(argv) == 0
        want.append(buf.getvalue().replace(str(tmp_path / "a"), ""))
    script = NO_TPUMAP + f"""
import io, pathlib
from contextlib import redirect_stdout
sys.path[:0] = [{str(REPO)!r}, {str(REPO / "tests")!r}]
import torch
torch.set_num_threads(1)
from torch_workloads import gsnap_cli_world
from tpumap_torch.cli import gsnap_cli
root = pathlib.Path({str(tmp_path / "b")!r})
root.mkdir()
w = gsnap_cli_world(root, port=True)
lists = {lists!r}
argvs = ([["-D", w["D"], "--device", "cpu"]
          + [a.format(**w) for a in x] for x in lists]
         + [["-D", w["SNPD"], "-v", w["R"], "--device", "cpu"],
            ["-D", w["CMETD"], "--mode", "cmet-stranded", w["R"],
             "--device", "cpu"]])
for argv in argvs:
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert gsnap_cli.main(argv) == 0
    sys.stdout.write(buf.getvalue().replace(str(root), "") + "=====\\n")
assert sys.modules["jax"] is None
assert not [m for m in sys.modules if m.split(".")[0] == "tpumap"]
"""
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr.decode()[-3000:]
    got = r.stdout.decode().split("=====\n")[:len(want)]
    assert got == want
    assert all(text.count("\n") > 30 for text in want)


def test_gmap_host_copies_match():
    """MaxEnt donor/acceptor (sense and antisense), translation and the
    canonical splice scores of the port's copies equal tpumap's."""
    rng = np.random.default_rng(12)
    codes = rng.integers(0, 4, 5000).astype(np.uint8)
    nmask = rng.random(5000) < 0.01
    pos = rng.integers(-30, 5030, 400)
    for name in ("donor_prob_at", "acceptor_prob_at", "antidonor_prob_at",
                 "antiacceptor_prob_at"):
        want = getattr(jmaxent, name)(codes, nmask, pos)
        got = getattr(maxent, name)(codes, nmask, pos)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    for a, b in ((0, 1), (7, 5), (900, 1100)):
        cand = np.arange(a, b)
        assert [x.tolist() if hasattr(x, "tolist") else x for x in
                splice.splice_score_canonical(codes, 10, 700, cand)] == \
            [x.tolist() if hasattr(x, "tolist") else x for x in
             jsplice.splice_score_canonical(codes, 10, 700, cand)]
    for alt in (False, True):
        translation.set_alt_start_codons(alt)
        jtranslation.set_alt_start_codons(alt)
        for n in (0, 2, 99, 1000):
            c = codes[:n]
            assert translation.translate_codes(c) == \
                jtranslation.translate_codes(c)
            assert translation.best_orf(c) == jtranslation.best_orf(c)
            assert translation.best_orf(c, fulllength=True) == \
                jtranslation.best_orf(c, fulllength=True)
    translation.set_alt_start_codons(False)
    jtranslation.set_alt_start_codons(False)


def test_maxent_tables_are_the_ports_own():
    """The port loads tpumap_torch/data/maxent_tables.npz, a copy of
    tpumap's, never tpumap/data/."""
    path = pathlib.Path(maxent._DATA)
    assert path == REPO / "tpumap_torch" / "data" / "maxent_tables.npz"
    assert path.read_bytes() == pathlib.Path(jmaxent._DATA).read_bytes()
    tabs = maxent.tables()
    for k, v in jmaxent.tables().items():
        assert np.array_equal(tabs[k], v), k
