"""The port's paired-end path against tpumap (JAX on CPU).

The same numpy inputs go through tpumap and through the port's plain
versions: the concordance reduction (FR, RF, FF; INVALID lanes, wrapped
differences, dense ties), the mate rescue scan (windows past the genome
end and across 2^32), the fused paired program's dict, and the SAM of
align_paired_records, list and sink, on one shared index whose
chromosomes are the worlds of tests/test_paired.py (concordant pairs,
the exhaustive fallback's decoy, a spliced end) and
tests/test_mate_repair.py (a repaired repetitive spliced mate, an
unrepairable one, a dovetail with --resolve-inner on and off), run as
DNA, as RNA with mate repair and with known splicing; and on
tests/test_stream.py's paired workload over several batches. Every
quantity is an integer, so values and dtypes must be equal.
"""
import io
import pathlib
import subprocess
import sys
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumap.gsnap import driver as jdriver
from tpumap.gsnap import engine as jengine
from tpumap.gsnap import ladder as jladder
from tpumap.gsnap import paired as jpaired
from tpumap.gsnap.knownsplicing import KnownSplicing
from tpumap.index import build_db
from tpumap.index.device import DeviceIndex as JaxIndex
from tpumap.io.fasta import Record
from tpumap.ops import pathdp as jpathdp
from tpumap.utils import dna
from tpumap.utils.fetch import device_fetch, widen_ints
from tpumap_torch.cli import gsnap_cli
from tpumap_torch.gsnap import driver, engine, ladder, paired
from tpumap_torch.gsnap.knownsplicing import known_to_device
from tpumap_torch.index.device import DeviceIndex
from tpumap_torch.ops import pathdp
from torch_workloads import NO_TPUMAP, mend_tlen, mixed_workload, stream_pairs

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parent.parent
INVALID = 0xFFFFFFFF


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def same(want, got):
    """tpumap's uint32 arrays against the port's int64 values; every
    other dtype exactly."""
    a = np.asarray(want)
    b = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    if a.dtype == np.uint32:
        assert b.dtype == np.int64, b.dtype
        b = b.astype(np.uint32)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def pair_text(pairs) -> bytes:
    return b"".join((a.lines() + b.lines()).encode() for a, b in pairs)


# ------------------------------------------------------ concordance

def concordance_inputs(seed, P=96, K=8):
    rng = np.random.default_rng(seed)
    d1 = rng.integers(0, 20_000, (P, K)).astype(np.uint32)
    d2 = rng.integers(0, 20_000, (P, K)).astype(np.uint32)
    for p in range(0, P, 2):          # concordant-looking partners
        d2[p, :3] = d1[p, :3] + rng.integers(-900, 900, 3).astype(np.uint32)
    d1[:8, 0] = [0, 1, 5, 2 ** 32 - 5, 2 ** 32 - 300, 7, 100, 2 ** 32 - 2]
    d2[:8, 0] = [2 ** 32 - 100, 2 ** 32 - 1, 400, 200, 2 ** 32 - 50, 0,
                 2 ** 32 - 500, 150]
    s1 = rng.integers(0, 2, (P, K)).astype(np.int32)
    s2 = rng.integers(0, 2, (P, K)).astype(np.int32)
    n1 = rng.integers(0, 2, (P, K)).astype(np.int32)     # dense ties
    n2 = rng.integers(0, 2, (P, K)).astype(np.int32)
    n1[rng.random((P, K)) < 0.1] = 2 ** 15
    d1[rng.random((P, K)) < 0.2] = INVALID
    d2[rng.random((P, K)) < 0.2] = INVALID
    d1[P - 2:] = INVALID                                  # no candidate
    L1 = rng.integers(50, 151, P).astype(np.int32)
    L2 = rng.integers(50, 151, P).astype(np.int32)
    return d1, s1, n1, L1, d2, s2, n2, L2


@pytest.mark.parametrize("orientation,pairmax,pairexpect,pairdev", [
    ("FR", 1000, 400, 100), ("RF", 1000, 1000, 100), ("FF", 1000, 300, 50),
    ("FR", 2000, 1000, 0), ("FF", 600, 1000, 100)])
def test_concordance_device_matches(orientation, pairmax, pairexpect,
                                    pairdev):
    d1, s1, n1, L1, d2, s2, n2, L2 = concordance_inputs(pairmax + pairdev)
    want = jpaired.concordance_device(
        jnp.asarray(d1), jnp.asarray(s1), jnp.asarray(n1), jnp.asarray(L1),
        jnp.asarray(d2), jnp.asarray(s2), jnp.asarray(n2), jnp.asarray(L2),
        pairmax, orientation, pairexpect, pairdev)
    got = ladder.concordance_device(
        t(d1.astype(np.int64)), t(s1), t(n1), t(L1), t(d2.astype(np.int64)),
        t(s2), t(n2), t(L2), pairmax, orientation, pairexpect, pairdev)
    for a, b in zip(want, got):
        same(a, b)
    valid = np.asarray(want[2])
    assert valid.any() and not valid.all()


# ------------------------------------------------------ the worlds

def paired_case_chrom():
    """tests/test_paired.py's paired_case: 40 FR pairs, inserts 250-500."""
    rng = np.random.default_rng(11)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 40000))
    comp = str.maketrans("ACGT", "TGCA")
    pairs = []
    for r in range(40):
        p = int(rng.integers(0, len(seq) - 600))
        insert = int(rng.integers(250, 500))
        pairs.append((seq[p:p + 100],
                      seq[p + insert - 100:p + insert].translate(comp)[::-1]))
    return seq, pairs


def exhaustive_chrom():
    """tests/test_paired.py's exhaustive-fallback world: mate 2's exact
    decoy far away, its true place two substitutions off."""
    rng = np.random.default_rng(31)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 30000))
    p = 5000
    mate_region = seq[p + 300:p + 400]
    true_m = list(mate_region)
    for j in (10, 60):
        true_m[j] = "ACGT"[("ACGT".index(true_m[j]) + 1) % 4]
    genome = (seq[:p + 300] + "".join(true_m) + seq[p + 400:20000]
              + mate_region + seq[20000:])
    return genome, [(seq[p:p + 100], dna.revcomp(mate_region))]


def repair_chrom():
    """tests/test_mate_repair.py's world: a 400-bp repeat unit with a
    GT..AG intron in 41 copies, one of them in the anchor's mate window;
    pairs: the spliced repetitive mate, an unrepairable mate, a
    dovetail."""
    rng = np.random.default_rng(17)
    g = list("ACGT"[i] for i in rng.integers(0, 4, 80000))
    ru = list("ACGT"[i] for i in rng.integers(0, 4, 400))
    ru[60:62] = list("GT")
    ru[258:260] = list("AG")
    for j in range(40):
        g[j * 1000:j * 1000 + 400] = ru
    g[75200:75600] = ru
    s = "".join(g)
    junk = "".join("ACGT"[i] for i in np.random.default_rng(5).integers(
        0, 4, 100))
    return s, [(s[75000:75100], dna.revcomp(s[75200:75260] + s[75460:75500])),
               (s[75000:75100], junk),
               (s[60000:60100], dna.revcomp(s[59980:60080]))]


def spliced_end_chrom():
    """tests/test_paired.py's spliced end: mate 1 spans an intron."""
    rng = np.random.default_rng(41)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 30000))
    E1, E2 = 5000, 9000
    return seq, [(seq[E1 - 20:E1 + 30] + seq[E2:E2 + 50],
                  dna.revcomp(seq[E2 + 300:E2 + 400]))]


WORLDS = {"case": paired_case_chrom, "exhaustive": exhaustive_chrom,
          "repair": repair_chrom, "spliced": spliced_end_chrom}
# the runs: name -> align_paired_records keywords (the same for both
# packages)
RUNS = {
    "dna": dict(pairmax=1000),
    "rna": dict(pairmax=2000, novelsplicing=True, max_intron=10_000),
    "known": dict(pairmax=1000, known=True),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One index over the worlds, tpumap's SAM per run (list and sink;
    resolve_inner off for the DNA run too) and its fused dicts."""
    root = tmp_path_factory.mktemp("tpaired")
    text, pairs, owner = [], [], []
    for name, make in WORLDS.items():
        seq, ps = make()
        text.append(f">{name}\n{seq}\n")
        for k, (a, b) in enumerate(ps):
            pairs.append((Record(f"{name}{k}", "", a),
                          Record(f"{name}{k}", "", b)))
            owner.append(name)
    (root / "g.fa").write_text("".join(text))
    db = build_db(root / "g.fa", name="pw", k=12, interval=3)
    # known introns: the spliced end's and the repeat unit's copy in the
    # repair world's mate window
    offs = {n: int(db.chrom_offsets[i]) for i, n in enumerate(db.chrom_names)}
    ks = KnownSplicing.from_junctions(
        [offs["spliced"] + 5030, offs["repair"] + 75260],
        [offs["spliced"] + 9000, offs["repair"] + 75460], [1, 1])
    ji = JaxIndex.from_host(db)
    want, dicts = {}, {}
    for run, kw in RUNS.items():
        kw = dict(kw, known=ks if kw.get("known") else None)
        want[run] = pair_text(jpaired.align_paired_records(
            db, ji, pairs, jengine.AlignConfig(), **kw))
        chunks = []
        jpaired.align_paired_records(db, ji, pairs, jengine.AlignConfig(),
                                     sink=chunks.append, **kw)
        assert b"".join(bytes(c) for c in chunks) == want[run]
        # the fused program's dict of the run's one batch
        B, L = 2 * len(pairs), 128
        B = jdriver.pad_to_bucket(B)
        batch = jdriver.make_batch([r for p in pairs for r in p], B, L)
        sc = jpathdp.PathScoring(max_intron=max(kw.get("max_intron",
                                                       200_000), 9))
        novel = kw.get("novelsplicing", False)
        dicts[run] = (batch, widen_ints(device_fetch(jladder.align_pair_full(
            ji, jdriver._pack_batch(batch), jengine.AlignConfig(), L, sc,
            novel or kw["known"] is not None, novel,
            min(max(8192, B // 2), B), min(max(2048, B // 8), B),
            min(2048, B), kw["pairmax"], "FR", 1000, 100,
            known=None if kw["known"] is None else ks.to_device()))))
    want["dna_outer"] = pair_text(jpaired.align_paired_records(
        db, ji, pairs, jengine.AlignConfig(), resolve_inner=False,
        **RUNS["dna"]))
    return db, pairs, owner, ks, want, dicts


def port_pairs(db, pairs, ks, run, sink, **extra):
    kw = dict(RUNS[run], **extra)
    kw["known"] = ks if kw.get("known") else None
    ti = DeviceIndex.from_host(db, "cpu")
    if not sink:
        return pair_text(paired.align_paired_records(
            db, ti, pairs, engine.AlignConfig(), **kw))
    chunks = []
    assert paired.align_paired_records(db, ti, pairs, engine.AlignConfig(),
                                       sink=chunks.append, **kw) == []
    return b"".join(bytes(c) for c in chunks)


def by_world(blob, owner):
    lines = blob.decode().splitlines()
    assert len(lines) == 2 * len(owner)
    out = {}
    for k, w in enumerate(owner):
        out.setdefault(w, []).extend(lines[2 * k:2 * k + 2])
    return out


@pytest.mark.parametrize("sink", [False, True])
@pytest.mark.parametrize("run", list(RUNS))
def test_worlds_pair_sam(world, run, sink):
    """tpumap's SAM but for TLEN where a mate is gapped, spliced or
    repaired: the port measures it to that mate's aligned end, tpumap to
    its start plus the read's length (mend_tlen)."""
    db, pairs, owner, ks, want, _dicts = world
    got = port_pairs(db, pairs, ks, run, sink)
    mended, changed = mend_tlen(want[run], RUNS[run]["pairmax"])
    w, g = by_world(mended, owner), by_world(got, owner)
    for name in WORLDS:
        assert g[name] == w[name], name
    f = [ln.split("\t") for ln in w["case"]]
    assert sum(int(x[1]) & 2 != 0 for x in f) >= 76      # proper pairs
    rep = [ln.split("\t") for ln in w["repair"]]
    exh = [ln.split("\t") for ln in w["exhaustive"]]
    assert int(exh[1][3]) - 5301 in range(-2, 3)         # re-placed mate
    assert rep[4][5] == "80M20S" and rep[5][5] == "20S80M"   # dovetail
    if run == "rna":
        assert rep[1][5] == "60M200N40M" and rep[1][3] == "75201"  # repair
        assert int(rep[3][1]) & 4                        # not invented
        assert "3970N" in w["spliced"][0]
        # the repaired mate ends its 200-base intron past tpumap's end,
        # the one TLEN that differs; the spliced end's pair spans 4,420
        # bases by either measure, past pairmax
        jrep = by_world(want[run], owner)["repair"]
        assert [ln.split("\t")[8] for ln in jrep[:2]] == ["300", "-300"]
        assert [f[8] for f in rep[:2]] == ["500", "-500"]
        spl = [ln.split("\t") for ln in w["spliced"]]
        assert [f[8] for f in spl] == ["0", "0"]
        assert not int(spl[0][1]) & 2
        assert changed == 1
    else:
        assert changed == 0


def test_resolve_inner_off_sam(world):
    db, pairs, owner, ks, want, _dicts = world
    got = port_pairs(db, pairs, ks, "dna", False, resolve_inner=False)
    assert got == want["dna_outer"]
    rep = by_world(want["dna_outer"], owner)["repair"]
    assert [ln.split("\t")[5] for ln in rep[4:6]] == ["100M", "100M"]


@pytest.mark.parametrize("run", list(RUNS))
def test_align_pair_full_dict_matches(world, run):
    """Every key of tpumap's fused paired program, in values and wire
    dtypes; no cand_* or sec_* keys."""
    db, pairs, _owner, ks, _want, dicts = world
    batch, want = dicts[run]
    kw = RUNS[run]
    B, L = batch["codes"].shape
    novel = kw.get("novelsplicing", False)
    got = ladder.fetch_result(ladder.align_pair_full(
        DeviceIndex.from_host(db, "cpu"), driver._to_device(batch, "cpu"),
        engine.AlignConfig(), L,
        pathdp.PathScoring(max_intron=max(kw.get("max_intron", 200_000), 9)),
        novel or kw.get("known", False), novel, min(max(8192, B // 2), B),
        min(max(2048, B // 8), B), min(2048, B), kw["pairmax"], "FR", 1000,
        100, known=known_to_device(ks, "cpu") if kw.get("known") else None))
    assert sorted(got) == sorted(want)
    assert not any(k.startswith(("cand_", "sec_")) for k in got)
    for key in want:
        a, b = np.asarray(want[key]), np.asarray(got[key])
        assert a.dtype == b.dtype, (key, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=key)
    assert want["pe_valid"][:len(pairs)].sum() >= 40


@pytest.mark.parametrize("window", [1000, 2000])
def test_rescue_mate_matches(world, window):
    """Mates placed in their window, mutated ones, windows past the
    genome end and wrapping past 2^32 (tied first offsets)."""
    db, _pairs, _owner, _ks, _want, _dicts = world
    rng = np.random.default_rng(window)
    glen = db.genome_length
    R, L = 64, 128
    bases = rng.integers(0, glen - window, R).astype(np.uint32)
    bases[:6] = [glen - 100, glen + 10, 2 ** 32 - 300, 0, glen - window,
                 2 ** 32 - window]
    codes = np.zeros((R, L), np.uint8)
    lengths = np.full(R, 100, np.int32)
    lengths[6:10] = [1, 16, 17, 128]
    g = db.get_codes(0, glen)
    for r in range(R):
        at = int(min(bases[r], glen - 200)) + int(rng.integers(0, 100))
        li = int(lengths[r])
        codes[r, :li] = g[at:at + li] if li <= 128 else 0
        if r % 3 == 1:
            codes[r, rng.integers(0, li, 3)] ^= 1
    want = jpaired.rescue_mate(JaxIndex.from_host(db), jnp.asarray(codes),
                               jnp.asarray(lengths), window,
                               jnp.asarray(bases))
    got = paired.rescue_mate(DeviceIndex.from_host(db, "cpu"), t(codes), t(lengths),
                             window, t(bases.astype(np.int64)))
    for a, b in zip(want, got):
        same(a, b)


# ------------------------------------------------------ stream workload

@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    db, _reads, _gfa = mixed_workload(tmp_path_factory.mktemp("tpstream"))
    pairs = stream_pairs(db)
    want = pair_text(jpaired.align_paired_records(
        db, JaxIndex.from_host(db), pairs,
        jengine.AlignConfig(top_k=4, max_occ=8), batch_size=16,
        pairmax=1000))
    return db, pairs, want


@pytest.mark.parametrize("sink", [False, True])
def test_stream_paired_workload_sam(stream, sink):
    """tpumap's bytes exactly: no proper pair of the workload has a
    gapped mate, so the port's TLEN measure changes none."""
    db, pairs, want = stream
    assert mend_tlen(want, 1000) == (want, 0)
    ti = DeviceIndex.from_host(db, "cpu")
    cfg = engine.AlignConfig(top_k=4, max_occ=8)
    if sink:
        chunks = []
        paired.align_paired_records(db, ti, pairs, cfg, batch_size=16,
                                    pairmax=1000, sink=chunks.append)
        got = b"".join(bytes(c) for c in chunks)
    else:
        got = pair_text(paired.align_paired_records(
            db, ti, pairs, cfg, batch_size=16, pairmax=1000))
    assert got == want


def test_paired_runs_without_jax(stream, tmp_path):
    """One paired batch of the port in a process where neither JAX
    nor tpumap can be imported gives tpumap's SAM."""
    want = stream[2]
    script = NO_TPUMAP + f"""
import pathlib
sys.path[:0] = [{str(REPO)!r}, {str(REPO / "tests")!r}]
import torch
torch.set_num_threads(1)
from torch_workloads import mixed_workload, stream_pairs
from tpumap_torch.gsnap.paired import align_paired_records
from tpumap_torch.gsnap.engine import AlignConfig
from tpumap_torch.index.device import DeviceIndex
db, _reads, _ = mixed_workload(pathlib.Path({str(tmp_path)!r}), port=True)
align_paired_records(db, DeviceIndex.from_host(db, "cpu"),
                     stream_pairs(db, port=True),
                     AlignConfig(top_k=4, max_occ=8), batch_size=16,
                     pairmax=1000, sink=sys.stdout.buffer.write)
assert sys.modules["jax"] is None
assert not [m for m in sys.modules if m.split(".")[0] == "tpumap"]
"""
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert r.stdout == want


# ------------------------------------------------------ entry point

def test_main_paired_known_cpu(world, tmp_path):
    """gsnap_cli.main with a mate file, --pairmax, --orientation and -s
    (an IIT of the known introns) on --device cpu gives tpumap's
    pairs."""
    from tpumap.cli.iit_cli import store_main
    db, pairs, _owner, ks, want, _dicts = world
    db.save(str(tmp_path / "db"))
    for k in (0, 1):
        (tmp_path / f"r{k + 1}.fa").write_text("".join(
            f">{p[k].accession}\n{p[k].sequence}\n" for p in pairs))
    lines = []
    for j, (d, a) in enumerate(np.asarray(ks.junctions).tolist()):
        c, pos = db.chrpos(int(d))
        lines.append(f">i{j} {c}:{pos}..{db.chrpos(int(a))[1] + 1} intron\n")
    (tmp_path / "sp.fa").write_text("".join(lines))
    with redirect_stdout(io.StringIO()):
        store_main(["-o", str(tmp_path / "sp"), str(tmp_path / "sp.fa")])
    argv = ["-D", str(tmp_path / "db"), str(tmp_path / "r1.fa"),
            str(tmp_path / "r2.fa"), "--device", "cpu", "--batch-size",
            "512", "--pairmax", "1000", "--orientation", "FR", "-s",
            str(tmp_path / "sp.iit")]
    buf = io.StringIO()
    with redirect_stdout(buf):
        gsnap_cli.main(argv)
    body = "".join(ln + "\n" for ln in buf.getvalue().splitlines()
                   if not ln.startswith("@"))
    assert body.encode() == want["known"]


def test_main_paired_refuses_missing_card(world, tmp_path, monkeypatch):
    db, pairs, _owner, _ks, _want, _dicts = world
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        gsnap_cli.main(["-D", str(tmp_path / "db"), str(tmp_path / "r1.fa"),
                        str(tmp_path / "r2.fa"), "--pairmax", "1000"])


@pytest.mark.parametrize("option", ["tr", "known_indels", "device_ctx",
                                    "mode", "snp_tolerant"])
def test_unported_paired_options_raise(world, option):
    """Device meshes (device_ctx: tpumap's MeshContext on 8 virtual
    devices, the port's on 8 `cpu` devices), the staged paired path (tr,
    known_indels), the alignment mode and SNP tolerance are ported: the
    port accepts them and gives tpumap's SAM on the same pairs (no mode
    or SNP tables here, so both fall back to the standard ones, as in
    tpumap; a transcriptome of one two-exon gene over the world's
    genome)."""
    db, pairs, _owner, _ks, _want, _dicts = world
    ti = DeviceIndex.from_host(db, "cpu")
    jkw, tkw = {}, {}
    if option == "device_ctx":
        from tpumap.parallel import mesh as jmesh
        from tpumap.parallel import pipeline as jpipe
        from tpumap_torch.parallel import mesh, pipeline
        jkw["device_ctx"] = jpipe.MeshContext(jmesh.make_mesh(8), db)
        tkw["device_ctx"] = pipeline.MeshContext(
            mesh.make_mesh(devices=[torch.device("cpu")] * 8), db)
    elif option == "known_indels":
        from tpumap.gsnap.knownindels import KnownIndels as JKnownIndels
        from tpumap_torch.gsnap.knownindels import KnownIndels
        none = (np.zeros(0, np.uint64), np.zeros(0, np.int32),
                np.zeros(0, np.int64))
        jkw["known_indels"] = JKnownIndels(*none)
        tkw["known_indels"] = KnownIndels(*none)
    elif option == "tr":
        from tpumap.gsnap.transcriptome import build_transcriptome as jbuild
        from tpumap.io.iit import build_iit as jbuild_iit
        from tpumap.io.iit import parse_map_fasta as jparse
        from tpumap_torch.gsnap.transcriptome import build_transcriptome
        from tpumap_torch.io.iit import build_iit, parse_map_fasta
        genes = (f">TRA {db.chrom_names[0]}:1001..3100 gene\nGENEA NM_A\n"
                 "1001 1200\n3001 3100\n")
        jtr = jbuild(db, jbuild_iit(jparse(io.StringIO(genes))), name="tr",
                     k=10, interval=1)
        ttr = build_transcriptome(db, build_iit(parse_map_fasta(
            io.StringIO(genes))), name="tr", k=10, interval=1)
        jkw["tr"], tkw["tr"] = (jtr, None), (ttr, None)
    kw = ({"mode": "cmet-stranded"} if option == "mode"
          else {"snp_tolerant": True} if option == "snp_tolerant" else {})
    want = pair_text(jpaired.align_paired_records(
        db, JaxIndex.from_host(db), pairs[:4], jengine.AlignConfig(**kw),
        **jkw))
    assert pair_text(paired.align_paired_records(
        db, ti, pairs[:4], engine.AlignConfig(**kw), **tkw)) == want
