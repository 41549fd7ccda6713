"""The port's single-end DNA slice against tpumap (JAX on CPU).

The cascade and fused-ladder result dicts must match tpumap's exactly
(keys, numpy dtypes after widen_ints, values), and align_records must
give byte-identical SAM, in list and sink modes, on the mixed stream
workload (substitutions, soft clips, deletions, insertions, unmapped
reads, an N read, FASTQ qualities) and on the synthetic e2e fixture.
The slice must also run where JAX cannot be imported.
"""
import io
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpumap.gsnap import driver as jdriver
from tpumap.gsnap import engine as jengine
from tpumap.gsnap import ladder as jladder
from tpumap.gsnap.params import MIN_INTRON
from tpumap.index import build_db
from tpumap.index.device import DeviceIndex as JaxIndex
from tpumap.io.fasta import Record, read_fasta
from tpumap.ops import pathdp as jpathdp
from tpumap.utils.fetch import device_fetch, widen_ints
from tpumap_torch.gsnap import driver, engine, ladder
from tpumap_torch.ops import pathdp
from tpumap_torch.index.device import DeviceIndex
from torch_workloads import NO_TPUMAP, emit_modes, mixed_workload, sam_text

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    db, reads, gfa = mixed_workload(tmp_path_factory.mktemp("tslice"))
    return db, JaxIndex.from_host(db), DeviceIndex.from_host(db, "cpu"), reads, gfa


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """tests/test_gsnap_e2e.py's synthetic fixture (same generator)."""
    root = tmp_path_factory.mktemp("tsynth")
    rng = np.random.default_rng(123)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 20000))
    genome_fa = root / "genome.fa"
    genome_fa.write_text(">chr1\n" + "\n".join(
        seq[i:i + 60] for i in range(0, len(seq), 60)) + "\n")
    comp = str.maketrans("ACGT", "TGCA")
    lines = []
    for r in range(60):
        p = int(rng.integers(0, len(seq) - 100))
        s = list(seq[p:p + 100])
        for _ in range(int(rng.integers(0, 3))):
            j = int(rng.integers(0, 100))
            s[j] = "ACGT"[int(rng.integers(0, 4))]
        s = "".join(s)
        if rng.random() < 0.5:
            s = s.translate(comp)[::-1]
        lines.append(f">r{r}\n{s}\n")
    reads_fa = root / "reads.fa"
    reads_fa.write_text("".join(lines))
    db = build_db(genome_fa, name="g", k=12, interval=3)
    # test_dirty_ends_clean_middle's reads: substitutions inside both end
    # k-mers, so only the prevalent rung can place them
    rng = np.random.default_rng(77)
    dirty = []
    for r in range(24):
        p = int(rng.integers(0, len(seq) - 100))
        d = list(seq[p:p + 100])
        for j in (3, 96):
            d[j] = "ACGT"[("ACGT".index(d[j]) + 1) % 4]
        dirty.append(Record(f"d{r}", "", "".join(d)))
    return (db, JaxIndex.from_host(db), DeviceIndex.from_host(db, "cpu"),
            {"reads": list(read_fasta(reads_fa)), "dirty_ends": dirty})


CFG = dict(top_k=4, max_occ=8)


def jax_full(db, ji, records, B, L, cfg):
    batch = jdriver.make_batch(records, B, L)
    sc = jpathdp.PathScoring(max_intron=max(200_000, MIN_INTRON))
    r_chain = min(max(8192, B // 2), B)
    dev = jladder.align_batch_full(
        ji, jdriver._pack_batch(batch), cfg, L, sc, False, False, r_chain,
        min(max(2048, B // 8), r_chain), min(2048, B))
    return batch, widen_ints(device_fetch(dev))


@pytest.mark.parametrize("workload", ["mixed", "synthetic"])
def test_align_batch_full_dict_matches(workload, mixed, synthetic):
    db, ji, ti, reads = (mixed[:4] if workload == "mixed"
                         else synthetic[:3] + (synthetic[3]["reads"],))
    B, L = 64, 128
    batch, want = jax_full(db, ji, reads[:B], B, L,
                           jengine.AlignConfig(**CFG))
    r_chain = min(max(8192, B // 2), B)
    got = ladder.fetch_result(ladder.align_batch_full(
        ti, driver._to_device(batch, "cpu"), engine.AlignConfig(**CFG), L,
        pathdp.PathScoring(), False, False, r_chain,
        min(max(2048, B // 8), r_chain), min(2048, B)))
    assert sorted(got) == sorted(want)
    for key in want:
        a, b = np.asarray(want[key]), np.asarray(got[key])
        assert a.dtype == b.dtype, (key, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=key)
    if workload == "mixed":
        assert want["in_sel"].any()         # the indel rows were traced


@pytest.mark.parametrize("has_quals", [False, True])
def test_cascade_packed_matches(mixed, has_quals):
    db, ji, ti, reads, _ = mixed
    B, L = 96, 128
    recs = [Record(r.accession, "", r.sequence,
                   (r.quality or "5" * len(r.sequence)) if has_quals
                   else None) for r in reads]
    batch = jdriver.make_batch(recs, B, L)
    assert ("quals" in batch) == has_quals
    cfg = jengine.AlignConfig(**CFG)
    want = widen_ints(device_fetch(jengine.align_batch_cascaded_packed(
        ji, jdriver._pack_batch(batch), cfg, L)))
    got = engine.align_batch_cascaded_packed(
        ti, driver._to_device(batch, "cpu"), engine.AlignConfig(**CFG), L)
    assert sorted(got) == sorted(want)
    for key in want:
        b = got[key].numpy()
        if b.dtype == np.int64:
            b = b.astype(np.uint32)
        np.testing.assert_array_equal(np.asarray(want[key]), b, err_msg=key)


@pytest.mark.parametrize("sink", [False, True])
def test_stream_workload_sam_identical(mixed, sink):
    db, ji, ti, reads, _ = mixed
    want = sam_text(jdriver.align_records(
        db, ji, reads, jengine.AlignConfig(**CFG), batch_size=32))
    stats = {}
    if sink:
        chunks = []
        assert driver.align_records(
            db, ti, reads, engine.AlignConfig(**CFG), batch_size=32,
            sink=chunks.append, stats=stats) == []
        got = b"".join(bytes(c) for c in chunks)
    else:
        got = sam_text(driver.align_records(
            db, ti, reads, engine.AlignConfig(**CFG), batch_size=32,
            stats=stats))
    assert got == want
    assert sum(stats.get(m, 0) for m in driver.METHODS) == len(reads)
    assert stats["reads"] == stats["rows_native"] + stats["rows_python"] \
        == len(reads)
    cigars = [ln.split("\t")[5] for ln in got.decode().splitlines()]
    assert any("D" in c for c in cigars) and any("I" in c for c in cigars)
    assert any("S" in c for c in cigars) and "*" in cigars


@pytest.mark.parametrize("sink", [False, True])
@pytest.mark.parametrize("batch_size,reads", [(1024, "reads"), (16, "reads"),
                                              (1024, "dirty_ends")])
def test_e2e_fixture_sam_identical(synthetic, sink, batch_size, reads):
    db, ji, ti, workloads = synthetic
    records = workloads[reads]
    want = sam_text(jdriver.align_records(
        db, ji, records, jengine.AlignConfig(), batch_size=batch_size))
    if sink:
        chunks = []
        driver.align_records(db, ti, records, engine.AlignConfig(),
                             batch_size=batch_size, sink=chunks.append)
        got = b"".join(bytes(c) for c in chunks)
    else:
        got = sam_text(driver.align_records(db, ti, records,
                                            engine.AlignConfig(),
                                            batch_size=batch_size))
    assert got == want


@pytest.mark.parametrize("workload,want", [
    ("mixed", {"unmapped", "ungapped", "soft-clipped"}),
    ("dirty_ends", {"ungapped"})])
def test_list_and_stream_mode_emit_alike(mixed, synthetic, workload, want):
    """List mode's records are the stream mode's bytes, row for row:
    both take their native rows from the one C call. The mixed
    workload holds unmapped, ungapped and soft-clipped native rows (its
    indel rows go through the Python records), the dirty-ends reads
    ungapped rows alone."""
    if workload == "mixed":
        db, _ji, ti, reads, _ = mixed
        kinds = emit_modes(db, ti, reads, engine.AlignConfig(**CFG),
                           batch_size=32)
    else:
        db, _ji, ti, workloads = synthetic
        kinds = emit_modes(db, ti, workloads["dirty_ends"],
                           engine.AlignConfig(), batch_size=1024)
    assert set(kinds) == want


@pytest.fixture(scope="module")
def repeats(tmp_path_factory):
    """A genome with a 400 bp block copied three times: reads from it
    multimap (n_best > 1) and get secondaries under -n."""
    rng = np.random.default_rng(8)
    base = "".join("ACGT"[i] for i in rng.integers(0, 4, 30000))
    block = base[1000:1400]
    seq = base[:9000] + block + base[9400:20000] + block + base[20400:]
    gfa = tmp_path_factory.mktemp("trep") / "g.fa"
    gfa.write_text(">chr1\n" + seq + "\n")
    reads = [Record(f"rep{i}", "", block[10 * i:10 * i + 100])
             for i in range(20)]
    reads += [Record(f"uni{i}", "", base[25000 + 90 * i:25100 + 90 * i])
              for i in range(12)]
    db = build_db(gfa, name="g", k=12, interval=3)
    return db, JaxIndex.from_host(db), DeviceIndex.from_host(db, "cpu"), reads


@pytest.mark.parametrize("npaths", [1, 3])
def test_multimappers_and_secondaries_match(repeats, npaths):
    """-n: secondaries of multimapping rows come from the sec_*
    compaction; YM:Z: tags through the per-row path."""
    db, ji, ti, reads = repeats
    want = sam_text(jdriver.align_records(
        db, ji, reads, jengine.AlignConfig(**CFG), batch_size=32,
        npaths=npaths, show_method=True))
    got = sam_text(driver.align_records(
        db, ti, reads, engine.AlignConfig(**CFG), batch_size=32,
        npaths=npaths, show_method=True))
    assert got == want
    if npaths > 1:
        assert b"HI:i:2" in got


def test_secondaries_in_list_mode_match(repeats):
    """-n 3 without YM:Z: tags: the bulk emitter leaves rows with
    secondaries to the per-row path, as tpumap's does."""
    db, ji, ti, reads = repeats
    want = sam_text(jdriver.align_records(
        db, ji, reads, jengine.AlignConfig(**CFG), batch_size=32, npaths=3))
    got = sam_text(driver.align_records(
        db, ti, reads, engine.AlignConfig(**CFG), batch_size=32, npaths=3))
    assert got == want and b"HI:i:2" in got


# a genes map for the transcriptome rung on mixed_workload's genome
MIXED_GENES = (">TRA chr1:1001..3100 gene\nGENEA NM_A\n1001 1200\n"
               "3001 3100\n")


@pytest.mark.parametrize("kw", [{"known_indels": None}, {"tr": None},
                                {"find_fusions": True},
                                {"config": engine.AlignConfig(
                                    mode="cmet-stranded")},
                                {"device_ctx": "mesh"},
                                {"config": engine.AlignConfig(
                                    snp_tolerant=True)}])
def test_later_slices_raise(mixed, kw):
    """Device meshes (device_ctx: tpumap's MeshContext on 8 virtual
    devices, the port's on 8 `cpu` devices), the staged path
    (known_indels, find_fusions), the transcriptome rung (tr), the
    alignment modes and SNP tolerance are ported: the port accepts them
    and gives tpumap's SAM (this db has no mode or SNP tables, so both
    fall back to the standard ones, as tpumap's mode_index does)."""
    db, ji, ti, reads, _ = mixed
    jkw, tkw = dict(kw), dict(kw)
    if "device_ctx" in kw:
        from tpumap.parallel import mesh as jmesh
        from tpumap.parallel import pipeline as jpipe
        from tpumap_torch.parallel import mesh, pipeline
        jkw["device_ctx"] = jpipe.MeshContext(jmesh.make_mesh(8), db)
        tkw["device_ctx"] = pipeline.MeshContext(
            mesh.make_mesh(devices=[torch.device("cpu")] * 8), db)
    if "known_indels" in kw:
        from tpumap.gsnap.knownindels import KnownIndels as JKnownIndels
        from tpumap_torch.gsnap.knownindels import KnownIndels
        none = (np.zeros(0, np.uint64), np.zeros(0, np.int32),
                np.zeros(0, np.int64))
        jkw["known_indels"] = JKnownIndels(*none)
        tkw["known_indels"] = KnownIndels(*none)
    if "tr" in kw:
        from tpumap.gsnap.transcriptome import build_transcriptome as jbuild
        from tpumap.io.iit import build_iit as jbuild_iit
        from tpumap.io.iit import parse_map_fasta as jparse
        from tpumap_torch.gsnap.transcriptome import build_transcriptome
        from tpumap_torch.io.iit import build_iit, parse_map_fasta
        jtr = jbuild(db, jbuild_iit(jparse(io.StringIO(MIXED_GENES))),
                     name="tr", k=10, interval=1)
        ttr = build_transcriptome(
            db, build_iit(parse_map_fasta(io.StringIO(MIXED_GENES))),
            name="tr", k=10, interval=1)
        jkw["tr"] = (jtr, JaxIndex.from_host(jtr.trdb))
        tkw["tr"] = (ttr, DeviceIndex.from_host(ttr.trdb, "cpu"))
    cfg = kw.get("config", engine.AlignConfig())
    jkw["config"] = jengine.AlignConfig(mode=cfg.mode,
                                        snp_tolerant=cfg.snp_tolerant)
    tkw["config"] = cfg
    want = sam_text(jdriver.align_records(db, ji, reads[:8], **jkw))
    assert sam_text(driver.align_records(db, ti, reads[:8], **tkw)) == want


def test_no_jax_import_in_port():
    pat = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    files = sorted((REPO / "tpumap_torch").rglob("*.py"))
    assert files
    for f in files + [REPO / "chip_smoke.py", REPO / "tests" /
                      "torch_workloads.py", REPO / "tests" /
                      "test_torch_cuda.py"]:
        assert not pat.search(f.read_text()), f


def test_slice_runs_without_jax(mixed, tmp_path):
    """The port's align_records in a process where neither JAX
    nor tpumap can be imported gives tpumap's SAM."""
    db, ji, _ti, reads, _gfa = mixed
    want = sam_text(jdriver.align_records(
        db, ji, reads, jengine.AlignConfig(**CFG), batch_size=32))
    script = NO_TPUMAP + f"""
import pathlib
sys.path[:0] = [{str(REPO)!r}, {str(REPO / "tests")!r}]
import torch
torch.set_num_threads(1)
from torch_workloads import mixed_workload
from tpumap_torch.gsnap.driver import align_records
from tpumap_torch.gsnap.engine import AlignConfig
from tpumap_torch.index.device import DeviceIndex
db, reads, _ = mixed_workload(pathlib.Path({str(tmp_path)!r}), port=True)
align_records(db, DeviceIndex.from_host(db, "cpu"), reads,
              AlignConfig(top_k=4, max_occ=8), batch_size=32,
              sink=sys.stdout.buffer.write)
assert sys.modules["jax"] is None
assert not [m for m in sys.modules if m.split(".")[0] == "tpumap"]
"""
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert r.stdout == want
