"""The port's multi-device paths against tpumap's (JAX on 8 virtual CPU
devices, tests/conftest.py): the data-parallel MeshContext through
align_records, align_paired_records and align_queries_bulk (whole
records and GFF3), a compaction that overflows, the index-sharded
aligners at tpumap's four mesh shapes, and the genome-window aligner
with its uint64 rebase. The port's grid is 8 `cpu` devices; its shard
math, gather order and row globalisation are what these hold.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_mesh_pipeline import _fields
from tpumap.cli import gmap_cli as jgmap_cli
from tpumap.gsnap import driver as jdriver
from tpumap.gsnap import ladder as jladder
from tpumap.gsnap.engine import AlignConfig as JConfig
from tpumap.gsnap.paired import align_paired_records as jpaired
from tpumap.index import build_db
from tpumap.index.device import DeviceIndex as JIndex
from tpumap.io import gff3 as jgff3
from tpumap.io.fasta import Record
from tpumap.ops import pathdp as jpathdp
from tpumap.parallel import large as jlarge
from tpumap.parallel import mesh as jmesh
from tpumap.parallel import pipeline as jpipe
from tpumap.parallel import sharded as jsharded
from tpumap.utils import dna
from tpumap.utils.fetch import device_fetch, widen_ints
from tpumap_torch.cli import gmap_cli
from tpumap_torch.gsnap import driver, ladder
from tpumap_torch.gsnap.engine import AlignConfig
from tpumap_torch.gsnap.paired import align_paired_records
from tpumap_torch.index.device import DeviceIndex
from tpumap_torch.io import gff3
from tpumap_torch.ops import pathdp
from tpumap_torch.parallel import large, mesh, pipeline, sharded
from torch_workloads import gmap_world

torch.set_num_threads(1)
CPU8 = [torch.device("cpu")] * 8


def tmesh(index_shards=1):
    return mesh.make_mesh(8, index_shards=index_shards, devices=CPU8)


def same_dicts(want: dict, got: dict):
    """Equal keys, dtypes and values."""
    assert sorted(got) == sorted(want)
    for key in want:
        a, b = np.asarray(want[key]), np.asarray(got[key])
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)


# ------------------------------------------------------- the mesh context

@pytest.fixture(scope="module")
def mesh_world(tmp_path_factory):
    """test_mesh_pipeline's world (plain, 1- and 2-junction and dirty-end
    reads), with one tpumap and one port MeshContext."""
    d = tmp_path_factory.mktemp("tmeshpipe")
    rng = np.random.default_rng(77)
    g = list("ACGT"[i] for i in rng.integers(0, 4, 60000))
    a0, a1, b0, b1, c0 = 10000, 10300, 12000, 12030, 15000
    for (x, y) in ((a1, b0), (b1, c0)):
        g[x], g[x + 1], g[y - 2], g[y - 1] = "G", "T", "A", "G"
    seq = "".join(g)
    (d / "g.fa").write_text(">chr1\n" + seq + "\n")
    comp = str.maketrans("ACGT", "TGCA")
    reads = []
    for r in range(24):
        p = int(rng.integers(0, 50000))
        s = list(seq[p:p + 100])
        for j in rng.choice(np.arange(5, 95), size=int(rng.integers(0, 3)),
                            replace=False):
            s[j] = "ACGT"[("ACGT".index(s[j]) + 1) % 4]
        s = "".join(s)
        if r % 3 == 0:
            s = s.translate(comp)[::-1]
        reads.append(Record(f"p{r}", "", s))
    for r in range(8):
        split = int(rng.integers(25, 75))
        reads.append(Record(f"s{r}", "", seq[a1 - split:a1]
                            + seq[b0:b0 + 100 - split]))
    for r in range(4):
        l0 = int(rng.integers(25, 35))
        reads.append(Record(f"j{r}", "", seq[a1 - l0:a1] + seq[b0:b1]
                            + seq[c0:c0 + 100 - l0 - (b1 - b0)]))
    for r in range(4):
        p = int(rng.integers(20000, 40000))
        junk = "".join("ACGT"[i] for i in rng.integers(0, 4, 12))
        reads.append(Record(f"t{r}", "", seq[p:p + 88] + junk))
    db = build_db(d / "g.fa", name="g", k=12, interval=3)
    jctx = jpipe.MeshContext(jmesh.make_mesh(8, index_shards=1), db)
    tctx = pipeline.MeshContext(tmesh(), db)
    return db, seq, reads, jctx, tctx


def test_make_mesh_shapes_and_errors():
    m = mesh.make_mesh(8, index_shards=2, devices=CPU8)
    assert m.shape == {mesh.DATA_AXIS: 4, mesh.INDEX_AXIS: 2}
    assert m.distinct() == [torch.device("cpu")]
    with pytest.raises(ValueError, match="not divisible"):
        mesh.make_mesh(6, index_shards=4, devices=CPU8)
    parts = mesh.batch_sharding(m, {"x": torch.arange(8)})
    assert [p["x"].tolist() for p in parts] == [[0, 1], [2, 3], [4, 5],
                                                [6, 7]]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.make_mesh()


@pytest.mark.parametrize("novel", [True, False], ids=["rna", "dna"])
def test_align_records_mesh_matches_tpumap(mesh_world, novel):
    db, _seq, reads, jctx, tctx = mesh_world
    want = jdriver.align_records(db, jctx.index, reads, JConfig(),
                                 novelsplicing=novel, device_ctx=jctx)
    got = driver.align_records(db, tctx.index, reads, AlignConfig(),
                               novelsplicing=novel, device_ctx=tctx)
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    if novel:
        assert sum("N" in r.cigar for r in got) >= 10


def test_staged_path_through_the_mesh(mesh_world):
    """Learned indels take the staged path: the cascade and the chain
    solver through the context (tpumap routes the same two calls)."""
    from tpumap.gsnap.knownindels import KnownIndels as JKnownIndels
    from tpumap_torch.gsnap.knownindels import KnownIndels
    db, _seq, reads, jctx, tctx = mesh_world
    none = (np.zeros(0, np.uint64), np.zeros(0, np.int32),
            np.zeros(0, np.int64))
    want = jdriver.align_records(db, jctx.index, reads, JConfig(),
                                 novelsplicing=True, device_ctx=jctx,
                                 known_indels=JKnownIndels(*none))
    got = driver.align_records(db, tctx.index, reads, AlignConfig(),
                               novelsplicing=True, device_ctx=tctx,
                               known_indels=KnownIndels(*none))
    assert [_fields(r) for r in got] == [_fields(r) for r in want]


def test_paired_mesh_matches_tpumap(mesh_world):
    db, seq, _reads, jctx, tctx = mesh_world
    comp = str.maketrans("ACGT", "TGCA")
    rng = np.random.default_rng(3)
    pairs = []
    for r in range(12):
        p = int(rng.integers(0, 50000))
        ins = int(rng.integers(260, 480))
        pairs.append((Record(f"q{r}", "", seq[p:p + 100]),
                      Record(f"q{r}", "", seq[p + ins - 100:p + ins]
                             .translate(comp)[::-1])))
    want = jpaired(db, jctx.index, pairs, JConfig(), novelsplicing=True,
                   device_ctx=jctx)
    got = align_paired_records(db, tctx.index, pairs, AlignConfig(),
                               novelsplicing=True, device_ctx=tctx)
    assert [(_fields(a), _fields(b)) for a, b in got] == \
        [(_fields(a), _fields(b)) for a, b in want]
    assert all(a.flag & 0x2 for a, _b in got)


def test_ladder_full_at_an_overflow(mesh_world):
    """r_chain, r_salv and r_indel far below the rows that need them:
    the mesh must choose the rows one device chooses, so its result dict
    equals the single-device dict (and tpumap's), key for key."""
    db, _seq, reads, jctx, tctx = mesh_world
    B, L = 64, 128
    batch = jdriver.make_batch(reads, B, L)
    args = (L, pathdp.PathScoring(), True, True, 8, 8, 8)
    jargs = (L, jpathdp.PathScoring(), True, True, 8, 8, 8)
    single = ladder.fetch_result(ladder.align_batch_full(
        tctx.index, driver._to_device(batch, "cpu"), AlignConfig(), *args))
    meshed = ladder.fetch_result(tctx.ladder_full(
        driver._to_device(batch, "cpu"), AlignConfig(), *args))
    same_dicts(single, meshed)
    want = widen_ints(device_fetch(jladder.align_batch_full(
        JIndex.from_host(db), jdriver._pack_batch(batch), JConfig(),
        *jargs)))
    same_dicts(want, meshed)
    # the chain compaction did overflow: more rows were at its trigger
    # than its 8 slots
    from tpumap_torch.gsnap.params import (CLIP_SPLICE_TRIGGER,
                                           SPLICE_NMM_TRIGGER)
    r = meshed
    clip = r["trim_qstart"] + (batch["lengths"] - np.minimum(
        r["trim_qend"], batch["lengths"]))
    need = (r["diag"] != 0xFFFFFFFF) & ((r["trim_nmm"] >= SPLICE_NMM_TRIGGER)
                                        | (clip >= CLIP_SPLICE_TRIGGER))
    assert int(need.sum()) > 8 and r["ch_idx"].shape == (8,)


def test_gmap_bulk_mesh_matches_tpumap(tmp_path):
    db, recs, _qfa = gmap_world(tmp_path)
    enc = [dna.encode(r.sequence) for r in recs]
    jctx = jpipe.MeshContext(jmesh.make_mesh(8, index_shards=1), db)
    tctx = pipeline.MeshContext(tmesh(), db)
    want = jgmap_cli.align_queries_bulk(db, jctx.index, enc,
                                        device_ctx=jctx)
    got = gmap_cli.align_queries_bulk(db, tctx.index, enc, device_ctx=tctx)

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


def test_rows_split_over_the_grid(mesh_world):
    """Every row-independent stage of a fused batch ran split: no call
    fell to the lead device whole."""
    db, _seq, reads, _jctx, tctx = mesh_world
    tctx.rows.split = tctx.rows.whole = 0
    driver.align_records(db, tctx.index, reads, AlignConfig(),
                         novelsplicing=True, device_ctx=tctx)
    assert tctx.rows.split >= 10 and tctx.rows.whole == 0


# ------------------------------------------------------ the sharded index

def encode_batch(reads, B, L):
    codes = np.zeros((B, L), dtype=np.uint8)
    nmask = np.zeros((B, L), dtype=bool)
    lengths = np.zeros(B, dtype=np.int32)
    for i, s in enumerate(reads):
        c, m = dna.encode(s)
        codes[i, :len(s)] = c
        nmask[i, :len(s)] = m
        lengths[i] = len(s)
    return {"codes": codes, "nmask": nmask, "lengths": lengths}


def same_values(want: dict, got: dict, keys=None):
    """Equal keys and values (the port keeps diagonals as int64 values of
    tpumap's uint32 ones, so values are compared as int64)."""
    if keys is None:
        assert sorted(got) == sorted(want)
        keys = want
    for key in keys:
        a = np.asarray(want[key]).astype(np.int64)
        b = got[key].cpu().numpy().astype(np.int64)
        np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.fixture(scope="module")
def sharded_world(tmp_path_factory):
    """test_sharded's world: an 8 kbp genome (k = 8), 16 reads."""
    rng = np.random.default_rng(5)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 8000))
    fa = tmp_path_factory.mktemp("tsh") / "g.fa"
    fa.write_text(">chr1\n" + seq + "\n")
    db = build_db(fa, name="g", k=8, interval=3)
    comp = str.maketrans("ACGT", "TGCA")
    reads = []
    for r in range(16):
        p = int(rng.integers(0, len(seq) - 80))
        s = seq[p:p + 80]
        if r % 2:
            s = s.translate(comp)[::-1]
        reads.append(s)
    return db, reads


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_shard_index_host_matches(sharded_world, n):
    db, _reads = sharded_world
    want = jsharded.shard_index_host(db, n)
    got = sharded.shard_index_host(db, n)
    assert got["span"] == want["span"]
    for key in ("offsets", "positions"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_aligner_matches_tpumap(sharded_world, shape):
    db, reads = sharded_world
    config = AlignConfig(top_k=4, max_occ=16)
    batch = encode_batch(reads, 16, 96)
    jm = jmesh.make_mesh(8, index_shards=shape[1])
    jarrays, jalign = jsharded.make_sharded_aligner(
        jm, db, JConfig(top_k=4, max_occ=16))
    bsh = jmesh.batch_sharding(jm)
    want = jalign(jarrays, {k: jax.device_put(v, bsh)
                            for k, v in batch.items()})
    arrays, align = sharded.make_sharded_aligner(tmesh(shape[1]), db,
                                                 config)
    same_values(want, align(arrays, batch))


def test_sharded_full_aligner_matches_tpumap(tmp_path):
    """test_sharded_full_ladder's world at 4 x 2: a spliced read and a
    concordant pair through trim, chain DP and concordance behind the
    gather, every result array equal to tpumap's."""
    from tpumap_torch.utils import dna as tdna
    rng = np.random.default_rng(9)
    g = list("ACGT"[i] for i in rng.integers(0, 4, 40000))
    g[8200:8202] = list("GT")
    g[8998:9000] = list("AG")
    seq = "".join(g)
    fa = tmp_path / "g.fa"
    fa.write_text(">chr1\n" + seq + "\n")
    db = build_db(fa, name="g", k=10, interval=3)
    reads = [""] * 16
    reads[0] = seq[20000:20100]
    reads[1] = tdna.revcomp(seq[20500:20600])
    reads[2] = seq[8150:8200] + seq[9000:9050]
    reads[3] = tdna.revcomp(seq[9300:9400])
    for i in range(4, 16):
        p = 1000 + 61 * i
        reads[i] = seq[p:p + 100]
    batch = encode_batch(reads, 16, 128)
    jm = jmesh.make_mesh(8, index_shards=2)
    jarrays, jalign = jsharded.make_sharded_full_aligner(
        jm, db, JConfig(top_k=4, max_occ=16),
        scoring=jpathdp.PathScoring(max_intron=5000), splicing=True,
        paired=True, pairmax=1500)
    bsh = jmesh.batch_sharding(jm)
    want = jalign(jarrays, {k: jax.device_put(v, bsh)
                            for k, v in batch.items()})
    arrays, align = sharded.make_sharded_full_aligner(
        tmesh(2), db, AlignConfig(top_k=4, max_occ=16),
        scoring=pathdp.PathScoring(max_intron=5000), splicing=True,
        paired=True, pairmax=1500)
    got = align(arrays, batch)
    same_values(want, got)
    assert bool(got["pe_valid"][0])
    ch_ok = got["ch_sel"] & (got["ch_idx"] == 2) & (got["ch_nsegs"] >= 2)
    row = int(torch.nonzero(ch_ok)[0][0])
    segd = got["ch_segd"][row]
    assert int(segd[1]) - int(segd[0]) == 800


# ------------------------------------------------------ the genome windows

@pytest.fixture(scope="module")
def large_world(tmp_path_factory):
    """test_large_genome's world: 64 kbp (k = 10), 32 reads, and the same
    genome as a forced uint64 build."""
    rng = np.random.default_rng(23)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 64000))
    root = tmp_path_factory.mktemp("tlg")
    fa = root / "g.fa"
    fa.write_text(">chr1\n" + seq + "\n")
    db = build_db(fa, name="lg", k=10, interval=3)
    dbl = build_db(fa, name="lg64", k=10, interval=3, large=True)
    comp = str.maketrans("ACGT", "TGCA")
    reads, truth = [], []
    for r in range(32):
        p = int(rng.integers(0, len(seq) - 80))
        s = seq[p:p + 80]
        if r % 2:
            s = s.translate(comp)[::-1]
        reads.append(s)
        truth.append(p)
    return db, dbl, reads, truth


def test_shard_genome_host_matches(large_world):
    db, _dbl, _reads, _truth = large_world
    want = jlarge.shard_genome_host(db, 4, overlap=256)
    got = large.shard_genome_host(db, 4, overlap=256)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("which", ["uint32", "uint64"])
def test_genome_sharded_matches_tpumap(large_world, which):
    db, dbl, reads, truth = large_world
    src = db if which == "uint32" else dbl
    batch = encode_batch(reads, 32, 80)
    jarrays, jalign, jbases = jlarge.make_genome_sharded_aligner(
        jmesh.make_mesh(8, index_shards=4), src,
        JConfig(top_k=4, max_occ=16), overlap=256)
    want = jalign(jarrays, {k: jnp.asarray(v) for k, v in batch.items()})
    arrays, align, bases = large.make_genome_sharded_aligner(
        tmesh(4), src, AlignConfig(top_k=4, max_occ=16), overlap=256)
    got = align(arrays, batch)
    same_values(want, got)
    univ = large.rebase_results(got, bases)
    assert univ.dtype == np.uint64
    np.testing.assert_array_equal(univ, jlarge.rebase_results(
        {k: np.asarray(v) for k, v in want.items()}, jbases))
    assert univ.tolist() == truth


def test_rebase_past_32_bits_and_the_uint64_refusal(large_world):
    _db, dbl, _reads, _truth = large_world
    bases = np.asarray([0, 3 << 32], dtype=np.uint64)
    res = {"shard": torch.tensor([1, 0]),
           "diag": torch.tensor([12345, 7], dtype=torch.int64)}
    univ = large.rebase_results(res, bases)
    assert univ.dtype == np.uint64
    assert univ.tolist() == [(3 << 32) + 12345, 7]
    with pytest.raises(ValueError, match="uint32 coordinate space"):
        DeviceIndex.from_host(dbl, "cpu")
