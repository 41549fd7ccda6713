"""The port's known splicing (-s) against tpumap (JAX on CPU).

The same numpy inputs go through tpumap and through the port's plain
versions: the device tables of a KnownSplicing (empty sets included),
the membership test, the chain DP with known sites on
tests/test_pathdp.py's cases (8 lanes, and 14 as the ladder gives it
with partner diagonals), the fused ladder's dict with known splicing
(rows anchored near 0 and near 2^32, INVALID rows), and the SAM of
align_records(known=...) with and without novel splicing on one world:
tests/test_knownsplicing.py's ambiguous noncanonical junction, plus
known junctions whose short overhangs only the partner derivation
finds. Every quantity is an integer, so values and dtypes must be equal.
"""
import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumap.gsnap import driver as jdriver
from tpumap.gsnap import engine as jengine
from tpumap.gsnap import ladder as jladder
from tpumap.gsnap.knownsplicing import KnownSplicing
from tpumap.gsnap.knownsplicing import coords_in_set as jcoords_in_set
from tpumap.index import build_db
from tpumap.index.device import DeviceIndex as JaxIndex
from tpumap.io.fasta import Record
from tpumap.ops import pathdp as jpathdp
from tpumap.utils import dna
from tpumap.utils.fetch import device_fetch, narrow_result, widen_ints
from tpumap_torch.cli import gsnap_cli
from tpumap_torch.gsnap import driver, engine, ladder
from tpumap_torch.gsnap.knownsplicing import coords_in_set, known_to_device
from tpumap_torch.index.device import DeviceIndex
from tpumap_torch.ops import pathdp
from torch_workloads import sam_text, write_fasta

torch.set_num_threads(1)
INVALID = 0xFFFFFFFF
E1, E2, EXLEN = 5000, 8000, 50       # tests/test_knownsplicing.py's world


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


def same_dict(want, got):
    assert sorted(got) == sorted(want)
    for key in want:
        a, b = np.asarray(want[key]), np.asarray(got[key])
        assert a.dtype == b.dtype, (key, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=key)


# ------------------------------------------------------ device tables

KS_CASES = {
    "sites_and_junctions": KnownSplicing.from_junctions(
        [900, 300, 70_000, 5], [1200, 800, 70_500, 4_000], [1, -1, 1, -1]),
    "empty": KnownSplicing(),
    "sites_only": KnownSplicing(donor=np.asarray([50, 10], np.uint64),
                                antiacceptor=np.asarray([7], np.uint64)),
    "junctions_only": KnownSplicing(
        junctions=np.asarray([[100, 400], [90, 900], [100, 300]], np.uint64)),
}


@pytest.mark.parametrize("case", list(KS_CASES))
def test_known_to_device_matches(case):
    ks = KS_CASES[case]
    want = ks.to_device()
    got = known_to_device(ks, "cpu")
    assert sorted(got) == sorted(want)
    for key in want:
        same(want[key], got[key])


@pytest.mark.parametrize("n", [0, 1, 7, 300])
def test_coords_in_set_matches(n):
    rng = np.random.default_rng(n)
    sset = np.unique(rng.integers(0, 5000, n)).astype(np.uint32)
    if n == 1:
        sset = np.asarray([0xFFFFFFFF], np.uint32)      # the sentinel
    coords = rng.integers(0, 5100, (4, 3, 50)).astype(np.uint32)
    coords[0, 0, :min(len(sset), 50)] = sset[:50]
    coords[1, 1, :3] = [0, 0xFFFFFFFF, 4999]
    want = jcoords_in_set(jnp.asarray(sset), jnp.asarray(coords))
    got = coords_in_set(t(sset.astype(np.int64)), t(coords.astype(np.int64)))
    same(want, got)
    if n == 1:
        assert bool(np.asarray(want)[1, 1, 1])


# ------------------------------------------------------ chain DP, known

@pytest.fixture(scope="module")
def chain_world(tmp_path_factory):
    """tests/test_pathdp.py's genome (two GT..AG introns) and its cases,
    with known sites at the introns, at noncanonical boundaries the
    random cases cross, and antisense sites; solved by both packages with
    8 and with 14 candidate lanes."""
    d = tmp_path_factory.mktemp("kchain")
    rng = np.random.default_rng(7)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 8000))
    seq = (seq[:2000] + "GT" + seq[2002:2298] + "AG"
           + seq[2300:3000] + "GT" + seq[3002:3498] + "AG" + seq[3500:])
    db = build_db(write_fasta(d / "g.fa", seq), name="g", k=12, interval=3)
    rows = [("one_intron", seq[1960:2000] + seq[2300:2360], [1960, 2260]),
            ("two_introns", seq[1970:2000] + seq[2960:3000]
             + seq[3500:3550], [1970, 2930, 3430]),
            ("noncanonical", seq[4000:4040] + seq[5040:5100],
             [4000, 5000]),
            ("deletion", seq[975:1000] + seq[1005:1030], [975, 980]),
            ("antisense", seq[6000:6045] + seq[6545:6600], [6000, 6500])]
    r2 = np.random.default_rng(11)
    for k in range(24):
        L = int(r2.integers(40, 90))
        start = int(r2.integers(100, 7000))
        read = list(seq[start:start + L])
        for _ in range(int(r2.integers(0, 6))):
            read[int(r2.integers(0, L))] = "ACGT"[r2.integers(0, 4)]
        ds = [start] + [int(r2.integers(100, 7000))
                        for _ in range(int(r2.integers(1, 5)) - 1)]
        rows.append((f"random{k}", "".join(read), list(dict.fromkeys(ds))))
    rows.append(("no_candidate", seq[100:180], []))
    ks = KnownSplicing(
        donor=np.asarray([2000, 3000, 4040] + [int(x) for x in
                                               r2.integers(100, 7000, 40)],
                         np.uint64),
        acceptor=np.asarray([2300, 3500, 5040] + [int(x) for x in
                                                  r2.integers(100, 7000, 40)],
                            np.uint64),
        antiacceptor=np.asarray([6045], np.uint64),
        antidonor=np.asarray([6545], np.uint64))
    R, L = len(rows), 128
    codes = np.zeros((R, L), np.uint8)
    lengths = np.zeros(R, np.int32)
    diags = np.full((R, 14), INVALID, np.uint32)
    for i, (_n, read, ds) in enumerate(rows):
        c = dna.encode(read)[0]
        codes[i, :len(c)] = c
        lengths[i] = len(c)
        diags[i, :len(ds)] = ds
    # lanes 8..13 as the ladder's partner diagonals fill them
    diags[:, 8:11] = np.where(diags[:, :3] != INVALID,
                              diags[:, :3] + 300, INVALID)
    nmask = np.zeros((R, L), bool)
    ji, ti = JaxIndex.from_host(db), DeviceIndex.from_host(db, "cpu")
    kd_j, kd_t = ks.to_device(), known_to_device(ks, "cpu")
    out = {}
    for K in (8, 14):
        want = jpathdp.chain_solve(
            ji, jnp.asarray(codes), jnp.asarray(nmask), jnp.asarray(lengths),
            jnp.asarray(diags[:, :K]), scoring=jpathdp.PathScoring(),
            known=kd_j)
        got = pathdp.chain_solve(
            ti, t(codes), t(nmask), t(lengths),
            t(diags[:, :K].astype(np.int64)), scoring=pathdp.PathScoring(),
            known=kd_t)
        plain = pathdp.chain_solve(
            ti, t(codes), t(nmask), t(lengths),
            t(diags[:, :K].astype(np.int64)), scoring=pathdp.PathScoring())
        out[K] = ({k: np.asarray(v) for k, v in want.items()}, got, plain)
    return [r[0] for r in rows], out


@pytest.mark.parametrize("K", [8, 14])
@pytest.mark.parametrize("case", ["one_intron", "two_introns",
                                  "noncanonical", "deletion", "antisense",
                                  "random", "no_candidate"])
def test_chain_solve_known_matches(chain_world, case, K):
    names, out = chain_world
    want, got, plain = out[K]
    rows = [i for i, n in enumerate(names) if n.startswith(case)]
    assert sorted(want) == sorted(got)
    for key in want:
        same(want[key][rows], got[key][rows])
    if case in ("noncanonical", "antisense"):
        # the known-site bonus opens a junction the plain scoring does
        # not take at this score
        assert want["score"][rows[0]] > int(plain["score"][rows[0]])


# ------------------------------------------------------ ladder and SAM

def known_world(root):
    """chr1: tests/test_knownsplicing.py's genome (a junction whose two
    placements tie and whose boundaries are noncanonical); chr2: genes
    with GT..AG introns of 200 and 1,000 bp (one antisense) and reads
    across them, some with 6-12 base overhangs that do not seed. Returns
    (db, reads, KnownSplicing)."""
    rng = np.random.default_rng(7)
    g = list("ACGT"[i] for i in rng.integers(0, 4, 20000))
    g[E2 - 1] = g[E1 + EXLEN - 1]
    g[E1 + EXLEN], g[E1 + EXLEN + 1] = "A", "A"
    g[E2 - 3], g[E2 - 2] = "T", "T"
    chr1 = "".join(g)
    r2 = np.random.default_rng(23)
    g2 = list("ACGT"[i] for i in r2.integers(0, 4, 30000))
    introns = [(3000, 3200), (6000, 7000), (12000, 12200), (18000, 19000)]
    for a, b in introns:
        g2[a:a + 2], g2[b - 2:b] = list("GT"), list("AG")
    chr2 = "".join(g2)
    (root / "g.fa").write_text(f">chr1\n{chr1}\n>chr2\n{chr2}\n")
    db = build_db(root / "g.fa", name="ks", k=13, interval=3)
    off2 = int(db.chrom_offsets[1])
    reads = [chr1[E1:E1 + EXLEN] + chr1[E2:E2 + EXLEN],
             dna.revcomp(chr1[E1:E1 + EXLEN] + chr1[E2:E2 + EXLEN]),
             chr1[9000:9100]]
    for a, b in introns:
        for over in (6, 9, 12, 40):
            reads.append(chr2[a - (100 - over):a] + chr2[b:b + over])
            reads.append(chr2[a - over:a] + chr2[b:b + 100 - over])
        reads.append(dna.revcomp(chr2[a - 94:a] + chr2[b:b + 6]))
    reads.append(chr2[500:600])
    reads.append("".join("ACGT"[i] for i in r2.integers(0, 4, 100)))
    recs = [Record(f"r{i}", "", s) for i, s in enumerate(reads)]
    don = [E1 + EXLEN] + [off2 + a for a, _b in introns]
    acc = [E2] + [off2 + b for _a, b in introns]
    sense = [1, 1, 1, 1, -1]
    return db, recs, KnownSplicing.from_junctions(don, acc, sense)


@pytest.fixture(scope="module")
def kworld(tmp_path_factory):
    """tpumap's SAM (align_records, known, with and without -N 1) and
    the fused dicts of the first batch of each run."""
    db, reads, ks = known_world(tmp_path_factory.mktemp("kworld"))
    ji = JaxIndex.from_host(db)
    want = {}
    for novel in (False, True):
        want[novel] = sam_text(jdriver.align_records(
            db, ji, reads, jengine.AlignConfig(), novelsplicing=novel,
            known=ks, batch_size=64))
    B, L = 64, 128
    batch = jdriver.make_batch(reads, B, L)
    sc = jpathdp.PathScoring()
    kd = ks.to_device()
    dicts = {}
    for novel in (False, True):
        dicts[novel] = widen_ints(device_fetch(jladder.align_batch_full_known(
            ji, jdriver._pack_batch(batch), jengine.AlignConfig(), L, sc,
            True, novel, B, B, B, known=kd)))
    return db, ji, reads, ks, batch, want, dicts


@pytest.mark.parametrize("novel", [False, True])
def test_align_batch_full_known_dict_matches(kworld, novel):
    """Every key of tpumap's align_batch_full_known against the port's
    align_batch_full(known=...)."""
    db, _ji, _reads, ks, batch, _want, dicts = kworld
    B, L = 64, 128
    ti = DeviceIndex.from_host(db, "cpu")
    got = ladder.fetch_result(ladder.align_batch_full(
        ti, driver._to_device(batch, "cpu"), engine.AlignConfig(), L,
        pathdp.PathScoring(), True, novel, B, B, B,
        known=known_to_device(ks, "cpu")))
    same_dict(dicts[novel], got)
    assert (dicts[novel]["ch_nsegs"][dicts[novel]["ch_sel"]] >= 2).sum() >= 8


def test_refine_full_partners_wrap(kworld):
    """The partner derivation's uint32 wrap: chain rows anchored at 5
    and at 2^32 - 60 (adiag + li wraps), with known junctions at both
    ends of the coordinate space, and INVALID rows; the cascade result
    is edited identically for both packages."""
    db, ji, reads, _ks, batch, _want, _dicts = kworld
    B, L = 64, 128
    top = 2 ** 32
    ks = KnownSplicing.from_junctions(
        [30, top - 150, top - 40, 40, top - 30],
        [700, top - 10, top - 5, 60, 20], [1, 1, 1, -1, 1])
    cfg = jengine.AlignConfig()
    jres = jengine.align_batch_cascaded_packed(ji, jdriver._pack_batch(batch),
                                               cfg, L)
    ti = DeviceIndex.from_host(db, "cpu")
    pb = driver._to_device(batch, "cpu")
    tres = engine.align_batch_cascaded_packed(ti, pb, engine.AlignConfig(), L)
    # the spliced reads (chain-triggered rows) re-anchored near the ends
    rows = np.asarray([3, 4, 5, 6, 7, 8])
    vals = np.asarray([5, top - 60, 0, top - 200, 45, top - 2], np.uint32)
    cd = np.asarray(jres["cand_diags"]).copy()
    cd[rows, 0] = vals
    cd[rows, 1] = (vals.astype(np.uint64) + 3) & 0xFFFFFFFF
    jres = dict(jres, diag=jres["diag"].at[rows].set(vals),
                cand_diags=jnp.asarray(cd))
    tres = dict(tres)
    tres["diag"] = tres["diag"].clone()
    tres["diag"][t(rows)] = t(vals.astype(np.int64))
    tres["cand_diags"] = t(cd.astype(np.int64))
    sc = jpathdp.PathScoring()
    jfn = jax.jit(lambda idx, p, r, k: narrow_result(jladder.refine_full(
        idx, p, r, cfg, L, sc, True, False, B, B, B, known=k)))
    want = widen_ints(device_fetch(jfn(ji, jdriver._pack_batch(batch), jres,
                                       ks.to_device())))
    got = ladder.fetch_result(ladder.narrow_result(ladder.refine_full(
        ti, pb, tres, engine.AlignConfig(), L, pathdp.PathScoring(), True,
        False, B, B, B, known=known_to_device(ks, "cpu"))))
    same_dict(want, got)


@pytest.mark.parametrize("sink", [False, True])
@pytest.mark.parametrize("novel", [False, True])
def test_known_world_sam(kworld, novel, sink):
    db, _ji, reads, ks, _batch, want, _dicts = kworld
    ti = DeviceIndex.from_host(db, "cpu")
    kw = dict(novelsplicing=novel, known=ks, batch_size=64)
    if sink:
        chunks = []
        assert driver.align_records(db, ti, reads, engine.AlignConfig(),
                                    sink=chunks.append, **kw) == []
        got = b"".join(bytes(c) for c in chunks)
    else:
        got = sam_text(driver.align_records(db, ti, reads,
                                            engine.AlignConfig(), **kw))
    assert got == want[novel]
    lines = want[novel].decode().splitlines()
    # the known pair snaps the tied junction (test_knownsplicing)
    assert lines[0].split("\t")[5] == f"50M{E2 - E1 - EXLEN}N50M"
    assert "XS:A:+" in lines[0]
    # 6-base overhangs spliced through the partner derivation
    assert sum(ln.split("\t")[5] in ("94M200N6M", "94M1000N6M")
               for ln in lines) >= 3


def test_main_known_splicing_cpu(kworld, tmp_path):
    """gsnap_cli.main -s with an IIT of the known introns on --device
    cpu (-n 1) gives align_records(known=...)'s records."""
    from tpumap.cli.iit_cli import store_main
    db, _ji, reads, ks, _batch, _want, _dicts = kworld
    db.save(str(tmp_path / "db"))
    rfa = tmp_path / "reads.fa"
    rfa.write_text("".join(f">{r.accession}\n{r.sequence}\n" for r in reads))
    # intron-level map: exon_end..next_exon_start, 1-based
    lines = []
    for j, (d, a) in enumerate(np.asarray(ks.junctions).tolist()):
        c, pos = db.chrpos(int(d))
        _c, apos = db.chrpos(int(a))
        lines.append(f">i{j} {c}:{pos}..{apos + 1} intron\n")
    (tmp_path / "sp.fa").write_text("".join(lines))
    with redirect_stdout(io.StringIO()):
        store_main(["-o", str(tmp_path / "sp"), str(tmp_path / "sp.fa")])
    buf = io.StringIO()
    with redirect_stdout(buf):
        gsnap_cli.main(["-D", str(tmp_path / "db"), str(rfa), "--device",
                        "cpu", "--batch-size", "64", "-n", "1", "-s",
                        str(tmp_path / "sp.iit")])
    body = [ln for ln in buf.getvalue().splitlines()
            if not ln.startswith("@")]
    plus = KnownSplicing.from_junctions(ks.junctions[:, 0],
                                        ks.junctions[:, 1],
                                        np.ones(len(ks.junctions)))
    want = sam_text(driver.align_records(
        db, DeviceIndex.from_host(db, "cpu"), reads, known=plus,
        batch_size=64)).decode().splitlines()
    assert body == want and any("XS:A:+" in ln for ln in body)
