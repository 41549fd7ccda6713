"""The port's GMAP device ops against tpumap's, JAX on the CPU: the same
numpy inputs through both, every output compared exactly (values and
the order of lanes and members).

Stage 1's seed ops (prevalent_diagonals with merge slop and the run's
last diagonal, lookup_diagonals keeping overabundant oligos), and the
chain stage of ops/chain.py and gmap/engine.py: the window index, the
anchors at k = 8 (direct table) and k = 13 (binary search), with an
oligo of more than max_occ hits, the segments with tied weights, the
chain DP with tied qstarts at S = 64 and 512, the compaction, and the
whole windowed pipeline on a small db.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumap.gmap import engine as jengine
from tpumap.index import build_db
from tpumap.index.device import DeviceIndex as JDeviceIndex
from tpumap.ops import chain as jchain
from tpumap.ops import seed as jseed
from tpumap_torch.gmap import engine
from tpumap_torch.index.device import DeviceIndex
from tpumap_torch.ops import chain, seed
from torch_workloads import (gmap_repeat_query, gmap_segments, gmap_straddle,
                             gmap_windows)

torch.set_num_threads(2)
INVALID = 0xFFFFFFFF


def t64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def same(port, want):
    """Exact equality of a port tensor and a JAX array (uint32 values
    held in int64 or int32 compare by value)."""
    w = np.asarray(want)
    g = port.numpy()
    assert g.shape == w.shape, (g.shape, w.shape)
    if w.dtype == np.bool_:
        assert g.dtype == np.bool_
    assert np.array_equal(g.astype(np.int64), w.astype(np.int64))


# ------------------------------------------------------------- stage 1

def test_train_longer_than_slop_is_one_run():
    """test_stage1_regions' case: a train of diagonals each within slop
    of its predecessor is one run, longer than the slop."""
    train = np.arange(0, 1100, 100, dtype=np.uint32)
    d = np.concatenate([train, np.full(5, INVALID, np.uint32)])[None, :]
    diags, counts, lasts = seed.prevalent_diagonals(
        t64(d), 3, merge_slop=150, return_last=True)
    want = jseed.prevalent_diagonals(jnp.asarray(d), 3, merge_slop=150,
                                     return_last=True)
    for g, w in zip((diags, counts, lasts), want):
        same(g, w)
    assert int(counts[0, 0]) == 11 and int(lasts[0, 0]) == 1000
    assert int(counts[0, 1]) == 0


@pytest.mark.parametrize("slop,return_last", [(0, False), (0, True),
                                              (150, True), (200_000, True)])
def test_prevalent_diagonals_with_slop(slop, return_last):
    """Clustered trains, repeats and INVALID padding, near 0 and 2^32."""
    rng = np.random.default_rng(slop + return_last)
    B, N = 12, 300
    d = np.concatenate([
        rng.integers(0, 3_000_000, (B, N // 3)),
        rng.integers(1_000_000, 1_000_000 + 50 * N, (B, N // 3)),
        np.repeat(rng.integers(0, 2 ** 32 - 1, (B, 5)), N // 15, axis=1),
    ], axis=1).astype(np.uint32)
    d[rng.random(d.shape) < 0.2] = INVALID
    d[0, :] = INVALID
    want = jseed.prevalent_diagonals(jnp.asarray(d), 5, merge_slop=slop,
                                     return_last=return_last)
    got = seed.prevalent_diagonals(t64(d), 5, merge_slop=slop,
                                   return_last=return_last)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        same(g, w)


@pytest.mark.parametrize("keep", [False, True])
def test_lookup_diagonals_keep_overabundant(keep):
    rng = np.random.default_rng(7 + keep)
    k, P = 4, 4000
    counts = rng.integers(0, 30, 4 ** k)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.uint32)
    positions = np.concatenate([
        np.sort(rng.integers(0, 10 ** 6, int(counts.sum()))).astype(np.uint32),
        np.full(64, INVALID, np.uint32)])
    B, NQ = 6, 40
    oligos = rng.integers(0, 4 ** k, (B, NQ)).astype(np.uint32)
    valid = rng.random((B, NQ)) < 0.8
    qpos = np.arange(0, NQ * 5, 5, dtype=np.int32)[:NQ]
    want = jseed.lookup_diagonals(jnp.asarray(offsets), jnp.asarray(positions),
                                  jnp.asarray(oligos), jnp.asarray(valid),
                                  jnp.asarray(qpos), 16,
                                  keep_overabundant=keep)
    i32 = lambda a: torch.from_numpy(a.view(np.int32))
    got = seed.lookup_diagonals(i32(offsets), i32(positions), t64(oligos),
                                torch.from_numpy(valid), t64(qpos), 16,
                                keep_overabundant=keep)
    same(got, want)
    assert P and (np.asarray(want) != INVALID).any()


# ------------------------------------------------------- chain stage

@pytest.fixture(scope="module")
def windows():
    """Windows with N bases, queries copying pieces of them, and a
    poly-A window with a poly-A query (one bucket of 2,000 positions)."""
    rng = np.random.default_rng(11)
    codes, valid, _acc, _ok = gmap_windows(rng, 4, 2048, 256, 8)
    codes[3, :2000] = 0
    valid[3, :2000] = True
    return codes, valid


def test_region_oligos_and_index(windows):
    codes, valid = windows
    for k in (8, 13):
        jo = jax.vmap(lambda c, v: jchain.region_oligos(c, v, k))(
            codes, valid)
        same(chain.region_oligos(torch.from_numpy(codes),
                                 torch.from_numpy(valid), k), jo)
        so, sp = jax.vmap(lambda c, v: jchain.region_index(c, v, k))(
            codes, valid)
        tso, tsp = chain.region_index(torch.from_numpy(codes),
                                      torch.from_numpy(valid), k)
        same(tso, so)
        same(tsp, sp)
    # tpumap's sort leaves each oligo's positions increasing
    so, sp = np.asarray(so), np.asarray(sp)
    tie = so[:, 1:] == so[:, :-1]
    assert tie.sum() > 1000 and (sp[:, 1:][tie] > sp[:, :-1][tie]).all()


@pytest.mark.parametrize("k,max_occ,keep", [(8, 8, False), (8, 8, True),
                                            (8, 128, True), (13, 8, False),
                                            (13, 8, True)])
def test_anchors_from_query(windows, k, max_occ, keep):
    codes, valid = windows
    rng = np.random.default_rng(k + max_occ)
    Q = 256
    qc = np.array([codes[i, 300:300 + Q] for i in range(4)])
    qc[3] = 0                           # poly-A query in the poly-A window
    qv = rng.random((4, Q)) > 0.02
    acc, ok = chain.rolled_oligos(torch.from_numpy(qc), torch.from_numpy(qv),
                                 k)

    def jax_one(c, v, q, qvv):
        so, sp = jchain.region_index(c, v, k)
        jacc = jnp.zeros(Q, jnp.uint32)
        jok = jnp.ones(Q, jnp.bool_)
        for j in range(k):
            jacc = (jacc << 2) | jnp.roll(q, -j).astype(jnp.uint32)
            jok = jok & jnp.roll(qvv, -j)
        jok = jok & (jnp.arange(Q) < Q - k + 1)
        return (jacc, jok) + jchain.anchors_from_query(
            so, sp, jacc, jok, max_occ, keep_overabundant=keep, k=k)
    jacc, jok, jd, jq, jo = jax.jit(jax.vmap(jax_one))(codes, valid, qc, qv)
    same(acc, jacc)
    same(ok, jok)
    d, q, o = chain.region_anchors_plain(
        torch.from_numpy(codes), torch.from_numpy(valid), acc, ok, k,
        max_occ, keep)
    same(d, jd)
    same(q, jq)
    same(o, jo)
    # the poly-A query's oligo has ~2,000 hits: dropped, or the first
    # max_occ positions in increasing order under keep_overabundant
    assert bool(o[3].any()) == keep
    if keep:
        q0 = int(np.nonzero(ok[3].numpy())[0][0])
        first = d[3, q0, :].numpy().astype(np.int64) - chain.DIAG_BIAS + q0
        assert (first == np.arange(max_occ)).all()


@pytest.mark.parametrize("world,max_occ,keep", [
    ("straddle", 8, False), ("straddle", 8, True), ("straddle", 32, True),
    ("repeat", 8, False), ("repeat", 8, True), ("repeat", 128, True)])
def test_anchors_at_chunk_edges_and_repeats(world, max_occ, keep):
    """The contract K7b is held to on the card, here for the plain
    version against tpumap: hits of one oligo on both sides of a chunk
    boundary (its max_occ-th and (max_occ + 1)-th, and one with exactly
    max_occ), and a query that repeats one oligo at many positions."""
    rng = np.random.default_rng(max_occ + keep)
    k = 8
    if world == "straddle":
        C = 1024 if max_occ == 8 else 2048
        codes, valid, acc, ok = gmap_straddle(rng, 2 * C, 256, C, max_occ)
    else:
        codes, valid, acc, ok = gmap_repeat_query(rng, 3, 4096, 512, k)

    def jax_one(c, v, a, o):
        so, sp = jchain.region_index(c, v, k)
        return jchain.anchors_from_query(so, sp, a, o, max_occ,
                                         keep_overabundant=keep, k=k)
    want = jax.jit(jax.vmap(jax_one))(codes, valid, acc.astype(np.uint32),
                                      ok)
    got = chain.region_anchors_plain(torch.from_numpy(codes),
                                     torch.from_numpy(valid), t64(acc),
                                     torch.from_numpy(ok), k, max_occ, keep)
    for g, w in zip(got, want):
        same(g, w)
    o = got[2].numpy()
    if world == "straddle":
        # X (q 10) has max_occ + 4 hits: dropped, or its first max_occ
        # under keep; Y (q 30) exactly max_occ, kept
        assert o[0, 10].all() == keep and o[0, 30].sum() == max_occ
        if keep:
            pos = got[0][0, 10].numpy().astype(np.int64) - chain.DIAG_BIAS + 10
            assert (np.diff(pos) > 0).all() and pos[-1] < C
    else:
        assert o.any() == (keep or max_occ >= 50)


@pytest.mark.parametrize("ties", [False, True])
def test_anchors_to_segments(windows, ties):
    """Segments from real anchors; with ties, weights tie everywhere
    (short runs of one or two anchors)."""
    codes, valid = windows
    rng = np.random.default_rng(ties)
    Q, k = 256, 8
    qc = np.array([codes[i, 500:500 + Q] for i in range(4)])
    if ties:
        qc[:, ::3] = rng.integers(0, 4, (4, Q))[:, ::3]
    qv = np.ones((4, Q), bool)
    acc, ok = chain.rolled_oligos(torch.from_numpy(qc), torch.from_numpy(qv),
                                 k)
    d, q, o = chain.region_anchors_plain(torch.from_numpy(codes),
                                         torch.from_numpy(valid), acc, ok, k,
                                         8)
    jd = np.where(o.numpy(), d.numpy(), 0x7FFFFFFF).astype(np.uint32)
    want = jax.jit(jax.vmap(lambda a, b, c: jchain.anchors_to_segments(
        a, b, c, 64, k)))(jd, q.numpy(), o.numpy())
    got = chain.anchors_to_segments(d, q, o, 64, k)
    for f in ("diag", "qstart", "qend", "weight", "valid"):
        same(got[f], want[f])
    w = got["weight"].numpy()
    if ties:
        assert (np.diff(w[w > 0]) == 0).sum() >= 8


@pytest.mark.parametrize("S,ties", [(64, False), (64, True), (512, True),
                                    (1, False), (31, True), (33, True)])
def test_chain_segments_and_compaction(S, ties):
    """The DP with tied qstarts (and weights): order, chain members and
    the compaction at CHAIN_M and at S, against tpumap's chain_segments
    and _compact_chain."""
    rng = np.random.default_rng(S + ties)
    N = 6 if S == 64 else 2
    segs = gmap_segments(rng, N, S, tie_q=ties, tie_w=ties)
    jsegs = {k: jnp.asarray(v) for k, v in segs.items()}
    order, in_chain = jax.jit(jax.vmap(jchain.chain_segments))(jsegs)
    tsegs = {k: torch.from_numpy(v) for k, v in segs.items()}
    torder, tin = chain.chain_segments(tsegs)
    same(torder, order)
    same(tin, in_chain)
    want = jengine._compact_chain(jsegs, order, in_chain)
    for g, w in zip(engine._compact_chain(tsegs, torder, tin), want):
        same(g, w)
    for g, w in zip(chain.chain_compact(tsegs, engine.CHAIN_M), want):
        same(g, w)
    assert tin.sum() >= N


@pytest.mark.parametrize("S,N,far,max_intron", [
    (1025, 2, 0, 500_000), (2048, 1, 0, 500_000),
    (64, 6, 100_000_000, 100_000_000), (512, 2, 100_000_000, 100_000_000)])
def test_chain_past_the_kernel_tables(S, N, far, max_intron):
    """The settings K7a once refused on the card (queue 3, F1): more
    than 1,024 segments, and max_intron = 10^8 with genomic gaps past
    2^26 between members; the plain versions against tpumap."""
    rng = np.random.default_rng(S + far)
    segs = gmap_segments(rng, N, S, far=far)
    if far:
        d = segs["diag"].astype(np.int64)
        assert (d.max(1) - d.min(1) > chain.GAP_TABLE_MAX).all()
    jsegs = {k: jnp.asarray(v) for k, v in segs.items()}
    order, in_chain = jax.jit(jax.vmap(
        lambda x: jchain.chain_segments(x, max_intron)))(jsegs)
    tsegs = {k: torch.from_numpy(v) for k, v in segs.items()}
    torder, tin = chain.chain_segments(tsegs, max_intron)
    same(torder, order)
    same(tin, in_chain)
    want = jengine._compact_chain(jsegs, order, in_chain)
    for g, w in zip(chain.chain_compact(tsegs, engine.CHAIN_M, max_intron),
                    want):
        same(g, w)
    if far:
        # chains that join members across more than 2^26 bases
        gs = (segs["diag"] + segs["qstart"]).astype(np.int64)
        ge = (segs["diag"] + segs["qend"]).astype(np.int64)
        o, m = torder.numpy(), tin.numpy()
        gaps = [int(gs[r, o[r, b]] - ge[r, o[r, a]])
                for r in range(N) for a, b in zip(*[
                    np.nonzero(m[r])[0][:-1], np.nonzero(m[r])[0][1:]])]
        assert max(gaps) > chain.GAP_TABLE_MAX


@pytest.mark.parametrize("max_occ,keep", [
    (255, False), (255, True), (256, False), (256, True), (1000, False),
    (1000, True)])
def test_anchors_past_254(max_occ, keep):
    """max_occ past K7b's 16-bit counts (queue 3, F1): an oligo with
    max_occ + 4 hits and one with exactly max_occ, on both sides of a
    chunk boundary; the plain version against tpumap."""
    rng = np.random.default_rng(max_occ)
    k = 8
    C = -(-(20 * max_occ + 400) // 1024) * 1024
    codes, valid, acc, ok = gmap_straddle(rng, C + 220 + 20 * max_occ, 256,
                                          C, max_occ)

    def jax_one(c, v, a, o):
        so, sp = jchain.region_index(c, v, k)
        return jchain.anchors_from_query(so, sp, a, o, max_occ,
                                         keep_overabundant=keep, k=k)
    want = jax.jit(jax.vmap(jax_one))(codes, valid, acc.astype(np.uint32),
                                      ok)
    got = chain.region_anchors_plain(torch.from_numpy(codes),
                                     torch.from_numpy(valid), t64(acc),
                                     torch.from_numpy(ok), k, max_occ, keep)
    for g, w in zip(got, want):
        same(g, w)
    o = got[2].numpy()
    assert o[0, 10].all() == keep and o[0, 30].sum() == max_occ


def test_anchor_lanes_limit():
    """Past ANCHOR_MAX_LANES both paths raise the same error (the card's
    in tests/test_torch_cuda.py)."""
    N, Q = 2, 4096
    max_occ = chain.ANCHOR_MAX_LANES // (N * Q) + 1
    codes = torch.zeros((N, 64), dtype=torch.uint8)
    valid = torch.ones((N, 64), dtype=torch.bool)
    qo = torch.zeros((N, Q), dtype=torch.int64)
    qv = torch.ones((N, Q), dtype=torch.bool)
    for fn in (chain.region_anchors, chain.region_anchors_plain):
        with pytest.raises(ValueError, match="ANCHOR_MAX_LANES|lanes"):
            fn(codes, valid, qo, qv, 8, max_occ)
    d, _q, o = chain.region_anchors(codes, valid, qo[:, :8], qv[:, :8], 8,
                                    300)
    assert d.shape == (N, 8, 300) and o[:, 0, :57].all()


@pytest.fixture(scope="module")
def small_db(tmp_path_factory):
    d = tmp_path_factory.mktemp("gops")
    rng = np.random.default_rng(3)
    g = "".join("ACGT"[i] for i in rng.integers(0, 4, 40_000))
    g = g[:20_000] + "N" * 30 + g[20_030:]
    (d / "g.fa").write_text(f">chr1\n{g}\n")
    db = build_db(d / "g.fa", name="gops", k=12, interval=3)
    return db, g


@pytest.mark.parametrize("mode", ["standard", "cmet-stranded"])
def test_chain_pipeline_windows(small_db, mode):
    """The windowed device pipeline (window extraction, N masks, mode
    maps, anchors, segments, chain, compaction) on one db."""
    db, g = small_db
    from tpumap.utils import dna as jdna
    rng = np.random.default_rng(len(mode))
    qs, starts, lens, sp = [], [], [], []
    for i in range(6):
        a = int(rng.integers(0, 30_000))
        q = g[a:a + 150] + g[a + 900:a + 1100]
        if "N" in q:
            q = q.replace("N", "A")
        c, n = jdna.encode(q)
        qs.append(c)
        starts.append(max(a - 500, 0))
        lens.append(3000)
        sp.append(i % 2)
    Qp, Rp = 512, 4096
    qc = np.zeros((6, Qp), np.uint8)
    qv = np.zeros((6, Qp), bool)
    for i, c in enumerate(qs):
        qc[i, :len(c)] = c
        qv[i, :len(c)] = True
    ws = np.array(starts, np.uint32)
    wl = np.array(lens, np.int32)
    spa = np.array(sp, np.int32)
    cfg = jengine.GmapConfig(mode=mode)
    jidx = JDeviceIndex.from_host(db)
    want = jengine._chain_pipeline_windows(
        jidx.genome_packed, jidx.genome_nmask, jnp.asarray(qc),
        jnp.asarray(qv), jnp.asarray(ws), jnp.asarray(wl), jnp.asarray(spa),
        Rp, cfg)
    tidx = DeviceIndex.from_host(db, "cpu")
    got = engine._chain_pipeline_windows(
        tidx.genome_packed, tidx.genome_nmask, torch.from_numpy(qc),
        torch.from_numpy(qv), t64(ws), torch.from_numpy(wl),
        torch.from_numpy(spa), Rp, engine.GmapConfig(mode=mode))
    for g_, w in zip(got, want):
        same(g_, w)
    assert got[3].sum() >= 6
