"""tpumap_torch ops against their tpumap (JAX on CPU) counterparts.

Inputs are made with numpy from a seed and fed to both packages; every
quantity is an integer, so values (and dtypes where both return the
same kind of array) must be equal exactly. On the CPU the port's kernel
wrappers run their plain PyTorch versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumap.index import build_db
from tpumap.index.device import DeviceIndex as JaxIndex
from tpumap.ops import dp as jdp
from tpumap.ops import pack as jpack
from tpumap.ops import pathdp as jpathdp
from tpumap.ops import seed as jseed
from tpumap.ops import verify as jverify
from tpumap_torch.index.device import DeviceIndex
from tpumap_torch.ops import dp, pack, pathdp, seed, u32, verify

torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.array(a))


def u32_as_i32(a):
    return t(np.asarray(a, dtype=np.uint32).view(np.int32))


def same(jax_out, torch_out, dtype_too=True):
    a = np.asarray(jax_out)
    b = torch_out.numpy() if isinstance(torch_out, torch.Tensor) else torch_out
    if a.dtype == np.uint32:            # port holds uint32 in int64/int32
        b = b.astype(np.int64) & 0xFFFFFFFF
        a = a.astype(np.int64)
        dtype_too = False
    if dtype_too:
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """60 kbp genome with an N run at 700..709, k=12 interval-3 index."""
    rng = np.random.default_rng(21)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 60_000))
    seq = seq[:700] + "N" * 10 + seq[710:]
    fa = tmp_path_factory.mktemp("tops") / "g.fa"
    fa.write_text(">chr1\n" + seq + "\n")
    db = build_db(fa, name="g", k=12, interval=3)
    return seq, db, JaxIndex.from_host(db), DeviceIndex.from_host(db, "cpu")


@pytest.fixture(scope="module")
def reads():
    """40 reads of length <= 128 at random diagonals (some across the N
    run), 2% substitutions, some query Ns."""
    rng = np.random.default_rng(5)
    B, L = 40, 128
    diags = rng.integers(0, 59_800, B)
    diags[:4] = [650, 690, 700, 705]
    lengths = rng.integers(60, L + 1, B).astype(np.int32)
    lengths[0] = L
    return rng, diags, lengths


def codes_for(seq, diags, lengths, L, rng, nfrac=0.02):
    B = len(diags)
    codes = np.zeros((B, L), np.uint8)
    nmask = np.zeros((B, L), bool)
    for b, (d, n) in enumerate(zip(diags, lengths)):
        s = np.frombuffer(seq[d:d + n].encode(), np.uint8)
        c = np.select([s == 67, s == 71, s == 84], [1, 2, 3], 0)
        mut = rng.random(n) < 0.02
        c[mut] = rng.integers(0, 4, int(mut.sum()))
        codes[b, :n] = c
        nmask[b, :n] = (s == 78) | (rng.random(n) < nfrac)
    return codes, nmask


def test_index_arrays_match(genome):
    _seq, _db, ji, ti = genome
    for f in ("genome_packed", "genome_nmask", "offsets", "positions"):
        np.testing.assert_array_equal(
            np.asarray(getattr(ji, f)).view(np.int32),
            getattr(ti, f).numpy())
    assert (ti.genome_length, ti.k, ti.genome_has_n, ti.interval) == (
        ji.genome_length, ji.k, ji.genome_has_n, ji.interval)
    from_j = DeviceIndex.from_jax_arrays(
        {f: np.asarray(getattr(ji, f)) for f in
         ("genome_packed", "genome_nmask", "offsets", "positions",
          "chrom_offsets", "genome_length", "k", "genome_has_n",
          "interval")}, "cpu")
    assert torch.equal(from_j.positions, ti.positions)


@pytest.mark.parametrize("L", [100, 128, 37])
def test_pack_roundtrip_and_revcomp(genome, reads, L):
    seq, *_ = genome
    rng, diags, lengths = reads
    lengths = np.minimum(lengths, L)
    codes, nmask = codes_for(seq, diags, lengths, L, rng)
    jp = jpack.pack_reads(jnp.asarray(codes))
    tp = pack.pack_reads(t(codes))
    same(jp, tp)
    same(jpack.unpack_reads(jp, L), pack.unpack_reads(tp, L))
    same(jpack.revcomp_codes(jnp.asarray(codes), jnp.asarray(lengths)),
         pack.revcomp_codes(t(codes), t(lengths)))
    for comp in (True, False):
        same(jpack.revcomp_packed(jp, jnp.asarray(lengths), complement=comp),
             pack.revcomp_packed(tp, t(lengths), complement=comp))
    assert pack.words_for(L) == jpack.words_for(L)


@pytest.mark.parametrize("k", [12, 14, 16])
def test_revcomp_kmer(k):
    rng = np.random.default_rng(k)
    olig = rng.integers(0, 4 ** k, 64, dtype=np.uint64).astype(np.uint32)
    same(jpack.revcomp_kmer(jnp.asarray(olig), k),
         pack.revcomp_kmer(t(olig.astype(np.int64)), k))


def test_u32_helpers():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2 ** 32, 1000, dtype=np.uint64)
    got = u32.popcount32(t(x.astype(np.int64))).numpy()
    want = np.array([bin(int(v)).count("1") for v in x])
    np.testing.assert_array_equal(got, want)
    v = t(np.array([[3, 1, 3, 2, 3, 1, 0]]))
    vals, idx = u32.stable_topk(v, 5)
    jv, ji = __import__("jax").lax.top_k(jnp.asarray(v.numpy()), 5)
    same(jv, vals, dtype_too=False)
    np.testing.assert_array_equal(np.asarray(ji), idx.numpy())
    assert u32.to_i32(u32.u32(t(np.array([-1, 5], np.int32)))).tolist() \
        == [-1, 5]


@pytest.mark.parametrize("query_unk,genome_unk",
                         [(False, True), (True, True), (False, False),
                          (True, False)])
@pytest.mark.parametrize("has_n", [True, False])
def test_verify_diagonals(genome, reads, query_unk, genome_unk, has_n):
    seq, db, ji, ti = genome
    rng, diags, lengths = reads
    L = 128
    codes, nmask = codes_for(seq, diags, lengths, L, rng)
    cand = np.stack([diags, diags + 1, diags - 3, diags + 16,
                     np.full_like(diags, 0xFFFFFFFF), diags + 59_990], 1)
    cand[cand < 0] = 0
    jp = jpack.pack_reads(jnp.asarray(codes))
    jn = jpack.pack_reads(jnp.asarray(nmask.astype(np.uint8)))
    if not has_n:
        ji = ji.__class__(**{**ji.__dict__, "genome_has_n": False})
        ti = DeviceIndex(**{**ti.__dict__, "genome_has_n": False})
    want = jverify.verify_diagonals(
        ji, jp, jn, jnp.asarray(lengths),
        jnp.asarray(cand.astype(np.uint32)), query_unk=query_unk,
        genome_unk=genome_unk)
    got = verify.verify_diagonals(
        ti, u32_as_i32(jp), u32_as_i32(jn), t(lengths),
        t(cand.astype(np.int64)), query_unk, genome_unk)
    same(want, got)
    # and the per-base mask on the first diagonal
    same(jverify.mismatch_mask_single(
             ji, jp, jn, jnp.asarray(lengths),
             jnp.asarray(cand[:, 2].astype(np.uint32)), L,
             query_unk=query_unk, genome_unk=genome_unk),
         verify.mismatch_mask_single(
             ti, u32_as_i32(jp), u32_as_i32(jn), t(lengths),
             t(cand[:, 2].astype(np.int64)), L, query_unk, genome_unk))


@pytest.mark.parametrize("nwords,width", [(1, 0), (8, 0), (11, 164)])
def test_windows(genome, nwords, width):
    _seq, _db, ji, ti = genome
    starts = np.array([0, 1, 15, 16, 17, 695, 701, 31_999, 59_999, 60_100])
    same(jverify.extract_packed_window(
             ji.genome_packed, jnp.asarray(starts.astype(np.uint32)), nwords),
         verify.extract_packed_window(ti.genome_packed, t(starts), nwords))
    same(jverify.extract_bit_window(
             ji.genome_nmask, jnp.asarray(starts.astype(np.uint32)), nwords),
         verify.extract_bit_window(ti.genome_nmask, t(starts), nwords))
    if width:
        same(jverify.extract_codes_window(
                 ji.genome_packed, jnp.asarray(starts.astype(np.uint32)),
                 width),
             verify.extract_codes_window(ti.genome_packed, t(starts), width))


@pytest.mark.parametrize("max_occ,top_k", [(4, 4), (8, 8), (32, 3)])
def test_seed_reads(genome, reads, max_occ, top_k):
    seq, db, ji, ti = genome
    rng, diags, lengths = reads
    codes, nmask = codes_for(seq, diags, lengths, 128, rng)
    jo, jvalid = jseed.query_oligos(jnp.asarray(codes), jnp.asarray(nmask),
                                    jnp.asarray(lengths), 12)
    to, tvalid = seed.query_oligos(t(codes), t(nmask), t(lengths), 12)
    same(jo, to)
    same(jvalid, tvalid)
    jd, jc = jseed.seed_reads(ji, jnp.asarray(codes), jnp.asarray(nmask),
                              jnp.asarray(lengths), max_occ=max_occ,
                              top_k=top_k)
    td, tc = seed.seed_reads(ti, t(codes), t(nmask), t(lengths),
                             max_occ=max_occ, top_k=top_k)
    same(jd, td)
    same(jc, tc)


def test_prevalent_ties_follow_lax_top_k():
    """Equal support counts: the lower sorted position wins, as in
    lax.top_k."""
    d = np.array([[9, 9, 5, 5, 7, 7, 3, 0xFFFFFFFF, 11, 11]], np.uint32)
    jd, jc = jseed.prevalent_diagonals(jnp.asarray(d), 4)
    td, tc = seed.prevalent_diagonals(t(d.astype(np.int64)), 4)
    same(jd, td)
    same(jc, tc)


@pytest.mark.parametrize("density", [0.02, 0.1, 0.3])
def test_trim_ends(density):
    rng = np.random.default_rng(int(density * 100))
    B, L = 64, 128
    mm = rng.random((B, L)) < density
    mm[:8, :4] = True                    # dirty 5' ends
    mm[8:16, -6:] = True                 # dirty 3' ends
    lengths = rng.integers(20, L + 1, B).astype(np.int32)
    want = jpathdp.trim_ends(jnp.asarray(mm), jnp.asarray(lengths))
    got = pathdp.trim_ends(t(mm), t(lengths))
    for a, b in zip(want, got):
        same(a, b)


def planted_dp_problems(rng, R, Lq, band, margin=4):
    Lg = Lq + band + margin
    g = rng.integers(0, 4, (R, Lg)).astype(np.uint8)
    q = g[:, margin:margin + Lq].copy()
    mut = rng.random((R, Lq)) < 0.04
    q[mut] = rng.integers(0, 4, int(mut.sum()))
    for r in range(R):
        p = int(rng.integers(8, Lq - 8))
        n = int(rng.integers(1, 6))
        if r % 3 == 0:       # deletion from the read
            q[r, p:] = np.concatenate([q[r, p + n:], g[r, :n]])
        elif r % 3 == 1:     # insertion into the read
            q[r, p + n:] = q[r, p:Lq - n].copy()
    qlens = rng.integers(Lq // 2, Lq + 1, R).astype(np.int32)
    return q, qlens, g


def ladder_runs_numpy(ops, maxruns=12):
    """tpumap/gsnap/ladder.py:505-523 applied to a transcript array."""
    rev = ops[:, ::-1]
    valid = rev != jdp.T_END
    prev = np.concatenate([np.full((len(rev), 1), 255, rev.dtype),
                           rev[:, :-1]], 1)
    prev_valid = np.concatenate([np.zeros((len(rev), 1), bool),
                                 valid[:, :-1]], 1)
    newrun = valid & ((rev != prev) | ~prev_valid)
    runidx = np.cumsum(newrun.astype(np.int32), 1) - 1
    nruns = np.max(np.where(valid, runidx, -1), 1) + 1
    onehot = (runidx[:, :, None] == np.arange(maxruns)) & valid[:, :, None]
    run_len = onehot.sum(1).astype(np.uint16)
    run_op = np.max(np.where(onehot, rev[:, :, None] + 1, 0),
                    1).astype(np.uint8)
    return run_op, run_len, nruns


@pytest.mark.parametrize("mode,band,Lq", [("glocal", 32, 128),
                                          ("glocal", 8, 60),
                                          ("global", 16, 64)])
def test_banded_align_and_traceback(mode, band, Lq):
    rng = np.random.default_rng(band + Lq)
    R = 48
    q, qlens, g = planted_dp_problems(rng, R, Lq, band)
    if mode == "global":
        glens = (qlens + rng.integers(-band // 2, band // 2 + 1, R)).astype(
            np.int32)
        glens[0] = qlens[0] + 3 * band     # end outside the band
    else:
        glens = np.minimum(g.shape[1], rng.integers(Lq, g.shape[1] + 8, R)
                           ).astype(np.int32)
    want = jdp.banded_align(jnp.asarray(q), jnp.asarray(qlens),
                            jnp.asarray(g), jnp.asarray(glens), band,
                            jdp.Scoring(), mode)
    got = dp.banded_align(t(q), t(qlens), t(g), t(glens), band, mode=mode)
    for key in ("score", "end_k", "dirs", "H_last"):
        same(want[key], got[key])
    end_k = np.clip(np.asarray(want["end_k"]), 0, 2 * band).astype(np.int32)
    jops, jk = jdp.traceback(want["dirs"], jnp.asarray(qlens),
                             jnp.asarray(end_k), band)
    ops, k_final, run_op, run_len, nruns = dp.traceback(
        got["dirs"], t(qlens), t(end_k), band)
    same(jops, ops)
    same(jk, k_final)
    wop, wlen, wn = ladder_runs_numpy(np.asarray(jops))
    np.testing.assert_array_equal(wop, run_op.numpy())
    np.testing.assert_array_equal(wlen, run_len.numpy().view(np.uint16))
    np.testing.assert_array_equal(wn, nruns.numpy())
    assert (np.asarray(jops) != jdp.T_MATCH).any()   # indels were traced
