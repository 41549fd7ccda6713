"""The plain versions of K8 (the ends rung's lanes) and K4 (end trimming)
against tpumap (JAX on CPU).

tpumap runs its ends rung eagerly (jax.disable_jit) with its
_dedup_lanes and _probe_rank recorded, and the port's end_lanes_plain
must give the recorded lanes: each strand's deduplicated lanes in a
mode, the probe-ranked lanes in standard mode; probe_rank_plain and
_dedup_lanes must equal tpumap's on the recorded and on tie-heavy
inputs; trim_stage_plain must equal tpumap's _trim_stage; and the whole
align_batch_cascaded must equal tpumap's, key for key. The world
(tests/torch_workloads.ends_world) has k = 10 at intervals 1 and 3,
k-mers occurring ~150 and ~400 times, the four base spaces' tables and
a SNP cluster; max_occ runs 1 (fewer than 8 lanes), 4, 32 and 300 (past
what a warp of K8 holds in registers). Every quantity is an integer:
values and dtypes must be equal.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumap.gsnap import driver as jdriver
from tpumap.gsnap import engine as jengine
from tpumap.index.device import DeviceIndex as JaxIndex
from tpumap.utils import dna
from tpumap_torch.gsnap import engine
from tpumap_torch.index.device import DeviceIndex
from tpumap_torch.ops.mode import SPACE_CODES
from torch_workloads import ENDS_K, ends_reads, ends_world, trim_rows

torch.set_num_threads(1)
INVALID = 0xFFFFFFFF
L_READ = 107            # reads of 107 bases: L not a multiple of 16
B_ENDS = 56             # the ends rung's batch (its last rows empty)

# every mode and SNP tolerance: (mode, snp_tolerant)
MODES = {"standard": ("standard", False), "cmet": ("cmet-stranded", False),
         "atoi": ("atoi-stranded", False), "ttoc": ("ttoc-stranded", False),
         "snp": ("standard", True), "cmet_snp": ("cmet-stranded", True)}


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def same(want, got):
    """tpumap's uint32 arrays against the port's int64 values or int32
    bit patterns; every other dtype exactly."""
    a = np.asarray(want)
    b = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    if a.dtype == np.uint32 and b.dtype != np.uint32:
        assert b.dtype in (np.int64, np.int32), b.dtype
        b = b.astype(np.uint32)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def with_n(ji, glen, seed):
    """ji's arrays with N flags in 4% of the genome, for both packages."""
    rng = np.random.default_rng(seed)
    nm = np.asarray(ji.genome_nmask).copy()
    flags = np.zeros(len(nm) * 32, bool)
    flags[:glen] = rng.random(glen) < 0.04
    nm[:(glen + 31) // 32] |= dna.pack_bits(flags)[:(glen + 31) // 32]
    arrays = {f: np.asarray(getattr(ji, f)) for f in (
        "genome_packed", "offsets", "positions", "chrom_offsets",
        "genomealt_packed")}
    arrays.update(genome_nmask=nm, genome_length=glen, k=ji.k,
                  genome_has_n=True, interval=ji.interval)
    alt = {"alt_offsets": {s: np.asarray(v)
                           for s, v in ji.alt_offsets.items()},
           "alt_positions": {s: np.asarray(v)
                             for s, v in ji.alt_positions.items()}}
    jn = JaxIndex(**{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                     for k, v in arrays.items()},
                  **{k: {s: jnp.asarray(a) for s, a in v.items()}
                     for k, v in alt.items()})
    return jn, DeviceIndex.from_jax_arrays(dict(arrays, **alt), "cpu")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{interval: (db, seq, coords, alts, tpumap's index, the port's)}."""
    out = {}
    for iv in (1, 3):
        db, seq, coords, alts = ends_world(
            tmp_path_factory.mktemp(f"ends{iv}"), iv)
        out[iv] = (db, seq, coords, alts, JaxIndex.from_host(db),
                   DeviceIndex.from_host(db, "cpu"))
    return out


def ends_batch(world, mode, seed):
    _db, seq, coords, alts, _ji, _ti = world
    recs = ends_reads(seq, L_READ, seed, None if mode == "standard" else mode,
                      snps=(coords, alts))
    return jdriver.make_batch(recs, B_ENDS, L_READ)


def record(monkeypatch, name):
    """Wrap jengine.<name> to record its arguments and result (None
    where it raised)."""
    calls = []
    fn = getattr(jengine, name)

    def rec(*args):
        calls.append([[np.asarray(a) if hasattr(a, "shape") else a
                       for a in args], None])
        out = fn(*args)
        calls[-1][1] = np.asarray(out)
        return out
    monkeypatch.setattr(jengine, name, rec)
    return calls


# ------------------------------------------------------------------ K8

@pytest.mark.parametrize("max_occ", [1, 4, 32, 300])
@pytest.mark.parametrize("interval", [1, 3])
@pytest.mark.parametrize("name", list(MODES))
def test_end_lanes_match(worlds, monkeypatch, name, interval, max_occ):
    """end_lanes_plain gives tpumap's lanes (each strand's deduplicated
    lanes, in standard mode ranked by the probe), probe_rank_plain its
    ranking, and align_batch_ends its dict."""
    world = worlds[interval]
    ji, ti = world[4], world[5]
    mode, snp = MODES[name]
    batch = ends_batch(world, mode, interval * 10 + max_occ)
    keys = ("codes", "nmask", "lengths")
    cfg = dict(mode=mode, snp_tolerant=snp, top_k=4, max_occ=max_occ)
    dedup = record(monkeypatch, "_dedup_lanes")
    probe = record(monkeypatch, "_probe_rank")
    n_lanes = 2 * interval * max_occ
    # tpumap's standard rung refuses fewer lanes than the probe keeps
    # (lax.top_k); the port ranks them all
    refused = mode == "standard" and n_lanes < engine.ENDS_VERIFY_K
    with jax.disable_jit(), pytest.raises(
            ValueError) if refused else contextlib.nullcontext():
        want = jengine.align_batch_ends(
            ji, {k: jnp.asarray(batch[k]) for k in keys},
            jengine.AlignConfig(**cfg))
    codes, lengths = t(batch["codes"]), t(batch["lengths"])
    tcfg = engine.AlignConfig(**cfg)
    assert len(dedup) == 2
    lanes = [d[1] for d in dedup]
    assert lanes[0].shape == (B_ENDS, min(engine.ENDS_K, n_lanes))
    if mode == "standard":
        assert len(probe) == 1
        (_ji, packed2, lengths2, cands2, keep), ranked = probe[0]
        same(np.concatenate(lanes, 0), cands2)
        if refused:
            keep = n_lanes
            ranked = np.asarray(jengine._probe_rank(
                ji, *(jnp.asarray(a) for a in (packed2, lengths2, cands2)),
                keep))
        got = engine.end_lanes_plain(ti, codes, lengths, tcfg,
                                     t(packed2.view(np.int32)))
        same(ranked, got)
        same(ranked, engine.probe_rank_plain(
            ti, t(packed2.view(np.int32)), t(lengths2),
            t(cands2.astype(np.int64)), keep))
    else:
        assert not probe
        got = engine.end_lanes_plain(ti, codes, lengths, tcfg)
        same(np.stack(lanes), got)
    # the rows shorter than k have no lane; some rows keep more than 3
    # distinct lanes of one strand, and past max_occ 32 some have more
    # than 8 to choose from
    short = batch["lengths"] < ENDS_K
    live = (np.stack(lanes) != INVALID).sum(2)
    assert (live[:, short] == 0).all() and (live == 0).any()
    # (cmet + SNP seeds its converted k-mers from the standard-space SNP
    # index, as tpumap does: few seed at all)
    if max_occ >= 4 and name != "cmet_snp":
        assert (live > 3).any()
    if max_occ >= 32 and name != "cmet_snp":
        assert (live == engine.ENDS_K).any()
    res = engine.align_batch_ends(ti, {k: t(batch[k]) for k in keys}, tcfg)
    if refused:
        return
    assert sorted(res) == sorted(want)
    for key in want:
        same(want[key], res[key])


@pytest.mark.parametrize("width", [2, 6, 8, 24, 192])
def test_dedup_lanes_match(width):
    """_dedup_lanes on lanes with many duplicates and INVALIDs, fewer
    lanes than it keeps, all-INVALID rows and rows of one value."""
    rng = np.random.default_rng(width)
    lanes = rng.integers(0, 12, (64, width)).astype(np.uint32) * 1000
    lanes[rng.random(lanes.shape) < 0.3] = INVALID
    lanes[::7] = INVALID
    lanes[3::7] = 5
    lanes[5::7, :] = rng.integers(0, 2 ** 32 - 1, (len(lanes[5::7]), width))
    want = jengine._dedup_lanes(jnp.asarray(lanes), engine.ENDS_K)
    same(want, engine._dedup_lanes(t(lanes.astype(np.int64)),
                                   engine.ENDS_K))


@pytest.mark.parametrize("keep,width", [(3, 8), (2, 2), (1, 8)])
def test_probe_rank_ties_match(worlds, keep, width):
    """probe_rank_plain on lanes whose probe words tie (diagonals one
    repeat unit apart in the 20-bp repeat read the same genome word), with
    INVALID lanes and all-INVALID rows: tpumap's ranking, ties to the
    lower lane."""
    db, _seq, _c, _a, ji, ti = worlds[3]
    rng = np.random.default_rng(keep * 10 + width)
    R = 64
    base = rng.integers(36000, 43000, R)
    cands = (base[:, None] + 20 * rng.integers(0, 40, (R, width))).astype(
        np.uint32)
    cands[:, ::3] = rng.integers(0, 30000, (R, len(cands[0, ::3])))
    cands[rng.random(cands.shape) < 0.2] = INVALID
    cands[::9] = INVALID
    lengths2 = rng.integers(0, L_READ + 1, R).astype(np.int32)
    codes = db.get_codes(0, db.genome_length)
    packed2 = np.stack([dna.pack_2bit(codes[b:b + 112])[:7] for b in base])
    packed2 = packed2.astype(np.uint32)
    want = jengine._probe_rank(ji, jnp.asarray(packed2),
                               jnp.asarray(lengths2), jnp.asarray(cands),
                               keep)
    got = engine.probe_rank_plain(ti, t(packed2.view(np.int32)),
                                  t(lengths2), t(cands.astype(np.int64)),
                                  keep)
    same(want, got)


@pytest.mark.parametrize("max_occ", [1, 4, 32, 300])
@pytest.mark.parametrize("interval", [1, 3])
@pytest.mark.parametrize("name", list(MODES))
def test_end_lanes_design_matches_plain(worlds, name, interval, max_occ):
    """K8's design, emulated (emulate_end_lanes: 1 or 2 reads a warp on
    the register paths), gives end_lanes_plain's lanes in every mode,
    at intervals 1 and 3 and max_occ 1 (fewer lanes than 8), 4, 32 and
    300 (the scratch path), on reads of 107 bases (rows not 4-byte
    aligned) with reads shorter than k and INVALID lanes."""
    ti = worlds[interval][5]
    mode, snp = MODES[name]
    batch = ends_batch(worlds[interval], mode, interval * 10 + max_occ)
    codes, lengths = t(batch["codes"]), t(batch["lengths"])
    cfg = engine.AlignConfig(mode=mode, snp_tolerant=snp, top_k=4,
                             max_occ=max_occ)
    packed2 = None
    if mode == "standard":
        packed = engine.pack.pack_reads(codes)
        packed2 = torch.cat([packed, engine.pack.revcomp_packed(
            packed, lengths)], 0)
    want = engine.end_lanes_plain(ti, codes, lengths, cfg, packed2)
    per = engine.end_lanes_per(2 * interval, max_occ)
    for rp in ((1, 2) if per == 1 else (1,) if per else (None,)):
        got = emulate_end_lanes(ti, codes, lengths, cfg, packed2, rp)
        same(want.numpy(), got)
    assert bool((want == INVALID).any()) and bool((want != INVALID).any())


@pytest.mark.parametrize("max_occ", [4, 1000])
def test_end_lanes_design_long_reads(worlds, max_occ):
    """K8's design on reads of up to 7,680 bases (L = 7,680), standard
    and cmet, against end_lanes_plain."""
    _db, seq, _c, _a, _ji, ti = worlds[3]
    rng = np.random.default_rng(max_occ)
    starts, lens = rng.integers(0, 40000, 24), rng.integers(5, 7681, 24)
    recs = [(seq[p:p + n]) for p, n in zip(starts, lens)]
    recs.append(seq[36000:43680])
    L = 7680
    codes = np.zeros((len(recs), L), np.uint8)
    for r, s in enumerate(recs):
        codes[r, :len(s)] = ["ACGT".index(c) for c in s]
    codes, lengths = t(codes), t(np.array([len(s) for s in recs], np.int32))
    for mode in ("standard", "cmet-stranded"):
        cfg = engine.AlignConfig(mode=mode, top_k=4, max_occ=max_occ)
        packed2 = None
        if mode == "standard":
            packed = engine.pack.pack_reads(codes)
            packed2 = torch.cat([packed, engine.pack.revcomp_packed(
                packed, lengths)], 0)
        same(engine.end_lanes_plain(ti, codes, lengths, cfg, packed2).numpy(),
             emulate_end_lanes(ti, codes, lengths, cfg, packed2))


# ------------------------------------------------------------------ K4

@pytest.mark.parametrize("genome", ["plain", "n_qunk", "n_gunk"])
@pytest.mark.parametrize("quals", [False, True])
@pytest.mark.parametrize("snp", [False, True])
@pytest.mark.parametrize("mode", ["standard", "cmet-stranded",
                                  "atoi-stranded", "ttoc-stranded"])
def test_trim_stage_matches(worlds, mode, snp, quals, genome):
    """trim_stage_plain against tpumap's _trim_stage in every mode, with
    and without the alternate genome and quals; N flags in reads and
    genome under query_unk (True, genome_unk False) and genome_unk
    (query_unk False, genome_unk True)."""
    db, _seq, _c, _a, ji, ti = worlds[3]
    qunk = genome == "n_qunk"
    if genome != "plain":
        ji, ti = with_n(ji, db.genome_length, 3)
    rng = np.random.default_rng(len(mode) * 8 + 4 * snp + 2 * quals
                                + len(genome))
    rows = trim_rows(rng, db.get_codes(0, db.genome_length), 72, L_READ,
                     0.02 if genome != "plain" else 0.0)
    check_trim(ji, ti, rows, mode, snp, quals, qunk, not qunk)


@pytest.mark.parametrize("L,B", [(300, 32), (7680, 6), (69633, 2)])
@pytest.mark.parametrize("mode", ["standard", "cmet-stranded"])
def test_trim_stage_long_reads(worlds, mode, L, B):
    """Windows of 16 words or more (tpumap clamps their start) and past
    the genome's padding (zero-extended), at read lengths up to 69,633."""
    db, _seq, _c, _a, ji, ti = worlds[1]
    rng = np.random.default_rng(L)
    gcodes = db.get_codes(0, db.genome_length)
    if L > db.genome_length:
        gcodes = np.concatenate([gcodes] * (L // len(gcodes) + 2))
    rows = trim_rows(rng, gcodes, B, L)
    check_trim(ji, ti, rows, mode, True, True, False, True)


def check_trim(ji, ti, rows, mode, snp, quals, qunk, gunk):
    codes, nmask, lengths, strand, diag, q = rows
    cfg = dict(mode=mode, snp_tolerant=snp, query_unk_mismatch=qunk,
               genome_unk_mismatch=gunk)
    want = jengine._trim_stage(
        ji, jnp.asarray(codes), jnp.asarray(nmask), jnp.asarray(lengths),
        {"strand": jnp.asarray(strand),
         "diag": jnp.asarray(diag.astype(np.uint32))},
        jengine.AlignConfig(**cfg), quals=jnp.asarray(q) if quals else None)
    got = engine.trim_stage_plain(
        ti, t(codes), t(nmask), t(lengths),
        {"strand": t(strand), "diag": t(diag)}, engine.AlignConfig(**cfg),
        quals=t(q) if quals else None)
    assert sorted(got) == sorted(want)
    for key in want:
        same(want[key], got[key])
    # trimming cut some rows at each end, and kept others whole
    qs, qe = np.asarray(want["trim_qstart"]), np.asarray(want["trim_qend"])
    if len(qs) >= 6:
        assert (qs > 0).any() and (qe < lengths).any()
        assert ((qs == 0) & (qe == lengths)).any()


@pytest.mark.parametrize("L", [107, 128])
@pytest.mark.parametrize("genome", ["plain", "n_qunk", "n_gunk"])
@pytest.mark.parametrize("quals", [False, True])
@pytest.mark.parametrize("snp", [False, True])
@pytest.mark.parametrize("mode", ["standard", "cmet-stranded",
                                  "atoi-stranded", "ttoc-stranded"])
def test_trim_design_matches_plain(worlds, mode, snp, quals, genome, L):
    """K4's design, emulated (emulate_trim: a segment of 8 lanes a row;
    byte loads at L = 107, 16-byte loads and mirrored words at L = 128),
    gives trim_stage_plain's dict in every mode, with and without the
    alternate genome and quals, under both N semantics: INVALID
    diagonals, the rc strand, reads of 0 to L bases."""
    db, _seq, _c, _a, ji, ti = worlds[3]
    qunk = genome == "n_qunk"
    if genome != "plain":
        ji, ti = with_n(ji, db.genome_length, 3)
    rng = np.random.default_rng(len(mode) * 8 + 4 * snp + 2 * quals
                                + len(genome) + L)
    rows = trim_rows(rng, db.get_codes(0, db.genome_length), 72, L,
                     0.02 if genome != "plain" else 0.0)
    check_trim_design(ti, rows, mode, snp, quals, qunk, not qunk)


@pytest.mark.parametrize("L,B", [(16, 40), (17, 40), (100, 40), (129, 40),
                                 (256, 24), (512, 16), (513, 8),
                                 (7680, 3), (69633, 2)])
def test_trim_design_lengths(worlds, L, B):
    """K4's design at the edges of its layouts: one lane a row (L = 16),
    two (17), 8 (100), 16 (129, 256), 32 (512) and a warp a row past 32
    words (513, 7,680), with its words in the global scratch (69,633);
    standard and cmet, with quals and the alternate genome."""
    db, _seq, _c, _a, _ji, ti = worlds[1]
    rng = np.random.default_rng(L)
    gcodes = db.get_codes(0, db.genome_length)
    if L > db.genome_length:
        gcodes = np.concatenate([gcodes] * (L // len(gcodes) + 2))
    rows = trim_rows(rng, gcodes, B, L)
    for mode in ("standard", "cmet-stranded"):
        check_trim_design(ti, rows, mode, True, True, False, True)


def check_trim_design(ti, rows, mode, snp, quals, qunk, gunk):
    codes, nmask, lengths, strand, diag, q = (t(a) for a in rows)
    cfg = engine.AlignConfig(mode=mode, snp_tolerant=snp,
                             query_unk_mismatch=qunk,
                             genome_unk_mismatch=gunk)
    res = {"strand": strand, "diag": diag}
    want = engine.trim_stage_plain(ti, codes, nmask, lengths, res, cfg,
                                   quals=q if quals else None)
    got = emulate_trim(ti, codes, nmask, lengths, res, cfg,
                       q if quals else None)
    assert sorted(got) == sorted(want)
    for key in want:
        same(want[key].numpy(), got[key])


# ---------------------------------------------------------- the cascade

@pytest.mark.parametrize("name,interval,max_occ", [
    ("standard", 1, 4), ("cmet", 3, 32), ("snp", 3, 300)])
def test_cascade_with_quals_matches(worlds, name, interval, max_occ):
    """align_batch_cascaded (the ends rung, the prevalent rung and the
    trim stage with quals) gives tpumap's dict, key for key."""
    world = worlds[interval]
    ji, ti = world[4], world[5]
    mode, snp = MODES[name]
    batch = ends_batch(world, mode, 99)
    rng = np.random.default_rng(interval)
    batch["quals"] = rng.integers(0, 41, batch["codes"].shape).astype(
        np.uint8)
    keys = ("codes", "nmask", "lengths", "quals")
    cfg = dict(mode=mode, snp_tolerant=snp, top_k=4, max_occ=max_occ)
    want = jengine.align_batch_cascaded(
        ji, {k: jnp.asarray(batch[k]) for k in keys},
        jengine.AlignConfig(**cfg), 3, 16)
    got = engine.align_batch_cascaded(ti, {k: t(batch[k]) for k in keys},
                                      engine.AlignConfig(**cfg), 3, 16)
    assert sorted(got) == sorted(want)
    for key in want:
        same(want[key], got[key])
    assert "mm_qualsum" in got and np.asarray(want["mapped"]).any()


# ------------------------------------------- the kernels' designs, emulated
#
# numpy emulations of K8 (csrc/ends.cu) and K4 (csrc/trim.cu) as the card
# runs them, lane by lane: the same split of rows over warps and segments,
# the same loads (aligned words, 16-byte rows, byte loads), scans,
# reductions, ballots, selection rounds and early probe. They run here,
# where the kernels cannot, and must give the plain versions' results.

M32 = 0xFFFFFFFF
LOW = 0x55555555


def u32a(x):
    """A torch int32 bit-pattern tensor as an int64 numpy array of uint32
    values."""
    return x.numpy().astype(np.int64) & M32


def ld_clip(a, i):
    return int(a[min(max(i, 0), len(a) - 1)])


def end_qpos(e, iv, qlast):
    if e < iv:
        return min(e, qlast)
    return max(qlast - (2 * iv - 1 - e), 0)


def pack_be4(y):
    y &= 0x03030303
    return ((y & 3) << 6) | ((y >> 4) & 0x30) | ((y >> 14) & 0xC) | (y >> 24)


def pack_le4(y):
    y &= 0x03030303
    return (y & 3) | ((y >> 6) & 0xC) | ((y >> 12) & 0x30) | (
        (y >> 18) & 0xC0)


def map_codes(w, lut):
    hi, lo = (w >> 1) & LOW, w & LOW
    return ((~(hi | lo) & LOW) * (lut & 3) + (~hi & lo & LOW)
            * ((lut >> 2) & 3) + (hi & ~lo & LOW) * ((lut >> 4) & 3)
            + (hi & lo) * ((lut >> 6) & 3)) & M32


def funnel_r(lo, hi, sh):
    return (((hi << 32) | lo) >> sh) & M32


def word_at(flat, wa):
    """The aligned 4-byte word wa of a flat byte array (bytes past the
    end 0), little-endian."""
    return sum(int(flat[4 * wa + t]) << (8 * t) for t in range(4)
               if 4 * wa + t < len(flat))


def emulate_end_lanes(ti, codes, lengths, cfg, packed2=None, rp=None):
    """K8's result, as the kernel computes it (register paths: rp reads a
    warp, end_lanes_reads's on an H100 by default; the scratch path past
    256 lanes)."""
    B, L = codes.shape
    k, iv = ti.k, engine._ends_iv(ti)
    NE, occ = 2 * iv, max(int(cfg.max_occ), 0)
    N = NE * occ
    K = min(engine.ENDS_K, N)
    standard = engine.MODE_SPACES[cfg.mode] == (None, None)
    keep = min(engine.ENDS_VERIFY_K, K) if standard else 0
    out = np.zeros((2 * B, keep) if standard else (2 * B, K), np.int64)
    tables = [(u32a(o), u32a(p)) for o, p in engine._end_tables(ti, cfg)]
    luts = [engine._code_lut(s) for s in engine.MODE_SPACES[cfg.mode]]
    genome = u32a(ti.genome_packed)
    p2 = None if packed2 is None else u32a(packed2)
    flat = codes.numpy().reshape(-1)
    lens = lengths.numpy().astype(np.int64)
    W = 0 if p2 is None else p2.shape[1]
    per = engine.end_lanes_per(NE, occ)

    def kmer_range(s, o):
        offs = tables[s][0]
        st = ld_clip(offs, o)
        cnt = ld_clip(offs, o + 1) - st
        return st, (cnt if 0 < cnt <= occ else 0)

    def diag(s, st, lane, q):
        p = ld_clip(tables[s][1], st + lane)
        return p - q if p >= q else INVALID

    def probe(v, pw, rw):
        start = (v + pw * 16) & M32
        sh = (start & 15) << 1
        g = ld_clip(genome, start >> 4) >> sh
        if sh:
            g |= (ld_clip(genome, (start >> 4) + 1) << (32 - sh)) & M32
        d = rw ^ g
        return bin((d | (d >> 1)) & LOW).count("1")

    def rank_out(row, sel, pm, nv=K):
        """Rank the kept lanes by (pm, lane) among the first nv (a row's
        valid ones on the register paths: its INVALID ones rank as they
        stand) and keep the first `keep`."""
        for r in range(K):
            rank = r if r >= nv else sum(
                (pm[i] < pm[r]) or (pm[i] == pm[r] and i < r)
                for i in range(nv))
            if rank < keep:
                out[row, rank] = sel[r]

    if per == 0:
        # one warp a row: k-mers rolled from byte loads, the live lanes in
        # the scratch, then the probe on the kept lanes
        for row in range(2 * B):
            s, b = divmod(row, B)
            ln = int(lens[b])
            sc = []
            if ln >= k:
                for e in range(NE):
                    qp = end_qpos(e, iv, ln - k)
                    o = 0
                    for j in range(k):
                        p = min(max(ln - 1 - (qp + j) if s else qp + j, 0),
                                L - 1)
                        code = (3 - int(codes[b, p]) if s
                                else int(codes[b, p])) & 3
                        o = ((o << 2) | ((luts[s] >> (2 * code)) & 3)) & M32
                    st, n = kmer_range(s, o)
                    sc += [diag(s, st, lane, qp) for lane in range(n)]
            sel, lo = [INVALID] * K, 0
            for r in range(K):
                m = min([x for x in sc if x >= lo], default=INVALID)
                sel[r] = m
                if m == INVALID:
                    break
                lo = m + 1
            if keep == 0:
                out[row] = sel
                continue
            pw = min(max(ln // 32, 0), W - 1)
            rank_out(row, sel, [probe(x, pw, int(p2[row, pw]))
                                if x != INVALID else 999 for x in sel])
        return torch.from_numpy(out if standard else out.reshape(2, B, K))

    RP = rp or engine.end_lanes_reads(per, B, 132)
    R, H = 2 * RP, k + iv - 1
    for b0 in range(0, B, RP):
        # a warp: RP reads, rows j = s * RP + r
        slen = [int(lens[b0 + r]) if b0 + r < B else -1 for r in range(RP)]
        # each read's two end spans, as the aligned words that hold them
        words = np.zeros((RP, 18), np.int64)
        for r in range(RP):
            row = (b0 + r) * L
            for w in range(18):
                ln, h = slen[r], w // 9
                st = max(ln - H, 0) if h else 0
                wa = ((row + st) >> 2) + w % 9
                if ln >= k and 4 * wa < row + min(st + H, ln):
                    words[r, w] = word_at(flat, wa)
        info = np.zeros((R * NE, 3), np.int64)      # (start, n, q)
        for u in range(R * NE):
            j, e = divmod(u, NE)
            s, r = divmod(j, RP)
            ln = slen[r]
            if ln < k:
                continue
            qp = end_qpos(e, iv, ln - k)
            p = ln - qp - k if s else qp
            # the head span holds the fwd head k-mers and the rc tail ones
            h = int(e >= iv) ^ s
            sst = max(ln - H, 0) if h else 0
            off = (((b0 + r) * L + sst) & 3) + (p - sst)
            x = [int(v) for v in words[r, 9 * h + (off >> 2):
                                       9 * h + (off >> 2) + 5]]
            o = 0
            for i in range(4):
                y = funnel_r(x[i], x[i + 1], (off & 3) * 8)
                o |= (pack_le4(y) << (8 * i)) if s else (
                    pack_be4(y) << (24 - 8 * i))
            o = map_codes(~o & M32, luts[1]) if s else map_codes(o, luts[0])
            o = o & ((1 << (2 * k)) - 1) if s else o >> (32 - 2 * k)
            info[u] = (*kmer_range(s, o), qp)
        # the lanes: lane i = p * 32 + thread of each row, each k-mer's
        # occurrences in turn; with 8 a thread the live ones packed
        v = np.full((R, per, 32), INVALID, np.int64)
        nreg = 1
        for j in range(R):
            kin = info[j * NE:(j + 1) * NE]
            first = np.concatenate([[0], np.cumsum(kin[:, 1])])
            nreg = max(nreg, (int(first[-1]) + 31) >> 5)
            for p in range(per):
                for t in range(32):
                    i = p * 32 + t
                    if per == 1 and i < N:
                        e, lane = divmod(i, occ)
                        st, n, q = kin[e]
                        if lane < n:
                            v[j, p, t] = diag(j // RP, int(st), lane, int(q))
                    elif per > 1 and i < first[-1]:
                        e = 0
                        while e + 1 < NE and first[e + 1] <= i:
                            e += 1
                        st, _n, q = kin[e]
                        v[j, p, t] = diag(j // RP, int(st), i - int(first[e]),
                                          int(q))
        # the rounds run over the registers the warp's rows fill
        NR = per if per == 1 else min(r for r in (1, 2, 4, 8) if r >= nreg)
        v = v[:, :NR]
        # the selection rounds; sel[j][r] sits at thread (j % 4) * 8 + r
        sel = [[INVALID] * 8 for _ in range(R)]
        lo, live = [0] * R, set(range(R))
        for r in range(K):
            for j in sorted(live):
                c = v[j][v[j] >= lo[j]]
                m = int(c.min()) if c.size else INVALID   # the warp min
                sel[j][r] = m
                if m == INVALID:
                    live.discard(j)
                lo[j] = m + 1
            if not live:
                break
        for j in range(R):
            s, r = divmod(j, RP)
            b = b0 + r
            if b >= B:
                continue
            row = s * B + b
            if not standard:
                out[row] = sel[j][:K]
                continue
            # the probe of every live lane, then each kept lane's from a
            # lane that holds it
            pw = min(max(slen[r] // 32, 0), W - 1)
            rw = int(p2[row, pw])
            pm = np.array([[probe(int(x), pw, rw) if x != INVALID else 0
                            for x in v[j, p]] for p in range(NR)])
            pmv = [999] * 8
            for rr in range(K):
                if sel[j][rr] == INVALID:
                    break
                pmv[rr] = int(np.where(v[j] == sel[j][rr], pm, 999).min())
            rank_out(row, sel[j], pmv,
                     sum(x != INVALID for x in sel[j][:K]))
    return torch.from_numpy(out if standard else out.reshape(2, B, K))


def emulate_trim(ti, codes, nmask, lengths, res, cfg, quals=None):
    """K4's result, as the kernel computes it: rows of up to 32 words on
    segments of lanes (one word a lane); longer rows one warp each, its
    lanes' chunks of words."""
    B, L = codes.shape
    W = (L + 15) // 16
    genome, gnm = u32a(ti.genome_packed), u32a(ti.genome_nmask)
    galt = u32a(ti.genomealt_packed) if cfg.snp_tolerant else None
    sf, sr = (SPACE_CODES[s] for s in engine.MODE_SPACES[cfg.mode])
    c8, n8 = codes.numpy(), nmask.numpy().view(np.uint8)
    q8 = None if quals is None else quals.numpy()
    lens = lengths.numpy().astype(np.int64)
    strand, diag = res["strand"].numpy(), res["diag"].numpy()
    out = np.zeros((4 if quals is None else 6, B), np.int32)
    seg = 1 << (W - 1).bit_length() if 0 < W <= 32 else 0
    vec = L % 16 == 0

    def to_space(w, space):
        if space == 1:
            return w | ((w & LOW) << 1)
        if space == 2:
            return w & ~((~w & LOW) << 1) & M32
        if space == 3:
            return w | ((~(w | (w >> 1)) & LOW) << 1)
        if space == 4:
            return w & ~(((w & (w >> 1)) & LOW) << 1) & M32
        return w

    def fold(x):
        return (x | (x >> 1)) & LOW

    def compress16(x):
        return sum(((x >> (2 * t)) & 1) << t for t in range(16))

    def spread16(x):
        return sum(((x >> t) & 1) << (2 * t) for t in range(16))

    def window_start(start, n):
        w0, zext = start >> 4, False
        if W >= 16:
            zext = W + 1 > engine.SAFE_PAD_WORDS
            w0 = min(w0, n if zext else max(n - (W + 1), 0))
        return w0, zext

    def window_word(g, w, s2, zext):
        lo = 0 if zext and w >= len(g) else ld_clip(g, w)
        hi = 0
        if s2:
            hi = ((0 if zext and w + 1 >= len(g) else ld_clip(g, w + 1))
                  << (32 - s2)) & M32
        return (lo >> s2) | hi

    def from_base(j, lo):
        t = lo - 16 * j
        return 0xFFFF if t <= 0 else (0 if t >= 16 else (0xFFFF << t)
                                      & 0xFFFF)

    def row_bytes16(a, b, ln, lim, rc, j, v16):
        """16 bytes of row b for bases 16 j .. 16 j + 15 (t order)."""
        row = a[b]
        if v16 and not rc:
            return [int(x) for x in row[16 * j:16 * j + 16]]
        if v16:
            o = ln - 16 * (j + 1)
            w0 = o >> 2
            x = [sum(int(row[4 * w + t]) << (8 * t) for t in range(4))
                 if 0 <= w and 4 * w < L else 0 for w in range(w0, w0 + 5)]
            mem = []
            for kk in range(4):
                y = funnel_r(x[kk], x[kk + 1], (o & 3) * 8)
                mem += [(y >> (8 * t)) & 0xFF for t in range(4)]
            return mem[::-1]
        return [int(row[min(ln - 1 - (16 * j + u) if rc else 16 * j + u,
                            L - 1)]) if 16 * j + u < lim else 0
                for u in range(16)]

    def mismatch_word(b, j, ln, lim, rc, space, v16):
        if 16 * j >= lim:
            return 0
        d = int(diag[b])
        if d == INVALID:
            m16 = 0xFFFF
        else:
            start = d & M32
            s2 = (start & 15) << 1
            w0, zext = window_start(start, len(genome))
            cw = row_bytes16(c8, b, ln, lim, rc, j, v16)
            nw = row_bytes16(n8, b, ln, lim, rc, j, v16)
            r = sum((c & 3) << (2 * t) for t, c in enumerate(cw))
            r = to_space((~r & M32) if rc else r, space)
            qn = sum(int(c != 0) << (2 * t) for t, c in enumerate(nw))
            mm = fold(r ^ to_space(window_word(genome, w0 + j, s2, zext),
                                   space))
            if galt is not None:
                wa, za = window_start(start, len(galt))
                mm &= fold(r ^ to_space(window_word(galt, wa + j, s2, za),
                                        space))
            mm = (mm | qn) if cfg.query_unk_mismatch else (mm & ~qn)
            if ti.genome_has_n:
                bb, sb = start >> 5, start & 31
                x = ld_clip(gnm, bb + (j >> 1)) >> sb
                if sb:
                    x |= (ld_clip(gnm, bb + (j >> 1) + 1) << (32 - sb)) & M32
                gm = spread16(((x >> 16) if j & 1 else x) & 0xFFFF)
                mm = (mm | gm) if cfg.genome_unk_mismatch else (mm & ~gm)
            m16 = compress16(mm)
        if lim - 16 * j < 16:
            m16 &= (1 << (lim - 16 * j)) - 1
        return m16

    def bits(x, descending):
        i = [t for t in range(16) if (x >> t) & 1]
        return i[::-1] if descending else i

    KNEG = -(1 << 20) * 1024

    def scan(n, key, suffix):
        """The segment's inclusive (count, best key) scan: shfl_down (or
        up) by d within the segment, a block's keys less 4096 a
        mismatch scanned before it."""
        S = len(n)
        d = 1
        while d < S:
            src = [sl + d if suffix else sl - d for sl in range(S)]
            on = [n[x] if 0 <= x < S else n[sl] for sl, x in enumerate(src)]
            ok = [key[x] if 0 <= x < S else key[sl]
                  for sl, x in enumerate(src)]
            for sl in range(S):
                if 0 <= src[sl] < S:
                    key[sl] = max(ok[sl], key[sl] - 4096 * on[sl])
                    n[sl] += on[sl]
            d <<= 1

    def segment_row(b):
        ln = int(lens[b])
        lim = min(ln, L)
        rc = strand[b] == 1
        space = sr if rc else sf
        v16 = vec and ln <= L
        m16 = [mismatch_word(b, j, ln, lim, rc, space, v16) if j < W else 0
               for j in range(seg)]
        qs, qe, nmm = 0, ln, 0
        if any(m16):
            # qstart: keys (len - i - 1 - 4 x right) x 1024 + 1023 - i
            n, key = [bin(w).count("1") for w in m16], [KNEG] * seg
            for j, w in enumerate(m16):
                for s_, t in enumerate(bits(w, True)):
                    i = 16 * j + t
                    key[j] = max(key[j], (ln - i - 1 - 4 * s_) * 1024
                                 + 1023 - i)
            scan(n, key, True)
            above = n[1:] + [0]
            run = key[1:] + [KNEG]
            m, total = n[0], key[0]
            term, bkey = [-1] * seg, [0] * seg
            for j, w in enumerate(m16):
                rj = run[j]
                for s_, t in enumerate(bits(w, True)):
                    i = 16 * j + t
                    sc = ln - i - 1 - 4 * (above[j] + s_)
                    kk = sc * 1024 + 1023 - i
                    if sc < (rj >> 10) and sc + i + 1 < 0:
                        term[j], bkey[j] = i, max(kk, rj)
                        break
                    rj = max(rj, kk)
            stops = [j for j in range(seg) if term[j] >= 0]
            if stops:
                total = bkey[max(stops)]
            best, bpos = total >> 10, 1023 - (total & 1023)
            l0 = min(j for j in range(seg) if m16[j])
            lowest = 16 * l0 + bits(m16[l0], False)[0]
            keep = not stops and (bpos == lowest or ln - 4 * m >= best)
            qs = min(0 if keep else bpos + 1, ln)
            # qend: keys (i - qs - 4 x below) x 1024 + i
            w2 = [w & from_base(j, qs) for j, w in enumerate(m16)]
            if any(w2):
                n, key = [bin(w).count("1") for w in w2], [KNEG] * seg
                for j, w in enumerate(w2):
                    for s_, t in enumerate(bits(w, False)):
                        i = 16 * j + t
                        key[j] = max(key[j], (i - qs - 4 * s_) * 1024 + i)
                scan(n, key, False)
                below = [0] + n[:-1]
                run = [KNEG] + key[:-1]
                m2, total = n[-1], key[-1]
                term, bkey = [-1] * seg, [0] * seg
                for j, w in enumerate(w2):
                    rj = run[j]
                    for s_, t in enumerate(bits(w, False)):
                        i = 16 * j + t
                        sc = i - qs - 4 * (below[j] + s_)
                        kk = sc * 1024 + i
                        if sc < (rj >> 10) and sc + (ln - i) < 0:
                            term[j], bkey[j] = i, max(kk, rj)
                            break
                        rj = max(rj, kk)
                stops = [j for j in range(seg) if term[j] >= 0]
                if stops:
                    total = bkey[min(stops)]
                best2, bpos2 = total >> 10, total & 1023
                lh = max(j for j in range(seg) if w2[j])
                highest = 16 * lh + bits(w2[lh], True)[0]
                keep2 = not stops and (bpos2 == highest
                                       or (ln - qs) - 4 * m2 >= best2)
                lb = bpos2 >> 4
                js2 = below[lb] + bin(w2[lb] & ((1 << (bpos2 & 15)) - 1)
                                      ).count("1")
                qe = ln if keep2 else max(bpos2, qs)
                nmm = m2 if keep2 else js2
        out[0, b], out[1, b] = qs, qe
        out[2, b], out[3, b] = 8 * (qe - qs - nmm) - 24 * nmm, nmm
        if q8 is not None:
            qsum = mmsum = 0
            for j in range(min(seg, W)):
                if 16 * j >= lim:
                    continue
                qv = row_bytes16(q8, b, ln, lim, rc, j, v16)
                kept = (from_base(j, qs) & ~from_base(j, qe)
                        & from_base(j, 0) & ~from_base(j, lim))
                qsum += sum(qv[t] for t in range(16) if (kept >> t) & 1)
                mmsum += sum(qv[t] for t in range(16)
                             if (kept & m16[j]) >> t & 1)
            out[4, b] = mmsum
            out[5, b] = (16 * qsum) // max(qe - qs, 1)

    def wide_row(b):
        """A warp a row: lane t's chunk of words [t cw, t cw + cw); the
        old reduction sequence."""
        ln = int(lens[b])
        lim = min(ln, L)
        rc = strand[b] == 1
        space = sr if rc else sf
        mw = [mismatch_word(b, j, ln, lim, rc, space, False)
              for j in range(W)]
        mis = [16 * j + t for j in range(W) for t in bits(mw[j], False)]
        cw = (W + 31) // 32
        chunks = [(min(t * cw, W), min(min(t * cw, W) + cw, W))
                  for t in range(32)]

        def lane_of(i):
            return next(t for t, (a, z) in enumerate(chunks)
                        if a <= i // 16 < z)
        # qstart: per lane counts, exclusive suffix sums, chunk maxima,
        # exclusive suffix max, each lane's first stop, the best
        NEG = -(1 << 20)
        per_lane = [[i for i in mis if lane_of(i) == t] for t in range(32)]
        cnt = [len(x) for x in per_lane]
        above = [sum(cnt[t + 1:]) for t in range(32)]
        m = sum(cnt)

        def sc1(i, t, seen):
            return ln - i - 1 - 4 * (above[t] + seen)
        cmax = [max([sc1(i, t, s_) for s_, i in
                     enumerate(sorted(per_lane[t], reverse=True))],
                    default=NEG) for t in range(32)]
        runs = [max(cmax[t + 1:], default=NEG) for t in range(32)]
        terms = []
        for t in range(32):
            run = runs[t]
            for s_, i in enumerate(sorted(per_lane[t], reverse=True)):
                sc = sc1(i, t, s_)
                if sc < run and sc + i + 1 < 0:
                    terms.append(i)
                    break
                run = max(run, sc)
        first = max(terms, default=-1)
        cand = [(sc1(i, t, s_), i) for t in range(32) for s_, i in
                enumerate(sorted(per_lane[t], reverse=True)) if i >= first]
        best = max((c for c, _ in cand), default=NEG)
        bpos = min((i for c, i in cand if c == best), default=L)
        js = sum(1 for i in mis if i > bpos)
        keep = m == 0 or (first < 0 and (js == m - 1 or ln - 4 * m >= best))
        qs = min(0 if keep else bpos + 1, ln)
        mis2 = [i for i in mis if i >= qs]
        per2 = [[i for i in mis2 if lane_of(i) == t] for t in range(32)]
        cnt2 = [len(x) for x in per2]
        below = [sum(cnt2[:t]) for t in range(32)]
        m2 = sum(cnt2)

        def sc2(i, t, seen):
            return i - qs - 4 * (below[t] + seen)
        cmax = [max([sc2(i, t, s_) for s_, i in enumerate(sorted(per2[t]))],
                    default=NEG) for t in range(32)]
        runs = [max(cmax[:t], default=NEG) for t in range(32)]
        terms = []
        for t in range(32):
            run = runs[t]
            for s_, i in enumerate(sorted(per2[t])):
                sc = sc2(i, t, s_)
                if sc < run and sc + (ln - i) < 0:
                    terms.append(i)
                    break
                run = max(run, sc)
        first2 = min(terms, default=L)
        cand = [(sc2(i, t, s_), i) for t in range(32)
                for s_, i in enumerate(sorted(per2[t])) if i <= first2]
        best2 = max((c for c, _ in cand), default=NEG)
        bpos2 = max((i for c, i in cand if c == best2), default=-1)
        js2 = sum(1 for i in mis2 if i < bpos2)
        keep2 = m2 == 0 or (first2 >= L and (js2 == m2 - 1
                                             or (ln - qs) - 4 * m2 >= best2))
        qe = max(ln if keep2 else bpos2, qs)
        nmm = sum(1 for i in mis if qs <= i < qe)
        out[0, b], out[1, b] = qs, qe
        out[2, b], out[3, b] = 8 * (qe - qs - nmm) - 24 * nmm, nmm
        if q8 is not None:
            qv = [int(q8[b, min(max(ln - 1 - i, 0), L - 1) if rc else
                             min(max(i, 0), L - 1)]) for i in range(qs, qe)]
            out[4, b] = sum(x for x, i in zip(qv, range(qs, qe))
                            if i in set(mis))
            out[5, b] = (16 * sum(qv)) // max(qe - qs, 1)

    for b in range(B):
        (segment_row if seg else wide_row)(b)
    keys = ("trim_qstart", "trim_qend", "trim_score", "trim_nmm",
            "mm_qualsum", "qual_mean16")
    return dict(zip(keys, torch.from_numpy(out)))
