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
