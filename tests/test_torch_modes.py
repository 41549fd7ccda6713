"""The port's alignment modes and SNP tolerance against tpumap (JAX on CPU).

The same numpy inputs go through tpumap and the port's plain versions:
the base-space transforms, the mode and SNP tables of the device index,
verify and the per-base mismatch mask in every space with and without
the alternate genome (Ns in reads and genome, both N semantics,
diagonals near the genome end), seeding in a space and from the SNP
index, and the ends rung and the cascade of cmet, atoi, ttoc,
standard + SNP and cmet + SNP. The world is tests/test_modes.py's
(30 kbp, k=12, all four spaces) with tests/test_snps.py's dense SNP
cluster on it. Every quantity is an integer: values and dtypes must be
equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumap.gsnap import driver as jdriver
from tpumap.gsnap import engine as jengine
from tpumap.index.device import DeviceIndex as JaxIndex
from tpumap.ops import mode as jmode
from tpumap.ops import seed as jseed
from tpumap.ops import verify as jverify
from tpumap.utils import dna
from tpumap_torch.gsnap import engine
from tpumap_torch.index.device import DeviceIndex
from tpumap_torch.ops import mode, pack, seed, verify
from torch_workloads import mode_reads, mode_world

torch.set_num_threads(1)
SPACES = [None, "ct", "ga", "ag", "tc"]
INVALID = 0xFFFFFFFF


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def same(want, got):
    """tpumap's uint32 arrays against the port's int64 values or int32
    bit patterns; every other dtype exactly."""
    a = np.asarray(want)
    b = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    if a.dtype == np.uint32:
        assert b.dtype in (np.int64, np.int32), b.dtype
        b = b.astype(np.uint32)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    db, seq, coords, alts = mode_world(tmp_path_factory.mktemp("tmodes"))
    return db, seq, coords, alts, JaxIndex.from_host(db), \
        DeviceIndex.from_host(db, "cpu")


@pytest.fixture(scope="module")
def n_world(world):
    """The world's indexes with N flags planted in the genome (4% of the
    bases), the same arrays given to both packages."""
    db, _seq, _c, _a, ji, _ti = world
    rng = np.random.default_rng(5)
    nm = np.asarray(ji.genome_nmask).copy()
    glen = db.genome_length
    flags = np.zeros(len(nm) * 32, bool)
    flags[:glen] = rng.random(glen) < 0.04
    nm[:(glen + 31) // 32] |= dna.pack_bits(flags)[:(glen + 31) // 32]
    arrays = {f: np.asarray(getattr(ji, f)) for f in (
        "genome_packed", "offsets", "positions", "chrom_offsets",
        "genomealt_packed")}
    arrays.update(genome_nmask=nm, genome_length=glen, k=ji.k,
                  genome_has_n=True, interval=ji.interval)
    alt = {"alt_offsets": {s: np.asarray(v) for s, v in ji.alt_offsets.items()},
           "alt_positions": {s: np.asarray(v)
                             for s, v in ji.alt_positions.items()}}
    jn = JaxIndex(**{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                     for k, v in arrays.items()},
                  alt_offsets={s: jnp.asarray(v)
                               for s, v in alt["alt_offsets"].items()},
                  alt_positions={s: jnp.asarray(v)
                                 for s, v in alt["alt_positions"].items()})
    return jn, DeviceIndex.from_jax_arrays(dict(arrays, **alt), "cpu")


# ------------------------------------------------------ transforms, index

@pytest.mark.parametrize("space", SPACES[1:])
def test_transform_packed_matches(space):
    """int64 values and int32 bit patterns, words with bit 31 set."""
    rng = np.random.default_rng(len(space))
    words = rng.integers(0, 2 ** 32, 512, dtype=np.uint64).astype(np.uint32)
    words[:4] = [0xFFFFFFFF, 0x80000000, 0xC0000000, 0x40000000]
    want = np.asarray(jmode.transform_packed(jnp.asarray(words), space))
    np.testing.assert_array_equal(want,
                                  jmode.transform_packed_np(words, space))
    got64 = mode.transform_packed(t(words.astype(np.int64)), space)
    assert got64.dtype == torch.int64 and int(got64.max()) < 2 ** 32
    same(want, got64)
    got32 = mode.transform_packed(t(words.view(np.int32)), space)
    assert got32.dtype == torch.int32
    same(want, got32)
    codes = rng.integers(0, 4, (3, 40)).astype(np.uint8)
    same(jmode.CODE_MAPS[space][codes], mode.map_codes(t(codes), space))


def test_mode_tables(world):
    """Code maps and mode spaces equal tpumap's; from_host uploads the
    mode and SNP tables with tpumap's pads, from_jax_arrays takes them
    from tpumap's index, and mode_index falls back to the standard pair."""
    db, _seq, _c, _a, ji, ti = world
    assert mode.MODE_SPACES == jmode.MODE_SPACES
    for s, m in jmode.CODE_MAPS.items():
        np.testing.assert_array_equal(mode.CODE_MAPS[s], m)
    assert sorted(ti.alt_offsets) == sorted(ji.alt_offsets) == [
        "ag", "ct", "ga", "snp", "tc"]
    for s in ji.alt_offsets:
        same(ji.alt_offsets[s], ti.alt_offsets[s])
        same(ji.alt_positions[s], ti.alt_positions[s])
    same(ji.genomealt_packed, ti.genomealt_packed)
    assert len(ti.genomealt_packed) == len(ti.genome_packed)
    fj = DeviceIndex.from_jax_arrays(
        {f: np.asarray(getattr(ji, f)) for f in (
            "genome_packed", "genome_nmask", "offsets", "positions",
            "chrom_offsets", "genome_length", "k", "genome_has_n",
            "interval", "genomealt_packed")}
        | {"alt_offsets": {s: np.asarray(v)
                           for s, v in ji.alt_offsets.items()},
           "alt_positions": {s: np.asarray(v)
                             for s, v in ji.alt_positions.items()}},
        "cpu")
    for s in (*SPACES, "snp", "xx"):
        for a, b, c in zip(ji.mode_index(s), ti.mode_index(s),
                           fj.mode_index(s)):
            same(a, b)
            assert torch.equal(b, c)
    assert ti.mode_index("xx")[0] is ti.offsets
    assert ti.nbytes() == sum(
        np.asarray(x).nbytes for x in (
            ji.genome_packed, ji.genome_nmask, ji.offsets, ji.positions,
            ji.genomealt_packed, *ji.alt_offsets.values(),
            *ji.alt_positions.values())) + 8 * len(db.chrom_offsets)
    plain = DeviceIndex.from_host(
        type(db)(**{**db.__dict__, "mode_indexes": None,
                    "genomealt_packed": None}), "cpu")
    assert plain.alt_offsets is None and plain.genomealt_packed is None
    assert plain.mode_index("ct")[1] is plain.positions


# ------------------------------------------------------ verify

def verify_inputs(db, rng, B=96, C=6, W=8):
    """Reads cut from the genome (and from the alt genome), converted in
    part, with substitutions and N flags; diagonals at the true place,
    off it, INVALID, near and past the genome end."""
    glen = db.genome_length
    g = db.get_codes(0, glen)
    galt = dna.unpack_2bit(db.genomealt_packed, glen)
    d = rng.integers(0, glen - 128, B)
    d[:24] = rng.integers(4950, 5150, 24)           # the SNP cluster
    src = np.where((np.arange(B) % 2 == 0)[:, None], galt, g)
    codes = np.stack([src[r][d[r]:d[r] + 16 * W] if d[r] + 16 * W <= glen
                      else np.zeros(16 * W, np.uint8) for r in range(B)])
    # code + 2 is each mode's conversion (A->G, C->T, G->A, T->C)
    codes = np.where(rng.random(codes.shape) < 0.15, (codes + 2) % 4, codes)
    sub = rng.random(codes.shape) < 0.02
    codes[sub] = rng.integers(0, 4, int(sub.sum()))
    nmask = rng.random(codes.shape) < 0.03
    lengths = rng.integers(1, 16 * W + 1, B).astype(np.int32)
    lengths[:40] = 100
    for r in range(B):
        codes[r, lengths[r]:] = 0
        nmask[r, lengths[r]:] = False
    diags = np.stack([d + rng.integers(-2, 3, B) * (c > 0)
                      for c in range(C)], 1).astype(np.int64)
    diags[rng.random(diags.shape) < 0.15] = INVALID
    diags[:6, 1] = [glen - 50, glen - 3, glen + 5, glen + 900, 0, 1]
    packed = pack.pack_reads(t(codes))
    nm2 = pack.pack_reads(t(nmask.astype(np.uint8)))
    return packed, nm2, t(lengths), t(diags)


@pytest.mark.parametrize("qunk,gunk", [(False, True), (True, False)])
@pytest.mark.parametrize("snp", [False, True])
@pytest.mark.parametrize("space", SPACES)
def test_verify_and_mask_match(world, n_world, space, snp, qunk, gunk):
    db = world[0]
    jn, tn = n_world
    rng = np.random.default_rng(SPACES.index(space) * 4 + 2 * snp + qunk)
    packed, nm2, li, dg = verify_inputs(db, rng)
    jp, jm = (jnp.asarray(x.numpy().view(np.uint32)) for x in (packed, nm2))
    jl, jd = jnp.asarray(li.numpy()), jnp.asarray(dg.numpy().astype(np.uint32))
    want = jverify.verify_diagonals(jn, jp, jm, jl, jd, space=space, snp=snp,
                                    query_unk=qunk, genome_unk=gunk)
    got = verify.verify_diagonals_plain(tn, packed, nm2, li, dg, qunk, gunk,
                                        space=space, snp=snp)
    same(want, got)
    same(want, verify.verify_diagonals(tn, packed, nm2, li, dg, qunk, gunk,
                                       space=space, snp=snp))
    for c in (0, 1):
        same(jverify.mismatch_mask_single(
            jn, jp, jm, jl, jd[:, c], 128, space=space, snp=snp,
            query_unk=qunk, genome_unk=gunk),
            verify.mismatch_mask_single(tn, packed, nm2, li, dg[:, c], 128,
                                        qunk, gunk, space=space, snp=snp))
    # the alternate genome is reached, and the space changes the counts
    if snp:
        plain = verify.verify_diagonals_plain(tn, packed, nm2, li, dg, qunk,
                                              gunk, space=space)
        assert bool((got <= plain).all()) and bool((got < plain).any())
    if space is not None:
        std = verify.verify_diagonals_plain(tn, packed, nm2, li, dg, qunk,
                                            gunk, snp=snp)
        assert not torch.equal(got, std)


# ------------------------------------------------------ seeding

@pytest.mark.parametrize("index_space", [None, "snp"])
@pytest.mark.parametrize("space", SPACES)
def test_seed_reads_matches(world, space, index_space):
    db, seq, coords, alts, ji, ti = world
    recs = (mode_reads(seq, "cmet-stranded", 24, 1)
            + mode_reads(seq, None, 24, 2, snps=(coords, alts)))
    batch = jdriver.make_batch(recs, 48, 128)
    jb = [jnp.asarray(batch[k]) for k in ("codes", "nmask", "lengths")]
    want = jseed.seed_reads(ji, *jb, max_occ=8, top_k=4, space=space,
                            index_space=index_space)
    got = seed.seed_reads(ti, t(batch["codes"]), t(batch["nmask"]),
                          t(batch["lengths"]), max_occ=8, top_k=4,
                          space=space, index_space=index_space)
    for a, b in zip(want, got):
        same(a, b)
    assert (np.asarray(want[0]) != INVALID).any()


# ------------------------------------------------------ the cascade

CONFIGS = {
    "cmet": dict(mode="cmet-stranded"),
    "atoi": dict(mode="atoi-stranded"),
    "ttoc": dict(mode="ttoc-stranded"),
    "snp": dict(snp_tolerant=True),
    "cmet_snp": dict(mode="cmet-stranded", snp_tolerant=True),
}


def cascade_batch(world, name):
    _db, seq, coords, alts, _ji, _ti = world
    mode_name = CONFIGS[name].get("mode")
    recs = (mode_reads(seq, mode_name, 40, 11)
            + mode_reads(seq, mode_name, 16, 12, snps=(coords, alts),
                         name="s"))
    return jdriver.make_batch(recs, 64, 128)


@pytest.fixture
def contiguous_k1_args(monkeypatch):
    """K1's wrapper takes only contiguous tensors on the card: hold every
    tensor the cascade hands verify_diagonals to that here too."""
    plain = verify.verify_diagonals

    def checked(*args, **kw):
        for a in args:
            assert not isinstance(a, torch.Tensor) or a.is_contiguous()
        return plain(*args, **kw)
    monkeypatch.setattr(verify, "verify_diagonals", checked)


@pytest.mark.parametrize("rung", ["ends", "cascaded"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_cascade_dicts_match(world, name, rung, contiguous_k1_args):
    """align_batch_ends and align_batch_cascaded (both rungs and the
    trim stage) give tpumap's dict."""
    _db, _seq, _c, _a, ji, ti = world
    batch = cascade_batch(world, name)
    keys = ("codes", "nmask", "lengths")
    jb = {k: jnp.asarray(batch[k]) for k in keys}
    tb = {k: t(batch[k]) for k in keys}
    cfg = dict(CONFIGS[name], top_k=4, max_occ=8)
    jfn, tfn = ((jengine.align_batch_ends, engine.align_batch_ends)
                if rung == "ends" else
                (jengine.align_batch_cascaded, engine.align_batch_cascaded))
    want = jfn(ji, jb, jengine.AlignConfig(**cfg))
    got = tfn(ti, tb, engine.AlignConfig(**cfg))
    assert sorted(got) == sorted(want)
    for key in want:
        same(want[key], got[key])
    # cmet + SNP seeds ct/ga-mapped oligos from the standard-space SNP
    # index (tpumap's semantics), so few converted reads seed at all
    mapped = np.asarray(want["mapped"])[:56].mean()
    assert mapped < 0.5 if name == "cmet_snp" else mapped > 0.8, mapped


def test_cmet_snp_seeds_from_the_snp_index(world):
    """With SNP tolerance the mode rung seeds both strands' space-mapped
    oligos from the SNP index (tpumap engine.py:191-192): emptied SNP
    tables leave no candidate, emptied ct/ga tables change nothing."""
    _db, _seq, _c, _a, _ji, ti = world
    batch = cascade_batch(world, "cmet_snp")
    tb = {k: t(batch[k]) for k in ("codes", "nmask", "lengths")}
    cfg = engine.AlignConfig(mode="cmet-stranded", snp_tolerant=True,
                             top_k=4, max_occ=8)

    def emptied(*spaces):
        off = dict(ti.alt_offsets)
        for s in spaces:
            off[s] = torch.zeros_like(off[s])
        return DeviceIndex(**{**ti.__dict__, "alt_offsets": off})

    base = engine.align_batch_ends(ti, tb, cfg)
    no_snp = engine.align_batch_ends(emptied("snp"), tb, cfg)
    no_mode = engine.align_batch_ends(emptied("ct", "ga"), tb, cfg)
    assert bool((base["cand_diags"] != INVALID).any())
    assert bool((no_snp["cand_diags"] == INVALID).all())
    for key in base:
        assert torch.equal(base[key], no_mode[key]), key
