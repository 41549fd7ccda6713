"""CUDA kernels of tpumap_torch against their plain PyTorch versions.

These tests need an NVIDIA GPU and nvcc; without them they skip. They
need neither JAX nor tpumap (the workloads are built with the port's own
host modules), so on the GPU machine run them without tests/conftest.py
(which sets JAX up for the CPU):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Every quantity is an integer, so kernel and plain version must agree
exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

from tpumap_torch import kernels
from tpumap_torch.gsnap.driver import align_records
from tpumap_torch.gsnap import engine
from tpumap_torch.gsnap.engine import AlignConfig
from tpumap_torch.gsnap.knownsplicing import KnownSplicing, known_to_device
from tpumap_torch.gsnap.paired import align_paired_records, rescue_mate
from tpumap_torch.index.device import DeviceIndex
from tpumap_torch.ops import chain, dp, localscan, pack, pathdp, verify
from tpumap_torch.utils import dna
from torch_workloads import (ends_reads, ends_world, gmap_repeat_query,
                             gmap_segments, gmap_straddle, gmap_windows,
                             gmap_world, mixed_workload, mode_pairs,
                             mode_reads, mode_world, query_oligos, sam_text,
                             stream_pairs, tie_rows, trim_rows)

DNA_KERNELS = ("verify_diagonals", "banded_align", "traceback")
# the kernels of the GSNAP paths (GMAP's K7a and K7b never launch there)
GSNAP_KERNELS = DNA_KERNELS + ("chain_dp", "scan_fragment",
                               "scan_exact_sites", "scan_fragment_runs")

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    kernels.build()
    return torch.device("cuda")


def random_index(rng, glen, device, n_frac=0.0):
    """A random padded genome with an N bitmap (no k-mer tables)."""
    words = (glen + 15) // 16
    genome = rng.integers(0, 2 ** 32, words + 4352, dtype=np.uint64)
    nbits = np.zeros(glen + 32 * 4352, dtype=bool)
    if n_frac:
        nbits[:glen] = rng.random(glen) < n_frac
    nmask = dna.pack_bits(nbits)
    return DeviceIndex.from_jax_arrays({
        "genome_packed": genome.astype(np.uint32),
        "genome_nmask": nmask,
        "offsets": np.zeros(2, np.uint32),
        "positions": np.zeros(1, np.uint32),
        "chrom_offsets": np.array([0, glen], np.uint32),
        "genome_length": glen, "k": 12, "genome_has_n": n_frac > 0,
        "interval": 3}, device)


def to(device, *arrays):
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.parametrize("B,W,C,n_frac,qunk,gunk", [
    (1000, 8, 3, 0.0, False, True),
    (777, 8, 4, 0.01, False, True),
    (513, 7, 8, 0.01, True, False),
    (64, 3, 5, 0.05, True, True),
])
def test_verify_kernel_matches_plain(dev, B, W, C, n_frac, qunk, gunk):
    rng = np.random.default_rng(B)
    glen = 200_000
    idx = random_index(rng, glen, dev, n_frac)
    reads = rng.integers(0, 2 ** 32, (B, W), dtype=np.uint64)
    nm = np.where(rng.random((B, W)) < 0.05,
                  rng.integers(0, 2 ** 32, (B, W), dtype=np.uint64), 0)
    nm = nm & 0x55555555
    lengths = rng.integers(0, 16 * W + 1, B).astype(np.int32)
    diags = rng.integers(0, glen + 64, (B, C)).astype(np.int64)
    diags[rng.random((B, C)) < 0.2] = 0xFFFFFFFF
    r, n, li, d = to(dev, reads.astype(np.uint32).view(np.int32),
                     nm.astype(np.uint32).view(np.int32), lengths, diags)
    got = verify.verify_diagonals(idx, r, n, li, d, qunk, gunk)
    want = verify.verify_diagonals_plain(idx, r, n, li, d, qunk, gunk)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("R,Lq,band,mode", [
    (300, 128, 32, "glocal"), (50, 40, 8, "glocal"), (64, 60, 16, "global"),
    (300, 128, 32, "global"), (41, 37, 1, "glocal"), (41, 37, 1, "global"),
    (70, 130, 63, "glocal"), (70, 130, 63, "global"), (33, 99, 40, "global"),
    (64, 512, 32, "glocal"), (12, 4000, 32, "glocal"), (1, 128, 32, "glocal"),
    (257, 128, 32, "global"),
])
def test_banded_and_traceback_match_plain(dev, R, Lq, band, mode):
    """K2 (one warp a problem, 1 to 4 band cells a lane: bands 1, 8-16,
    32-40 and 63) and K3 against their plain versions, glocal and
    global, with qlen < Lq in most rows and Lq not a multiple of 4; K3
    also at Lq = 512 and 4,000 (a table past one row tile, and past
    shared memory) with an indel every 64 bases in a third of the rows
    (more than 12 runs), at R = 1 and 257, and with qlens 0 and Lq and
    end_k 0 and W - 1 in four rows."""
    rng = np.random.default_rng(R + Lq + band)
    Lg = Lq + band + 4
    g = rng.integers(0, 4, (R, Lg)).astype(np.uint8)
    q = g[:, 4:4 + Lq].copy()
    mut = rng.random((R, Lq)) < 0.05
    q[mut] = rng.integers(0, 4, int(mut.sum()))
    for r in range(0, R, 3):            # plant indels
        ps = (range(32, Lq - 32, 64) if Lq >= 512
              else [int(rng.integers(10, Lq - 10))])
        for m, p in enumerate(ps):
            if (r + m) % 2:
                q[r, p:] = np.concatenate([q[r, p + 3:], q[r, :3]])
            else:
                n = 2 if Lq < 512 else 3
                q[r, p + n:] = q[r, p:Lq - n]
    qlens = rng.integers(Lq // 2, Lq + 1, R).astype(np.int32)
    if mode == "global":
        glens = (qlens + rng.integers(-band // 2, band // 2 + 1, R)).astype(
            np.int32)
    else:
        glens = np.minimum(Lg, rng.integers(Lq, Lg + 8, R)).astype(np.int32)
    qt, qlt, gt, glt = to(dev, q, qlens, g, glens)
    got = dp.banded_align(qt, qlt, gt, glt, band, mode=mode)
    want = dp.banded_align_plain(qt, qlt, gt, glt, band, mode=mode)
    for key in ("score", "end_k", "dirs", "H_last"):
        assert torch.equal(got[key], want[key]), key
    end_k = got["end_k"].clone()
    if R >= 4:
        qlt = qlt.clone()
        qlt[:2] = torch.tensor([0, Lq])
        end_k[2:4] = torch.tensor([0, 2 * band])
    tb = dp.traceback(got["dirs"], qlt, end_k, band)
    tbp = dp.traceback_plain(want["dirs"], qlt, end_k, band)
    torch.cuda.synchronize()
    for a, b in zip(tb, tbp):
        assert torch.equal(a, b)
    if Lq >= 512:
        assert bool((tbp[4] > dp.MAXRUNS).any())


def test_launch_counters_count_launches(dev):
    kernels.reset_launches()
    idx = random_index(np.random.default_rng(0), 10_000, dev)
    one = torch.ones((2, 1), dtype=torch.int32, device=dev)
    verify.verify_diagonals(idx, one, one * 0, one[:, 0] * 16,
                            torch.zeros((2, 1), dtype=torch.int64,
                                        device=dev))
    assert kernels.LAUNCHES["verify_diagonals"] == 1


@pytest.mark.parametrize("sink", [False, True])
def test_slice_on_gpu_matches_cpu(dev, tmp_path, sink):
    """The stream workload (indels, clips, unmapped, N, quals) through the
    kernels gives the plain CPU run's SAM, and every kernel launched."""
    db, reads, _gfa = mixed_workload(tmp_path, port=True)
    cfg = AlignConfig(top_k=4, max_occ=8)
    want = sam_text(align_records(db, DeviceIndex.from_host(db, "cpu"),
                                  reads, cfg, batch_size=32))
    gpu_index = DeviceIndex.from_host(db, dev)
    kernels.reset_launches()
    if sink:
        chunks = []
        align_records(db, gpu_index, reads, cfg, batch_size=32,
                      sink=chunks.append)
        got = b"".join(bytes(c) for c in chunks)
    else:
        got = sam_text(align_records(db, gpu_index, reads, cfg,
                                     batch_size=32))
    assert got == want
    assert min(kernels.LAUNCHES[k] for k in DNA_KERNELS) > 0, \
        kernels.LAUNCHES


# ACGT repeated, as one packed genome word (int32 bit pattern)
ACGT_WORD = int(np.uint32(0xE4E4E4E4).view(np.int32))
# candidate offsets from the read's diagonal, taken in order for K
# lanes (None: a random diagonal): insertion jumps up to 8, deletions,
# the 9-base intron floor, introns and one past max_intron
CHAIN_OFFSETS = [0, 3, -2, -5, 7, 500, 20_000, None, -8, 1, -1, 9, 8, 30,
                 200_001, None]


@pytest.mark.parametrize("R,L,K,quals,known,max_insert,ties", [
    (300, 128, 8, False, False, 6, False),
    (97, 100, 8, True, False, 6, False),
    (64, 37, 8, False, True, 6, False),
    (2048, 128, 8, False, False, 6, False),
    (1, 128, 1, False, False, 6, False),
    (31, 128, 3, False, True, 0, False),
    (8193, 128, 8, False, False, 8, False),
    (31, 64, 9, True, True, 8, False),
    (8193, 128, 14, False, True, 6, False),
    (8193, 128, 16, False, False, 0, False),
    (31, 100, 16, False, True, 8, True),
    (33, 37, 14, False, True, 8, False),
    (33, 62, 16, True, False, 0, True),
    (257, 128, 8, False, False, 6, True),
    (8193, 128, 14, False, True, 6, True),
])
def test_chain_kernel_matches_plain(dev, R, L, K, quals, known, max_insert,
                                    ties):
    """K5 on reads cut from the genome against candidate sets with
    deletions, insertion jumps, introns and INVALID lanes, rows with no
    valid candidate, rows of length 0 and L; with ties, a genome of ACGT
    repeated and reads that switch phase, so the lanes of one phase
    score alike and the row maximum recurs at several q
    (torch_workloads.tie_rows)."""
    rng = np.random.default_rng(R + L + K)
    glen = 300_000
    idx = random_index(rng, glen, dev, 0.0 if ties else 0.001)
    sc = pathdp.PathScoring(max_insert=max_insert)
    d = rng.integers(1000, glen - 25_000, R).astype(np.int64)
    if ties:
        idx = dataclasses.replace(idx, genome_packed=torch.full_like(
            idx.genome_packed, ACGT_WORD))
        codes, lengths, cands = tie_rows(rng, d // 4 * 4, K, L)
    else:
        codes = verify.extract_codes_window(
            idx.genome_packed, torch.from_numpy(d).to(dev), L).cpu().numpy()
        lengths = rng.integers(L // 2, L + 1, R).astype(np.int32)
        for r in range(R):              # splice two genome pieces together
            q = int(rng.integers(10, L - 10))
            jump = int(rng.choice([-2, -5, -8, 3, 7, 500, 20_000]))
            codes[r, q:] = verify.extract_codes_window(
                idx.genome_packed,
                torch.tensor([d[r] + jump + q], device=dev),
                L - q)[0].cpu().numpy()
            mut = rng.random(L) < 0.03
            codes[r, mut] = rng.integers(0, 4, int(mut.sum()))
        cands = np.stack([d + o if o is not None else rng.integers(0, glen, R)
                          for o in CHAIN_OFFSETS[:K]], 1)
        cands[rng.random(cands.shape) < 0.2] = 0xFFFFFFFF
        cands[2:5] = 0xFFFFFFFF         # no valid candidate
    lengths[-1] = L
    lengths[0] = 0 if R > 1 else L
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 0
    nmask = rng.random((R, L)) < (0.0 if ties else 0.01)
    q = (rng.integers(0, 41, (R, L)).astype(np.uint8) if quals else None)
    ct, nt, lt, cdt = to(dev, codes, nmask, lengths, cands)
    inp = pathdp.chain_inputs(idx, ct, nt, lt, cdt, sc,
                              None if q is None else to(dev, q)[0])
    if known:
        inp["known"] = torch.from_numpy(
            rng.integers(0, 16, inp["s"].shape).astype(np.uint8)).to(dev)
    got = pathdp.chain_dp(inp, lt, sc)
    want = pathdp.chain_dp_plain(inp, lt, sc)
    torch.cuda.synchronize()
    assert sorted(got) == sorted(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    if R > 31 and K >= 8:
        assert (want["nsegs"] >= 2).any()


def chain_rows(dev, idx, rng, R, L, K):
    """chain_inputs for R reads cut from idx's genome, each with a 7-bp
    deletion in the middle third of the query, against K >= 5 candidates of
    CHAIN_OFFSETS; the lengths run from L down to 0."""
    glen = idx.genome_length
    d = rng.integers(1000, glen - L - 25_000, R).astype(np.int64)
    codes = verify.extract_codes_window(
        idx.genome_packed, torch.from_numpy(d).to(dev), L).cpu().numpy()
    for r in range(R):
        q = int(rng.integers(L // 3, 2 * L // 3))
        codes[r, q:] = verify.extract_codes_window(
            idx.genome_packed, torch.tensor([d[r] + 7 + q], device=dev),
            L - q)[0].cpu().numpy()
    cands = np.stack([d + o if o is not None else rng.integers(0, glen, R)
                      for o in CHAIN_OFFSETS[:K]], 1)
    lengths = np.linspace(L, 0, R).astype(np.int32)
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 0
    ct, lt, cdt = to(dev, codes, lengths, cands)
    nt = torch.zeros(ct.shape, dtype=torch.bool, device=dev)
    return pathdp.chain_inputs(idx, ct, nt, lt, cdt, pathdp.PathScoring()), lt


@pytest.mark.parametrize("K,L", [(8, 28_984), (8, 28_985), (16, 7_194),
                                 (16, 7_195), (14, 7_195), (14, 7_680)])
def test_chain_kernel_longest_rows(dev, K, L):
    """K5 at the longest rows whose choice table fits a block's shared
    memory (chain_max_len(K) steps), and past them, where the table moves
    to a global scratch (7,680: the bucket of a 7,169-base read), against
    the plain version."""
    assert L - pathdp.chain_max_len(K) in (0, 1) or L == 7_680
    rng = np.random.default_rng(L)
    idx = random_index(rng, L + 60_000, dev)
    inp, lt = chain_rows(dev, idx, rng, 3, L, K)
    got = pathdp.chain_dp(inp, lt)
    want = pathdp.chain_dp_plain(inp, lt)
    torch.cuda.synchronize()
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert int(want["nsegs"][0]) >= 2


@pytest.mark.parametrize("L", [128, 61])
def test_chain_kernel_unaligned_inputs(dev, L):
    """K5 on inputs that start one element past an aligned address (the
    loads of one step at a time) against the plain version."""
    rng = np.random.default_rng(L)
    idx = random_index(rng, 300_000, dev)
    inp, lt = chain_rows(dev, idx, rng, 65, L, 8)
    for k in ("s", "don", "acc", "mm"):
        flat = torch.empty(inp[k].numel() + 1, dtype=inp[k].dtype,
                           device=dev)
        flat[1:] = inp[k].flatten()
        inp[k] = flat[1:].view(inp[k].shape)
    assert inp["s"].data_ptr() % 16 and inp["mm"].data_ptr() % 4
    got = pathdp.chain_dp(inp, lt)
    want = pathdp.chain_dp_plain(inp, lt)
    torch.cuda.synchronize()
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert (want["nsegs"] >= 2).any()


@pytest.mark.parametrize("scan,window,top_k,case", [
    ("fragment", 65536, 4, ""), ("exact", 65536, 8, ""),
    ("runs_suffix", 65536, 8, ""), ("runs_prefix", 65536, 8, ""),
    ("fragment", 2048, 4, ""), ("exact", 100, 8, ""),
    ("runs_suffix", 200, 3, ""), ("fragment", 1024, 4, ""),
    ("fragment", 2000, 4, ""), ("runs_prefix", 200, 3, ""),
    ("runs_prefix", 1000, 8, ""), ("runs_suffix", 7, 2, ""),
    ("runs_suffix", 4100, 8, ""), ("exact", 1000, 5, ""),
    ("runs_prefix", 131072, 8, ""), ("fragment", 65536, 1, ""),
    ("fragment", 65536, 3, ""), ("fragment", 65536, 5, ""),
    ("fragment", 65536, 8, ""), ("fragment", 65536, 4, "no_lengths"),
    ("fragment", 65536, 4, "poly_a"), ("fragment", 65536, 8, "poly_a"),
    ("fragment", 16, 4, ""), ("fragment", 17, 3, ""),
    ("exact", 65536, 8, "path"), ("exact", 65536, 1, "path"),
    ("exact", 65536, 8, "poly_a"), ("exact", 65536, 1, "poly_a"),
    ("exact", 65536, 8, "no_lengths"), ("exact", 1031, 8, "path"),
    ("exact", 131072, 8, ""), ("exact", 16, 3, ""), ("exact", 17, 8, ""),
    ("exact", 1000, 8, "no_bases"),
])
def test_scan_kernels_match_plain(dev, scan, window, top_k, case):
    """K6a-c against their plain versions, with window starts past the
    genome end (clamped as tpumap's dynamic slice clamps them),
    zero-length fragments, windows of whole and partial words, and
    fragments cut from the window (the runs scans find run 16 there);
    K6a also at top_k 1-8, on a batch whose fragment lengths are all 0,
    and with all-A fragments over a 6,400-base poly-A stretch (thousands
    of offsets score 0); K6b also with the review's fragment lengths,
    3-10 ("path"), at top_k 1 and 8, over the poly-A stretch (thousands
    of hits a row), on a batch whose lengths are all 0, with fragments of
    no bases (F = 0: every offset hits) and at windows of 16, 17, 1,031
    and 2^17 bases."""
    rng = np.random.default_rng(window + top_k)
    glen = 200_000
    idx = random_index(rng, glen, dev)
    idx.genome_packed[1000:1400] = 0
    R = 300
    F = 10 if scan == "exact" else 16
    ws = rng.integers(0, glen, R).astype(np.int64)
    ws[:4] = [glen - 50, glen + 40_000, 2 ** 32 - 40, 0]
    frag_at = np.minimum(ws + rng.integers(0, window, R), glen - F)
    frag = verify.extract_codes_window(
        idx.genome_packed, torch.from_numpy(frag_at).to(dev), F).cpu().numpy()
    frag[1::3, 2] ^= 1
    flen = rng.integers(0, F + 1, R).astype(np.int32)
    flen[4:10] = 0
    flen[10:40] = F
    if case == "no_lengths":
        flen[:] = 0
    elif case == "path":
        flen[:] = rng.integers(3, F + 1, R)
    elif case == "poly_a":
        ws[40:80] = 16_000 - rng.integers(0, 400, 40)
        frag[40:80] = 0
        flen[40:80] = F
    elif case == "no_bases":
        F, frag = 0, np.ascontiguousarray(frag[:, :0])
    g = idx.genome_packed
    wt, ft, lt = to(dev, ws, frag, flen)
    if scan == "fragment":
        args = (g, wt, ft, lt, window, F, top_k)
        got, want = (localscan.scan_fragment(*args),
                     localscan.scan_fragment_plain(*args))
        if case == "poly_a":
            assert bool((want[1][40:80] == 0).all())
    elif scan == "exact":
        args = (g, wt, ft, lt, window, F, top_k)
        got, want = (localscan.scan_exact_sites(*args),
                     localscan.scan_exact_sites_plain(*args))
        if case == "poly_a":
            assert bool((want[1][40:80] > 1000).all())
        if case == "no_bases":
            assert bool((want[1] == torch.where(lt > 0, window, 0)).all())
    else:
        args = (g, wt, ft, window, top_k, scan == "runs_suffix")
        got, want = (localscan.scan_fragment_runs(*args),
                     localscan.scan_fragment_runs_plain(*args))
        assert bool((want[1][:, 0] == 16).any())
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_rna_on_gpu_matches_cpu(dev, tmp_path):
    """The stream workload with novel splicing through every kernel
    gives the plain CPU run's SAM."""
    db, reads, _gfa = mixed_workload(tmp_path, port=True)
    cfg = AlignConfig(top_k=4, max_occ=8)
    want = sam_text(align_records(db, DeviceIndex.from_host(db, "cpu"),
                                  reads, cfg, novelsplicing=True,
                                  batch_size=32))
    gpu_index = DeviceIndex.from_host(db, dev)
    kernels.reset_launches()
    chunks = []
    align_records(db, gpu_index, reads, cfg, novelsplicing=True,
                  batch_size=32, sink=chunks.append)
    assert b"".join(bytes(c) for c in chunks) == want
    assert min(kernels.LAUNCHES[k] for k in GSNAP_KERNELS) > 0, \
        kernels.LAUNCHES


@pytest.mark.parametrize("R,window", [(512, 1000), (64, 2000)])
def test_verify_kernel_rescue_shape(dev, R, window):
    """K1 at the mate rescue's shape: every diagonal of a pairmax-wide
    window (uint32 wrap), windows past the genome end and across 2^32;
    and rescue_mate on the card against the CPU."""
    rng = np.random.default_rng(R + window)
    glen = 300_000
    idx = random_index(rng, glen, dev, 0.001)
    bases = rng.integers(0, glen, R).astype(np.int64)
    bases[:4] = [glen - 100, glen + 10, 2 ** 32 - 300, 0]
    at = np.minimum(bases + rng.integers(0, window, R), glen - 128)
    codes = verify.extract_codes_window(
        idx.genome_packed, torch.from_numpy(at).to(dev), 128).cpu().numpy()
    lengths = rng.integers(1, 129, R).astype(np.int32)
    lengths[4:8] = [100, 16, 17, 128]
    codes[np.arange(128)[None, :] >= lengths[:, None]] = 0
    ct, lt, bt = to(dev, codes, lengths, bases)
    pk = pack.pack_reads(ct)
    diags = (bt[:, None] + torch.arange(window, device=dev)[None, :]) \
        & 0xFFFFFFFF
    args = (idx, pk, torch.zeros_like(pk), lt, diags)
    got = verify.verify_diagonals(*args)
    want = verify.verify_diagonals_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    g = rescue_mate(idx, ct, lt, window, bt)
    cpu = dataclasses.replace(idx, **{
        f.name: getattr(idx, f.name).cpu() for f in dataclasses.fields(idx)
        if isinstance(getattr(idx, f.name), torch.Tensor)})
    c = rescue_mate(cpu, ct.cpu(), lt.cpu(), window, bt.cpu())
    for a, b in zip(g, c):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("K", [8, 14])
def test_chain_kernel_known_masks(dev, K):
    """K5 with known-site masks from a KnownSplicing (sense and
    antisense sites on every row's junction), 8 lanes and the 14 of the
    ladder with partner diagonals."""
    rng = np.random.default_rng(K)
    glen = 300_000
    idx = random_index(rng, glen, dev)
    R, L = 1024, 128
    d = rng.integers(1000, glen - 30_000, R).astype(np.int64)
    q = rng.integers(10, 90, R)
    intron = rng.choice([200, 1000, 20_000], R)
    codes = verify.extract_codes_window(
        idx.genome_packed, torch.from_numpy(d).to(dev), L).cpu().numpy()
    moved = verify.extract_codes_window(
        idx.genome_packed, torch.from_numpy(d + intron).to(dev),
        L).cpu().numpy()
    codes = np.where(np.arange(L)[None, :] >= q[:, None], moved, codes)
    lengths = np.full(R, 100, np.int32)
    codes[:, 100:] = 0
    sense = rng.random(R) < 0.7
    ks = KnownSplicing.from_junctions(d + q, d + q + intron,
                                      np.where(sense, 1, -1))
    cands = np.stack([d, d + intron] + [rng.integers(0, glen, R)
                                        for _ in range(K - 2)], 1)
    cands[:, 2:][rng.random((R, K - 2)) < 0.3] = 0xFFFFFFFF
    ct, lt, cdt = to(dev, codes, lengths, cands)
    nt = torch.zeros(ct.shape, dtype=torch.bool, device=dev)
    inp = pathdp.chain_inputs(idx, ct, nt, lt, cdt, pathdp.PathScoring(),
                              known=known_to_device(ks, dev))
    assert bool((inp["known"] != 0).flatten(1).any(dim=1).all())
    got = pathdp.chain_dp(inp, lt)
    want = pathdp.chain_dp_plain(inp, lt)
    torch.cuda.synchronize()
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert (want["nsegs"] >= 2).float().mean() > 0.5


def test_paired_and_known_on_gpu_match_cpu(dev, tmp_path):
    """The stream workload's pairs with novel splicing, and its reads
    with known splicing, through the kernels give the plain CPU runs'
    SAM."""
    db, reads, _gfa = mixed_workload(tmp_path, port=True)
    cfg = AlignConfig(top_k=4, max_occ=8)
    cpu, gpu = DeviceIndex.from_host(db, "cpu"), DeviceIndex.from_host(db, dev)
    pairs = stream_pairs(db, port=True)
    kw = dict(batch_size=16, pairmax=1000, novelsplicing=True)

    def pair_sam(index):
        return b"".join((a.lines() + b.lines()).encode()
                        for a, b in align_paired_records(db, index, pairs,
                                                         cfg, **kw))
    kernels.reset_launches()
    assert pair_sam(gpu) == pair_sam(cpu)
    assert min(kernels.LAUNCHES[k] for k in GSNAP_KERNELS) > 0, \
        kernels.LAUNCHES
    ks = KnownSplicing.from_junctions([30100], [31000], [1])
    want = sam_text(align_records(db, cpu, reads, cfg, known=ks,
                                  batch_size=32))
    assert sam_text(align_records(db, gpu, reads, cfg, known=ks,
                                  batch_size=32)) == want


@pytest.mark.parametrize("alt", [False, True])
@pytest.mark.parametrize("space", [None, "ct", "ga", "ag", "tc"])
def test_verify_kernel_spaces_match_plain(dev, space, alt):
    """K1 in each base space, with and without the alternate genome (a
    base counts only where it mismatches both), with Ns in reads and
    genome, both N semantics, and diagonals near and past the genome end.
    Reads are cut from the genome or the alternate genome, with the
    mode conversions and substitutions planted."""
    rng = np.random.default_rng(7 + 2 * len(space or "") + alt)
    glen, B, W, C = 200_000, 900, 8, 6
    idx = random_index(rng, glen, dev, 0.01)
    g = idx.genome_packed.cpu().numpy().view(np.uint32)
    sparse = (rng.integers(0, 2 ** 32, (3, len(g)), dtype=np.uint64)
              .astype(np.uint32))
    galt = g ^ (sparse[0] & sparse[1] & sparse[2])
    if alt:
        idx = dataclasses.replace(idx, genomealt_packed=torch.from_numpy(
            galt.view(np.int32)).to(dev))
    d = rng.integers(0, glen, B).astype(np.int64)
    src = idx.genomealt_packed if alt else idx.genome_packed
    codes = verify.extract_codes_window(src, torch.from_numpy(d).to(dev),
                                        16 * W).cpu().numpy()
    codes = np.where(rng.random(codes.shape) < 0.15, (codes + 2) % 4, codes)
    sub = rng.random(codes.shape) < 0.02
    codes[sub] = rng.integers(0, 4, int(sub.sum()))
    nmask = rng.random(codes.shape) < 0.03
    lengths = rng.integers(1, 16 * W + 1, B).astype(np.int32)
    lengths[:300] = 100
    diags = np.stack([d + rng.integers(-2, 3, B) * (c > 0)
                      for c in range(C)], 1)
    diags[rng.random(diags.shape) < 0.15] = 0xFFFFFFFF
    diags[:4, 1] = [glen - 50, glen + 5, glen + 900, 0]
    ct, nt, lt, dt = to(dev, codes, nmask.astype(np.uint8), lengths, diags)
    pk, nm2 = pack.pack_reads(ct), pack.pack_reads(nt)
    for qunk, gunk in ((False, True), (True, False)):
        args = (idx, pk, nm2, lt, dt, qunk, gunk)
        got = verify.verify_diagonals(*args, space=space, snp=alt)
        want = verify.verify_diagonals_plain(*args, space=space, snp=alt)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (qunk, gunk)
        if alt:
            ref = verify.verify_diagonals_plain(*args, space=space)
            assert bool((want <= ref).all()) and bool((want < ref).any())


@pytest.mark.parametrize("run", ["cmet", "atoi", "snp", "cmet_snp",
                                 "cmet_novel", "cmet_pairs", "snp_pairs"])
def test_modes_on_gpu_match_cpu(dev, tmp_path, run):
    """The alignment modes and SNP tolerance on the small worlds of
    tests/test_torch_modes.py (all four spaces, a dense SNP cluster)
    through the kernels give the plain CPU run's SAM, and K1 launched."""
    db, seq, coords, alts = mode_world(tmp_path, port=True)
    mode = {"cmet": "cmet-stranded", "atoi": "atoi-stranded"}.get(
        run.split("_")[0])
    snp = "snp" in run
    cfg = AlignConfig(mode=mode or "standard", snp_tolerant=snp, top_k=4,
                      max_occ=8)
    cpu, gpu = DeviceIndex.from_host(db, "cpu"), DeviceIndex.from_host(db, dev)
    if run.endswith("pairs"):
        items = mode_pairs(seq, mode, 24, 41, port=True)

        def sam(index):
            return b"".join((a.lines() + b.lines()).encode()
                            for a, b in align_paired_records(
                                db, index, items, cfg, batch_size=16,
                                pairmax=1000))
    else:
        items = (mode_reads(seq, mode, 40, 11, port=True)
                 + mode_reads(seq, mode, 16, 12, snps=(coords, alts),
                              name="s", port=True))

        def sam(index):
            return sam_text(align_records(
                db, index, items, cfg, batch_size=32,
                novelsplicing=run == "cmet_novel"))
    want = sam(cpu)
    kernels.reset_launches()
    assert sam(gpu) == want
    assert kernels.LAUNCHES["verify_diagonals"] > 0, kernels.LAUNCHES


# ------------------------------------------------------- staged path

def test_refine_splices_on_gpu_matches_cpu(dev):
    """refine_splices (torch ops) on CUDA tensors against the CPU, with
    and without known sites: the same boundaries, bonuses and senses."""
    glen, R, P, L = 200_000, 256, 8, 100
    # the same random index on each device (the same draws)
    idx_c = random_index(np.random.default_rng(17), glen, "cpu", 0.01)
    idx_g = random_index(np.random.default_rng(17), glen, dev, 0.01)
    rng = np.random.default_rng(18)
    codes = rng.integers(0, 4, (R, L)).astype(np.uint8)
    nmask = rng.random((R, L)) < 0.01
    lengths = rng.integers(60, L + 1, R).astype(np.int32)
    dA = rng.integers(0, glen - 200, (R, P)).astype(np.int64)
    dB = dA + rng.integers(30, 5000, (R, P))
    dA[rng.random((R, P)) < 0.2] = 0xFFFFFFFF
    ks = KnownSplicing.from_junctions(dA[:, 0] + 50, dB[:, 0] + 50,
                                      np.ones(R, np.int32))
    for known in (None, ks):
        outs = [engine.refine_splices(
            index, *(torch.from_numpy(a).to(d)
                     for a in (codes, nmask, lengths, dA, dB)),
            known=None if known is None else known_to_device(known, d))
            for index, d in ((idx_c, "cpu"), (idx_g, dev))]
        for k in outs[0]:
            assert torch.equal(outs[1][k].cpu(), outs[0][k]), k


def test_staged_on_gpu_matches_cpu(dev, tmp_path):
    """The stream workload through the staged path (fusions and an empty
    KnownIndels, with novel splicing), single-end and paired, and
    through the transcriptome rung, on the card and on the CPU: the same
    SAM, through the cascade (K1), the indel stage (K2, K3) and the
    chain stage (K5)."""
    import io

    from tpumap_torch.gsnap.knownindels import KnownIndels
    from tpumap_torch.gsnap.transcriptome import build_transcriptome
    from tpumap_torch.io.iit import build_iit, parse_map_fasta

    db, reads, _gfa = mixed_workload(tmp_path, port=True)
    cfg = AlignConfig(top_k=4, max_occ=8)
    cpu, gpu = DeviceIndex.from_host(db, "cpu"), DeviceIndex.from_host(db, dev)
    ki = KnownIndels(np.zeros(0, np.uint64), np.zeros(0, np.int32),
                     np.zeros(0, np.int64))
    kw = dict(batch_size=32, novelsplicing=True, known_indels=ki)
    want = sam_text(align_records(db, cpu, reads, cfg, find_fusions=True,
                                  **kw))
    kernels.reset_launches()
    assert sam_text(align_records(db, gpu, reads, cfg, find_fusions=True,
                                  **kw)) == want
    assert min(kernels.LAUNCHES[k] for k in (
        "verify_diagonals", "banded_align", "traceback", "chain_dp")) > 0, \
        kernels.LAUNCHES
    pairs = stream_pairs(db, port=True)

    def pair_sam(index):
        return b"".join((a.lines() + b.lines()).encode()
                        for a, b in align_paired_records(
                            db, index, pairs, cfg, pairmax=1000, **kw))
    assert pair_sam(gpu) == pair_sam(cpu)
    tr = build_transcriptome(db, build_iit(parse_map_fasta(io.StringIO(
        ">TRA chr1:1001..3100 gene\nGENEA NM_A\n1001 1200\n3001 3100\n"))),
        name="tr", k=10, interval=1)
    outs = [sam_text(align_records(db, index, reads, cfg, batch_size=32,
                                   tr=(tr, DeviceIndex.from_host(tr.trdb, d))))
            for index, d in ((cpu, "cpu"), (gpu, dev))]
    assert outs[1] == outs[0]


# ------------------------------------------------------------ GMAP (K7)

@pytest.mark.parametrize("N,S,case", [
    (64, 64, "random"), (64, 64, "ties"), (300, 1, "random"),
    (16, 64, "invalid"), (8, 512, "random"), (8, 512, "ties"),
    (32, 128, "full"), (1, 1, "random"), (5, 31, "ties"), (5, 33, "ties"),
    (1, 128, "ties"), (2, 1024, "random"), (2, 1024, "ties"),
    (2, 1025, "random"), (2, 2048, "random"), (2, 2048, "ties"),
    (64, 64, "far"), (8, 512, "far"), (2, 2048, "far")])
def test_chain_segments_kernel_matches_plain(dev, N, S, case):
    """K7a against chain_compact_plain on the same CUDA tensors, at the
    pipeline's compaction (CHAIN_M) and with every member (m = S): the
    members, their order and the padding exactly. Past 1,024 segments
    the wide kernel; "far" at max_intron = 10^8 with genomic gaps past
    2^26 (gap costs past the table, computed in the kernel)."""
    rng = np.random.default_rng(S + N)
    far = 100_000_000 if case == "far" else 0
    max_intron = far or 500_000
    segs = gmap_segments(rng, N, S,
                         n_valid={"invalid": 0, "full": S}.get(case),
                         tie_q=case == "ties", tie_w=case == "ties", far=far)
    segs = {k: torch.from_numpy(v).to(dev) for k, v in segs.items()}
    for m in (128, S):
        kernels.reset_launches()
        got = chain.chain_compact(segs, m, max_intron)
        assert kernels.LAUNCHES["chain_segments"] == 1
        want = chain.chain_compact_plain(segs, m, max_intron)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
        if case == "invalid":
            assert not got[3].any()


def test_gap_costs_match_the_host(dev):
    """K7a's device gap cost (the table fill, the same function that
    costs gaps past the table) against the host's float64 log1p rounded
    to float32, at every integer gap below 10^8 (past 2^26)."""
    top = 100_000_000
    tab = torch.empty(top, dtype=torch.float32, device=dev)
    one = torch.ones((1, 1), dtype=torch.int32, device=dev)
    out = [torch.empty((1, 1), dtype=torch.int32, device=dev)
           for _ in range(3)]
    kernels.launch("chain_segments", dev, one, one, one, one,
                   one.to(torch.bool), 1, 1, 1, top, 0.5, tab, top, 1, tab,
                   0, *out, torch.empty((1, 1), dtype=torch.bool,
                                        device=dev))
    got = tab.cpu()
    bad = 0
    for lo in range(0, top, 10_000_000):
        want = chain.gap_cost(torch.arange(lo, lo + 10_000_000))
        bad += int((got[lo:lo + 10_000_000] != want).sum())
    assert bad == 0


def test_anchor_lanes_limit_on_the_card(dev):
    """Past ANCHOR_MAX_LANES the card raises as the CPU does."""
    N, Q = 2, 4096
    max_occ = chain.ANCHOR_MAX_LANES // (N * Q) + 1
    with pytest.raises(ValueError, match="lanes"):
        chain.region_anchors(
            torch.zeros((N, 64), dtype=torch.uint8, device=dev),
            torch.ones((N, 64), dtype=torch.bool, device=dev),
            torch.zeros((N, Q), dtype=torch.int64, device=dev),
            torch.ones((N, Q), dtype=torch.bool, device=dev), 8, max_occ)


@pytest.mark.parametrize("N,R,Q,k,max_occ,keep,case", [
    (32, 32768, 512, 8, 8, False, "random"),
    (32, 32768, 512, 8, 8, True, "random"),
    (4, 8192, 256, 8, 128, True, "poly_a"),
    (4, 8192, 256, 8, 8, False, "poly_a"),
    (4, 4096, 256, 12, 8, False, "random"),
    (2, 524288, 1024, 8, 8, False, "random"),
    (3, 256, 256, 8, 128, True, "random"),
    (1, 131072, 8192, 8, 8, False, "random"),
    (1, 8192, 256, 8, 8, False, "straddle"),
    (1, 8192, 256, 8, 8, True, "straddle"),
    (2, 32768, 512, 8, 128, True, "poly_a"),
    (2, 32768, 512, 8, 128, False, "poly_a"),
    (3, 300, 64, 8, 8, False, "random"),
    (3, 5, 64, 8, 8, True, "random"),
    (3, 4096, 512, 8, 8, False, "repeat"),
    (3, 4096, 512, 8, 8, True, "repeat"),
    (2, 8192, 512, 12, 8, True, "random"),
    (3, 4096, 256, 8, 5, True, "random"),
    (0, 4096, 256, 8, 8, False, "random"),
    (1, 4_400_000, 256, 8, 255, False, "straddle"),
    (1, 4_400_000, 256, 8, 256, True, "straddle"),
    (32, 32768, 512, 8, 255, False, "random"),
    (4, 8192, 256, 8, 1000, True, "poly_a"),
    (2, 32768, 512, 8, 1000, True, "poly_a"),
    (2, 32768, 512, 8, 1000, False, "poly_a"),
    (3, 4096, 512, 8, 256, True, "repeat"),
    (2, 8192, 512, 12, 1000, True, "random")])
def test_region_anchors_kernel_matches_plain(dev, N, R, Q, k, max_occ, keep,
                                             case):
    """K7b against region_anchors_plain (tpumap's stable index and
    direct table) on the same CUDA tensors: every anchor lane exactly,
    so positions of one oligo come out in increasing order; a poly-A
    window puts all R positions in one bucket over several chunks; an
    oligo's max_occ-th and (max_occ + 1)-th hits straddle a chunk
    boundary; the query repeats one oligo at many positions; windows
    shorter than a chunk and than k; max_occ not a multiple of 4 (lanes
    filled one a thread); no problem at all (no launch); max_occ past
    254 (32-bit counts)."""
    rng = np.random.default_rng(R + k)
    if case == "straddle":
        C = chain.anchor_chunks(N, R, kernels.n_sms(dev))[0]
        arrays = gmap_straddle(rng, R, Q, C, max_occ)
    elif case == "repeat":
        arrays = gmap_repeat_query(rng, N, R, Q, k)
    elif R < k:
        arrays = (rng.integers(0, 4, (N, R)).astype(np.uint8),
                  np.ones((N, R), bool)) + query_oligos(
            rng.integers(0, 4, (N, Q)).astype(np.uint8),
            np.ones((N, Q), bool), k)
    else:
        arrays = gmap_windows(rng, N, R, Q, k, poly_a=case == "poly_a")
    rc, rv, qo, qv = (torch.from_numpy(a).to(dev) for a in arrays)
    kernels.reset_launches()
    got = chain.region_anchors(rc, rv, qo, qv, k, max_occ, keep)
    if N == 0:                      # the plain version takes no N = 0
        assert kernels.LAUNCHES["region_anchors"] == 0
        assert all(g.shape == (0, Q, max_occ) for g in got)
        return
    assert kernels.LAUNCHES["region_anchors"] == 1
    want = chain.region_anchors_plain(rc, rv, qo, qv, k, max_occ, keep)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    # random windows and straddling hits always give anchors; a poly-A
    # window's or a repeated oligo's only hits are overabundant, kept
    # with keep_overabundant; a window shorter than k holds no oligo
    assert bool(got[2].any()) == (R >= k and (
        keep or case in ("random", "straddle")))


def test_gmap_on_gpu_matches_cpu(dev, tmp_path):
    """align_queries_bulk and main -f 3 / samse through K7a and K7b give
    the plain CPU run's chains and bytes."""
    import io
    from contextlib import redirect_stdout
    from dataclasses import asdict

    from tpumap_torch.cli import gmap_cli

    db, recs, qfa = gmap_world(tmp_path, port=True)
    enc = [dna.encode(r.sequence) for r in recs]
    want = gmap_cli.align_queries_bulk(db, DeviceIndex.from_host(db, "cpu"),
                                       enc)
    kernels.reset_launches()
    got = gmap_cli.align_queries_bulk(db, DeviceIndex.from_host(db, dev), enc)
    assert kernels.LAUNCHES["chain_segments"] > 0
    assert kernels.LAUNCHES["region_anchors"] > 0
    assert [None if h is None else (asdict(h[0]), h[1]) for h in got] == \
        [None if h is None else (asdict(h[0]), h[1]) for h in want]
    assert sum(h is not None for h in got) >= len(recs) - 1
    db.save(str(tmp_path / "db"))
    for fmt in ("3", "samse"):
        outs = []
        for device in ("cpu", "cuda"):
            buf = io.StringIO()
            with redirect_stdout(buf):
                gmap_cli.main(["-D", str(tmp_path / "db"), "-f", fmt,
                               str(qfa), "--device", device])
            outs.append(buf.getvalue().replace(f"--device {device}", ""))
        assert outs[0] == outs[1] and outs[0].count("\n") > len(recs)


@pytest.mark.parametrize("S", [64, 512, 1025])
@pytest.mark.parametrize("N", [1, 9])
def test_chain_segments_kernel_every_member(dev, N, S):
    """K7a as align_cdna_pairs calls it for one query's regions (the
    per-query and chimera paths, -g): every member returned (m = S),
    one problem or a few, against chain_compact_plain."""
    rng = np.random.default_rng(7 * S + N)
    segs = {k: torch.from_numpy(v).to(dev)
            for k, v in gmap_segments(rng, N, S).items()}
    kernels.reset_launches()
    got = chain.chain_compact(segs, S)
    assert kernels.LAUNCHES["chain_segments"] == 1
    want = chain.chain_compact_plain(segs, S)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == (N, S) and torch.equal(g, w)
    assert bool(got[3].any())


@pytest.mark.parametrize("R", [256, 4096, 32768, 262144])
@pytest.mark.parametrize("max_occ,keep", [(8, False), (128, True)])
def test_region_anchors_kernel_one_region(dev, R, max_occ, keep):
    """K7b at N = 1 with the region's codes uploaded from the host (as
    align_cdna_pairs sends a query's head region), at k = 8, max_occ 8
    and the repetitive retry's 128 keeping overabundant oligos."""
    rng = np.random.default_rng(R + max_occ)
    rc, rv, qo, qv = (torch.from_numpy(a).to(dev)
                      for a in gmap_windows(rng, 1, R, 512, 8))
    kernels.reset_launches()
    got = chain.region_anchors(rc, rv, qo, qv, 8, max_occ, keep)
    assert kernels.LAUNCHES["region_anchors"] == 1
    want = chain.region_anchors_plain(rc, rv, qo, qv, 8, max_occ, keep)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert bool(got[2].any())


def gmap_main_text(argv, device):
    import io
    from contextlib import redirect_stdout

    from tpumap_torch.cli import gmap_cli
    buf = io.StringIO()
    with redirect_stdout(buf):
        gmap_cli.main(argv + ["--device", device])
    return buf.getvalue().replace(f"--device {device}", "")


@pytest.mark.parametrize("extra", [[], ["-A"], ["-x", "30", "-f", "1"],
                                   ["-S", "-x", "30"]])
def test_gmap_main_paths_on_gpu_match_cpu(dev, tmp_path, extra):
    """main's default path (-n 5), -A and the chimera path (-x 30) on
    gmap_world and a two-chromosome chimera world: the card's bytes are
    the plain CPU run's, through K7a and K7b."""
    db, recs, qfa = gmap_world(tmp_path, port=True)
    db.save(str(tmp_path / "db"))
    rng = np.random.default_rng(17)
    g = db.get_seq(0, db.genome_length)
    chim = [g[3000:3100] + g[5000:5100] + g[90_000:90_120],
            g[6000:6150] + dna.revcomp(g[80_000:80_130])]
    with open(qfa, "a") as f:
        f.write("".join(f">x{i}\n{s}\n" for i, s in enumerate(chim)))
    argv = ["-D", str(tmp_path / "db"), *extra, str(qfa)]
    want = gmap_main_text(argv, "cpu")
    kernels.reset_launches()
    assert gmap_main_text(argv, "cuda") == want
    assert kernels.LAUNCHES["chain_segments"] > 0
    assert kernels.LAUNCHES["region_anchors"] > 0
    assert want.count("\n") > len(recs)


def test_gmap_main_genomic_segment_on_gpu(dev, tmp_path):
    """-g without --device cpu runs align_cdna_both on the card (K7a
    and K7b launch), with the CPU's bytes."""
    import io
    from contextlib import redirect_stdout

    from tpumap_torch.cli import gmap_cli
    db, recs, qfa = gmap_world(tmp_path, port=True)
    (tmp_path / "g.fa").write_text(">g\n" + db.get_seq(0, 70_000) + "\n")
    argv = ["-S", "-g", str(tmp_path / "g.fa"), str(qfa)]
    want = gmap_main_text(argv, "cpu")
    kernels.reset_launches()
    buf = io.StringIO()
    with redirect_stdout(buf):
        gmap_cli.main(argv)
    assert buf.getvalue() == want and "Path 1" in want
    assert kernels.LAUNCHES["chain_segments"] > 0
    assert kernels.LAUNCHES["region_anchors"] > 0


def gsnap_main_text(argv, device):
    import io
    from contextlib import redirect_stderr, redirect_stdout

    from tpumap_torch.cli import gsnap_cli
    buf, err = io.StringIO(), io.StringIO()
    with redirect_stdout(buf), redirect_stderr(err):
        assert gsnap_cli.main(argv + ["--device", device]) == 0
    # align_records_isolated retries a failed group read by read and
    # reports a failed read as unmapped; neither may happen here
    assert "retrying reads individually" not in err.getvalue()
    assert "reported as unmapped" not in err.getvalue()
    return buf.getvalue().replace(f" --device {device}", "")


@pytest.mark.parametrize("case", ["default", "rna_known", "paired_split"])
def test_gsnap_main_on_gpu_matches_cpu(dev, tmp_path, case):
    """The gsnap CLI on gsnap_cli_world (inputs from the port's own
    tools): the bare command (the record path, K1-K3), -N 1 -s with the
    splice-site map (K1, K5 and whatever scans the world's reads need)
    and paired end with --split-output; the card's stdout and files are
    the plain CPU run's."""
    from torch_workloads import gsnap_cli_world
    w = gsnap_cli_world(tmp_path, port=True)
    extra = {"default": [w["R"]],
             "rna_known": ["-N", "1", "-s", w["SS"], w["R"]],
             "paired_split": ["--split-output", "{OUT}/s", w["R1"],
                              w["R2"]]}[case]
    texts = []
    for device in ("cpu", "cuda"):
        out = tmp_path / device
        out.mkdir()
        argv = ["-D", w["D"]] + [a.replace("{OUT}", str(out)) for a in extra]
        kernels.reset_launches()
        # the echoed command line names the run's directory and device
        texts.append((gsnap_main_text(argv, device).replace(str(out), ""),
                      {p.name: p.read_bytes().replace(str(out).encode(), b"")
                       .replace(f" --device {device}".encode(), b"")
                       for p in out.iterdir()}))
    assert texts[1] == texts[0]
    launched = {"default": DNA_KERNELS,
                "rna_known": ("verify_diagonals", "chain_dp"),
                "paired_split": ("verify_diagonals",)}[case]
    assert all(kernels.LAUNCHES[k] > 0 for k in launched), kernels.LAUNCHES
    assert texts[0][0].count("\n") + sum(
        v.count(b"\n") for v in texts[0][1].values()) > 40


# ------------------------------------------------ several devices

def grid(dev, n):
    """n devices: the card's distinct ones where it has n, else dev n
    times."""
    if torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [dev] * n


def test_mesh_context_on_gpu_matches_cpu(dev, tmp_path):
    """align_records (DNA, RNA), align_paired_records and
    align_queries_bulk through a MeshContext of data axis 2 on the card
    give the plain single-device CPU run's output; every stage split."""
    from dataclasses import asdict

    from tpumap_torch.cli import gmap_cli
    from tpumap_torch.parallel import mesh, pipeline
    db, reads, _gfa = mixed_workload(tmp_path, port=True)
    cfg = AlignConfig(top_k=4, max_occ=8)
    cpu_index = DeviceIndex.from_host(db, "cpu")
    ctx = pipeline.MeshContext(mesh.make_mesh(devices=grid(dev, 2)), db)
    for novel in (False, True):
        want = sam_text(align_records(db, cpu_index, reads, cfg,
                                      batch_size=32, novelsplicing=novel))
        kernels.reset_launches()
        got = sam_text(align_records(db, ctx.index, reads, cfg,
                                     batch_size=32, novelsplicing=novel,
                                     device_ctx=ctx))
        assert got == want
        assert min(kernels.LAUNCHES[k] for k in DNA_KERNELS) > 0
    pairs = stream_pairs(db, port=True)
    want = [(a.lines(), b.lines()) for a, b in align_paired_records(
        db, cpu_index, pairs, cfg, batch_size=16, pairmax=1000)]
    got = [(a.lines(), b.lines()) for a, b in align_paired_records(
        db, ctx.index, pairs, cfg, batch_size=16, pairmax=1000,
        device_ctx=ctx)]
    assert got == want
    assert ctx.rows.split > 0
    (tmp_path / "gmap").mkdir()
    gdb, recs, _qfa = gmap_world(tmp_path / "gmap", port=True)
    enc = [dna.encode(r.sequence) for r in recs]
    gctx = pipeline.MeshContext(mesh.make_mesh(devices=grid(dev, 2)), gdb)
    want = gmap_cli.align_queries_bulk(gdb, DeviceIndex.from_host(gdb, "cpu"),
                                       enc)
    kernels.reset_launches()
    got = gmap_cli.align_queries_bulk(gdb, gctx.index, enc, device_ctx=gctx)
    assert kernels.LAUNCHES["chain_segments"] > 0
    assert [None if h is None else (asdict(h[0]), h[1]) for h in got] == \
        [None if h is None else (asdict(h[0]), h[1]) for h in want]


@pytest.mark.parametrize("shape,full", [((1, 4), False), ((2, 2), False),
                                        ((2, 2), True)])
def test_sharded_on_gpu_matches_cpu(dev, tmp_path, shape, full):
    """The index-sharded aligners on a grid of the card against the same
    grid of `cpu` devices: every result array equal, K1 launched."""
    from tpumap_torch.ops import pathdp
    from tpumap_torch.parallel import mesh, sharded
    from tpumap_torch.gsnap.driver import make_batch
    db, reads, _gfa = mixed_workload(tmp_path, port=True)
    cfg = AlignConfig(top_k=4, max_occ=8)
    make = (sharded.make_sharded_full_aligner if full
            else sharded.make_sharded_aligner)
    kw = dict(scoring=pathdp.PathScoring(max_intron=5000), salvage=True,
              paired=True, pairmax=1000) if full else {}
    b = make_batch(reads[:64], 64, 128)
    batch = {k: b[k] for k in ("codes", "nmask", "lengths")}
    out = []
    for devices in ([torch.device("cpu")] * 4, grid(dev, 4)):
        arrays, align = make(mesh.make_mesh(4, index_shards=shape[1],
                                            devices=devices), db, cfg, **kw)
        kernels.reset_launches()
        out.append({k: v.cpu() for k, v in align(arrays, batch).items()})
    assert kernels.LAUNCHES["verify_diagonals"] > 0
    assert sorted(out[0]) == sorted(out[1])
    for k in out[0]:
        assert torch.equal(out[0][k], out[1][k]), k


def test_genome_windows_on_gpu_match_cpu(dev, tmp_path):
    """The genome-window aligner (a uint64 build) on 1 x 4 of the card
    against the same grid of `cpu` devices, and its rebase."""
    from tpumap_torch.gsnap.driver import make_batch
    from tpumap_torch.index.build import build_db
    from tpumap_torch.parallel import large, mesh
    db, reads, gfa = mixed_workload(tmp_path, port=True)
    dbl = build_db(gfa, name="g64", k=db.k, interval=db.interval, large=True)
    cfg = AlignConfig(top_k=4, max_occ=8)
    b = make_batch(reads[:64], 64, 128)
    batch = {k: b[k] for k in ("codes", "nmask", "lengths")}
    parts = large.shard_genome_host(dbl, 4, 256)
    out = []
    for devices in ([torch.device("cpu")] * 4, grid(dev, 4)):
        arrays, align, bases = large.make_genome_sharded_aligner(
            mesh.make_mesh(4, index_shards=4, devices=devices), dbl, cfg,
            256, parts=parts)
        kernels.reset_launches()
        out.append({k: v.cpu() for k, v in align(arrays, batch).items()})
    assert kernels.LAUNCHES["verify_diagonals"] > 0
    for k in out[0]:
        assert torch.equal(out[0][k], out[1][k]), k
    np.testing.assert_array_equal(large.rebase_results(out[1], bases),
                                  large.rebase_results(out[0], bases))


def distinct_cards(n):
    """n distinct cards; skips where fewer are visible."""
    have = torch.cuda.device_count()
    if have < n:
        pytest.skip(f"needs {n} distinct CUDA devices ({have} visible)")
    return [torch.device("cuda", i) for i in range(n)]


def launched_on_every_card(devices, name="verify_diagonals"):
    return all(kernels.CARD_LAUNCHES.get(d.index, {}).get(name, 0) > 0
               for d in devices)


def test_mesh_context_data_axis_4_on_distinct_cards(dev, tmp_path):
    """align_records (DNA, RNA) and align_paired_records through a
    MeshContext of data axis 4 on four distinct cards give the plain CPU
    run's output, every card launching the DNA kernels."""
    from tpumap_torch.parallel import mesh, pipeline
    cards = distinct_cards(4)
    db, reads, _gfa = mixed_workload(tmp_path, port=True)
    cfg = AlignConfig(top_k=4, max_occ=8)
    cpu_index = DeviceIndex.from_host(db, "cpu")
    ctx = pipeline.MeshContext(mesh.make_mesh(devices=cards), db)
    assert list(ctx.indexes) == cards
    for novel in (False, True):
        want = sam_text(align_records(db, cpu_index, reads, cfg,
                                      batch_size=32, novelsplicing=novel))
        kernels.reset_launches()
        got = sam_text(align_records(db, ctx.index, reads, cfg,
                                     batch_size=32, novelsplicing=novel,
                                     device_ctx=ctx))
        assert got == want
        assert all(launched_on_every_card(cards, k)
                   for k in ("verify_diagonals", "banded_align")), \
            kernels.CARD_LAUNCHES
    pairs = stream_pairs(db, port=True)
    want = [(a.lines(), b.lines()) for a, b in align_paired_records(
        db, cpu_index, pairs, cfg, batch_size=16, pairmax=1000)]
    got = [(a.lines(), b.lines()) for a, b in align_paired_records(
        db, ctx.index, pairs, cfg, batch_size=16, pairmax=1000,
        device_ctx=ctx)]
    assert got == want
    assert ctx.rows.split > 0


def test_sharded_2x2_full_on_distinct_cards(dev, tmp_path):
    """The oligo-sharded full aligner (the whole ladder, with pairs) at
    2 x 2 on four distinct cards against the same grid of `cpu` devices;
    every card seeds and the data rows' first cards verify."""
    from tpumap_torch.gsnap.driver import make_batch
    from tpumap_torch.parallel import mesh, sharded
    cards = distinct_cards(4)
    db, reads, _gfa = mixed_workload(tmp_path, port=True)
    cfg = AlignConfig(top_k=4, max_occ=8)
    kw = dict(scoring=pathdp.PathScoring(max_intron=5000), salvage=True,
              paired=True, pairmax=1000)
    b = make_batch(reads[:64], 64, 128)
    batch = {k: b[k] for k in ("codes", "nmask", "lengths")}
    out = []
    for devices in ([torch.device("cpu")] * 4, cards):
        arrays, align = sharded.make_sharded_full_aligner(
            mesh.make_mesh(4, index_shards=2, devices=devices), db, cfg,
            **kw)
        kernels.reset_launches()
        out.append({k: v.cpu() for k, v in align(arrays, batch).items()})
    assert launched_on_every_card(cards[0::2]), kernels.CARD_LAUNCHES
    assert launched_on_every_card(cards[0::2], "trim_stage")
    assert sorted(out[0]) == sorted(out[1])
    for k in out[0]:
        assert torch.equal(out[0][k], out[1][k]), k


def test_four_genome_windows_on_distinct_cards(dev, tmp_path):
    """Four genome windows of a uint64 build, one a card, against the same
    grid of `cpu` devices, rebased to the same uint64 univcoords; every
    card verifies (K1) its window."""
    from tpumap_torch.gsnap.driver import make_batch
    from tpumap_torch.index.build import build_db
    from tpumap_torch.parallel import large, mesh
    cards = distinct_cards(4)
    db, reads, gfa = mixed_workload(tmp_path, port=True)
    dbl = build_db(gfa, name="g64", k=db.k, interval=db.interval, large=True)
    cfg = AlignConfig(top_k=4, max_occ=8)
    b = make_batch(reads[:64], 64, 128)
    batch = {k: b[k] for k in ("codes", "nmask", "lengths")}
    parts = large.shard_genome_host(dbl, 4, 256)
    out = []
    for devices in ([torch.device("cpu")] * 4, cards):
        arrays, align, bases = large.make_genome_sharded_aligner(
            mesh.make_mesh(4, index_shards=4, devices=devices), dbl, cfg,
            256, parts=parts)
        kernels.reset_launches()
        out.append({k: v.cpu() for k, v in align(arrays, batch).items()})
    assert launched_on_every_card(cards), kernels.CARD_LAUNCHES
    for k in out[0]:
        assert torch.equal(out[0][k], out[1][k]), k
    coords = large.rebase_results(out[1], bases)
    assert coords.dtype == np.uint64
    np.testing.assert_array_equal(coords,
                                  large.rebase_results(out[0], bases))


# ------------------------------------- K8 (the ends rung) and K4 (trim)

ENDS_MODES = {"standard": ("standard", False),
              "cmet": ("cmet-stranded", False),
              "atoi": ("atoi-stranded", False),
              "ttoc": ("ttoc-stranded", False),
              "snp": ("standard", True), "cmet_snp": ("cmet-stranded", True)}


@pytest.fixture(scope="module")
def ends_worlds(dev, tmp_path_factory):
    """{interval: (db, seq, coords, alts, the index on the card)} of
    tests/torch_workloads.ends_world."""
    out = {}
    for iv in (1, 3):
        db, seq, coords, alts = ends_world(
            tmp_path_factory.mktemp(f"ends{iv}"), iv, port=True)
        out[iv] = (db, seq, coords, alts, DeviceIndex.from_host(db, dev))
    return out


def with_n_flags(idx, glen, seed):
    """The index with N flags in 4% of its genome (same device)."""
    from tpumap_torch.utils import dna as tdna
    rng = np.random.default_rng(seed)
    nm = idx.genome_nmask.cpu().numpy().view(np.uint32).copy()
    flags = np.zeros(len(nm) * 32, bool)
    flags[:glen] = rng.random(glen) < 0.04
    nm[:(glen + 31) // 32] |= tdna.pack_bits(flags)[:(glen + 31) // 32]
    return dataclasses.replace(
        idx, genome_has_n=True,
        genome_nmask=torch.from_numpy(nm.view(np.int32)).to(idx.device))


def end_lanes_both(idx, batch, cfg, dev):
    """K8 and its plain version on the same CUDA tensors."""
    from tpumap_torch.ops.pack import pack_reads, revcomp_packed
    codes, lengths = to(dev, batch["codes"], batch["lengths"])
    packed = pack_reads(codes)
    packed2 = torch.cat([packed, revcomp_packed(packed, lengths)], 0)
    got = engine.end_lanes(idx, codes, lengths, cfg, packed2)
    want = engine.end_lanes_plain(idx, codes, lengths, cfg, packed2)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("max_occ", [1, 4, 32, 300, 1000])
@pytest.mark.parametrize("interval", [1, 3])
@pytest.mark.parametrize("name", list(ENDS_MODES))
def test_end_lanes_kernel_matches_plain(dev, ends_worlds, name, interval,
                                        max_occ):
    """K8 in every mode and with SNP tolerance, at intervals 1 and 3, at
    max_occ 1 (fewer lanes than 8), 4 and 32 (lanes in registers), 300
    and 1,000 (the global scratch): reads shorter than k, rows with
    every lane INVALID, repeats with more than 8 distinct lanes."""
    from tpumap_torch.gsnap.driver import make_batch
    db, seq, coords, alts, idx = ends_worlds[interval]
    mode, snp = ENDS_MODES[name]
    recs = ends_reads(seq, 107, interval * 10 + max_occ,
                      None if mode == "standard" else mode,
                      snps=(coords, alts), port=True)
    cfg = AlignConfig(mode=mode, snp_tolerant=snp, top_k=4,
                      max_occ=max_occ)
    kernels.reset_launches()
    got, want = end_lanes_both(idx, make_batch(recs, 56, 107), cfg, dev)
    assert kernels.LAUNCHES["end_lanes"] == 1
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert bool((want == 0xFFFFFFFF).any()) and bool(
        (want != 0xFFFFFFFF).any())


@pytest.mark.parametrize("max_occ", [4, 1000])
def test_end_lanes_kernel_long_reads(dev, ends_worlds, max_occ):
    """K8 on reads of up to 7,680 bases (L = 7,680), standard and cmet."""
    from tpumap_torch.gsnap.driver import make_batch
    from tpumap_torch.io.fasta import Record
    db, seq, coords, alts, idx = ends_worlds[3]
    rng = np.random.default_rng(max_occ)
    recs = [Record(f"l{i}", "", seq[p:p + n]) for i, (p, n) in enumerate(
        zip(rng.integers(0, 40000, 24), rng.integers(5, 7681, 24)))]
    recs.append(Record("rep", "", seq[36000:43680]))
    for mode in ("standard", "cmet-stranded"):
        cfg = AlignConfig(mode=mode, top_k=4, max_occ=max_occ)
        got, want = end_lanes_both(idx, make_batch(recs, 32, 7680), cfg, dev)
        assert torch.equal(got, want), mode


# (interval, max_occ): 2 x interval x max_occ lanes a strand at the
# edges of K8's layouts: 2, 24, 32 (one a thread), 34 and 192, 256 (8 a
# thread), 258 and 6,000 (the scratch path); lane counts are even
@pytest.mark.parametrize("interval,max_occ", [(1, 1), (3, 4), (1, 16),
                                              (1, 17), (3, 32), (1, 128),
                                              (1, 129), (3, 1000)])
@pytest.mark.parametrize("B", [1, 3, 57])
@pytest.mark.parametrize("mode", ["standard", "cmet-stranded"])
def test_end_lanes_kernel_layout_edges(dev, ends_worlds, mode, B, interval,
                                       max_occ):
    """K8 against its plain version at the lane counts where its layout
    changes, with batches that are not whole warps of reads (B = 1, 3,
    57: 4 and 2 reads a warp), reads of 107 bases (rows not 4-byte
    aligned)."""
    from tpumap_torch.gsnap.driver import make_batch
    db, seq, coords, alts, idx = ends_worlds[interval]
    recs = ends_reads(seq, 107, B + max_occ,
                      None if mode == "standard" else mode, port=True)
    recs = (recs[20:] + recs)[:B]       # a repeat read first
    cfg = AlignConfig(mode=mode, top_k=4, max_occ=max_occ)
    kernels.reset_launches()
    got, want = end_lanes_both(idx, make_batch(recs, B, 107), cfg, dev)
    assert kernels.LAUNCHES["end_lanes"] == 1
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("L", [16, 17, 100, 128, 129, 256, 512, 7680])
@pytest.mark.parametrize("B", [1, 3, 41])
def test_trim_kernel_layout_edges(dev, ends_worlds, B, L):
    """K4 against its plain version at the widths where its layout
    changes (a lane a row at L = 16, segments of 2 to 32 lanes, a warp a
    row past 512) and batches that are not whole warps of rows (B = 1,
    3, 41), standard and cmet with quals and the alternate genome."""
    db, _seq, _c, _a, idx = ends_worlds[1]
    rng = np.random.default_rng(L * 7 + B)
    rows = trim_rows(rng, db.get_codes(0, db.genome_length), B, L)
    for mode in ("standard", "cmet-stranded"):
        check_trim_kernel(idx, rows, mode, True, True, False, True, dev)


@pytest.mark.parametrize("genome", ["plain", "n_qunk", "n_gunk"])
@pytest.mark.parametrize("quals", [False, True])
@pytest.mark.parametrize("snp", [False, True])
@pytest.mark.parametrize("mode", ["standard", "cmet-stranded",
                                  "atoi-stranded", "ttoc-stranded"])
def test_trim_kernel_matches_plain(dev, ends_worlds, mode, snp, quals,
                                   genome):
    """K4 in every mode, with and without the alternate genome and
    quals, with N flags under both N semantics: diagonals INVALID, near
    the genome start and past its end; reads of 0-107 bases."""
    db, _seq, _c, _a, idx = ends_worlds[3]
    qunk = genome == "n_qunk"
    if genome != "plain":
        idx = with_n_flags(idx, db.genome_length, 3)
    rng = np.random.default_rng(len(mode) * 8 + 4 * snp + 2 * quals
                                + len(genome))
    rows = trim_rows(rng, db.get_codes(0, db.genome_length), 1000, 107,
                     0.02 if genome != "plain" else 0.0)
    check_trim_kernel(idx, rows, mode, snp, quals, qunk, not qunk, dev)


@pytest.mark.parametrize("L,B", [(128, 32768), (300, 512), (7680, 64),
                                 (69633, 4)])
def test_trim_kernel_long_reads(dev, ends_worlds, L, B):
    """K4 at the main path's B = 32,768, L = 128, at windows of 16 words
    or more (tpumap clamps their start), at L = 7,680, and past the
    genome's padding with a row's words in the global scratch."""
    db, _seq, _c, _a, idx = ends_worlds[1]
    rng = np.random.default_rng(L)
    gcodes = db.get_codes(0, db.genome_length)
    if L > db.genome_length:
        gcodes = np.concatenate([gcodes] * (L // len(gcodes) + 2))
    rows = trim_rows(rng, gcodes, B, L)
    for mode in ("standard", "cmet-stranded"):
        check_trim_kernel(idx, rows, mode, True, True, False, True, dev)


def check_trim_kernel(idx, rows, mode, snp, quals, qunk, gunk, dev):
    codes, nmask, lengths, strand, diag, q = to(dev, *rows)
    cfg = AlignConfig(mode=mode, snp_tolerant=snp, query_unk_mismatch=qunk,
                      genome_unk_mismatch=gunk)
    res = {"strand": strand, "diag": diag}
    kernels.reset_launches()
    got = engine._trim_stage(idx, codes, nmask, lengths, res, cfg,
                             quals=q if quals else None)
    assert kernels.LAUNCHES["trim_stage"] == 1
    want = engine.trim_stage_plain(idx, codes, nmask, lengths, res, cfg,
                                   quals=q if quals else None)
    torch.cuda.synchronize()
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("run", ["dna", "cmet"])
def test_align_records_launch_ends_and_trim(dev, tmp_path, run):
    """A DNA and a cmet align_records on the card launch K8 and K4 (and
    K1) and give the plain CPU run's SAM."""
    if run == "dna":
        db, reads, _gfa = mixed_workload(tmp_path, port=True)
        cfg = AlignConfig(top_k=4, max_occ=8)
    else:
        db, seq, _c, _a = mode_world(tmp_path, port=True)
        reads = mode_reads(seq, "cmet-stranded", 40, 11, port=True)
        cfg = AlignConfig(mode="cmet-stranded", top_k=4, max_occ=32)
    want = sam_text(align_records(db, DeviceIndex.from_host(db, "cpu"),
                                  reads, cfg, batch_size=32))
    gpu = DeviceIndex.from_host(db, dev)
    kernels.reset_launches()
    assert sam_text(align_records(db, gpu, reads, cfg, batch_size=32)) == want
    for k in ("end_lanes", "trim_stage", "verify_diagonals"):
        assert kernels.LAUNCHES[k] > 0, kernels.LAUNCHES
