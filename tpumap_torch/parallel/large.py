"""Genome-sharded alignment: the gmapl/gsnapl (large-genome) axis (port
of tpumap/parallel/large.py).

The reference compiles separate gmapl/gsnapl binaries with 8-byte
univcoords for genomes > 2^32 bp (src/Makefile.am:366, src/types.h:38-58).
As in tpumap, the device keeps uint32 coordinates: the genome is cut into
coordinate windows along the `index` axis, each small enough that local
coordinates fit 32 bits, with its own k-mer index and no alternate
genome. Every window seeds and verifies (K1) the data shard's reads; the
windows' lanes are gathered shard-major on the data row's first device
and reduced to the global best in tpumap's order (key nmm * 2^16 + lane,
duplicates by (diag, shard, strand)), and the host rebases (shard, local
diag) to uint64 univcoords.

Windows overlap by `overlap` bases (>= the longest read) so an alignment
crossing a window edge is whole in at least one window.
"""
from __future__ import annotations

import numpy as np
import torch

from tpumap_torch.gsnap.engine import AlignConfig, _rc_rows, _strand_cols
from tpumap_torch.index.build import GenomeDB, build_kmer_index
from tpumap_torch.index.device import DeviceIndex
from tpumap_torch.ops import pack, seed, verify
from tpumap_torch.ops.u32 import INVALID
from tpumap_torch.parallel.mesh import INDEX_AXIS, DeviceMesh
from tpumap_torch.parallel.pipeline import _device_scope
from tpumap_torch.parallel.sharded import (_batch, _place_shards,
                                           _run_data_shards)
from tpumap_torch.utils import dna


def shard_genome_host(db: GenomeDB, n_shards: int,
                      overlap: int = 1024) -> dict:
    """Split the genome into n_shards overlapping coordinate windows and
    build a per-window k-mer index with window-local uint32 positions.

    Returns host arrays with a leading shard dimension plus `bases`
    (uint64[n_shards]) for host-side coordinate rebasing.
    """
    L = db.genome_length
    span = (L + n_shards - 1) // n_shards
    span = (span + 15) & ~15                 # word-align window starts
    windows = []
    for s in range(n_shards):
        lo = min(s * span, L)
        hi = min(lo + span + overlap, L)
        windows.append((lo, hi))

    genomes, nmasks, offs, poss = [], [], [], []
    gmax = pmax = 0
    for lo, hi in windows:
        codes = db.get_codes(lo, hi - lo)
        nm = db.get_nmask(lo, hi - lo).astype(bool)
        o, p = build_kmer_index(codes, nm, db.k, db.interval)
        gp = dna.pack_2bit(codes)
        nmp = _pack_bits(nm)
        genomes.append(gp)
        nmasks.append(nmp)
        offs.append(o)
        poss.append(p)
        gmax = max(gmax, len(gp))
        pmax = max(pmax, len(p))
    gmax += 64
    nmax = gmax // 2 + 64
    pmax += 64
    genome_packed = np.zeros((n_shards, gmax), dtype=np.uint32)
    genome_nmask = np.full((n_shards, nmax), 0xFFFFFFFF, dtype=np.uint32)
    positions = np.full((n_shards, pmax), 0xFFFFFFFF, dtype=np.uint32)
    for s in range(n_shards):
        genome_packed[s, :len(genomes[s])] = genomes[s]
        genome_nmask[s, :len(nmasks[s])] = nmasks[s]
        genome_nmask[s, len(nmasks[s]):] = 0xFFFFFFFF
        positions[s, :len(poss[s])] = poss[s]
    return {
        "genome_packed": genome_packed,
        "genome_nmask": genome_nmask,
        "offsets": np.stack(offs),
        "positions": positions,
        "bases": np.asarray([w[0] for w in windows], dtype=np.uint64),
        "lengths": np.asarray([w[1] - w[0] for w in windows],
                              dtype=np.int64),
    }


def _pack_bits(mask: np.ndarray) -> np.ndarray:
    n = (len(mask) + 31) // 32
    out = np.zeros(n * 32, dtype=np.uint32)
    out[:len(mask)] = mask.astype(np.uint32)
    out = out.reshape(n, 32)
    shifts = np.arange(32, dtype=np.uint32)
    return (out << shifts).sum(axis=1, dtype=np.uint32)


def _window_index(arrays, j: int, device, k: int) -> DeviceIndex:
    """Window j's index on one device: its genome, N bitmap and k-mer
    tables, no alternate genome (K1 then reads no alt window)."""
    return DeviceIndex(
        genome_packed=arrays["genome_packed"][j][device],
        genome_nmask=arrays["genome_nmask"][j][device],
        offsets=arrays["offsets"][j][device],
        positions=arrays["positions"][j][device],
        chrom_offsets=torch.zeros(1, dtype=torch.int64, device=device),
        genome_length=0, k=k, genome_has_n=True, genomealt_packed=None)


def _window_lanes(wi, config: AlignConfig, codes, nmask, lengths):
    """One window's candidates for both strands: (diags int64[B, 2K],
    nmm int32[B, 2K], strands int32[B, 2K])."""
    rc_codes, rc_nmask = _rc_rows(codes, nmask, lengths)

    def one_strand(c, m):
        oligos, valid = seed.query_oligos(c, m, lengths, wi.k)
        NQ = oligos.shape[1]
        qpos = torch.arange(NQ, dtype=torch.int64, device=c.device)
        diags = seed.lookup_diagonals(wi.offsets, wi.positions, oligos,
                                      valid, qpos, config.max_occ)
        B = c.shape[0]
        diags, _ = seed.prevalent_diagonals(diags.reshape(B, -1),
                                            config.top_k)
        nmm = verify.verify_diagonals(wi, pack.pack_reads(c),
                                      pack.pack_reads(m.to(torch.uint8)),
                                      lengths, diags)
        return diags, nmm

    fdiags, fnmm = one_strand(codes, nmask)
    rdiags, rnmm = one_strand(rc_codes, rc_nmask)
    B, K = fdiags.shape
    return (torch.cat([fdiags, rdiags], 1), torch.cat([fnmm, rnmm], 1),
            _strand_cols(B, K, codes.device))


def _global_best(lanes: list, lengths, config: AlignConfig) -> dict:
    """The reduction over the windows' gathered lanes, shard-major per
    read (tpumap's all_gather then transpose(1, 0, 2))."""
    g_diags = torch.cat([d for d, _n, _s in lanes], 1)
    g_nmm = torch.cat([n for _d, n, _s in lanes], 1)
    g_str = torch.cat([s for _d, _n, s in lanes], 1)
    g_sh = torch.cat([torch.full_like(s, j) for j, (_d, _n, s)
                      in enumerate(lanes)], 1)
    B, KT = g_diags.shape
    key = (g_nmm.to(torch.int64) * 2 ** 16
           + torch.arange(KT, dtype=torch.int64, device=g_nmm.device))
    order = torch.argsort(key, dim=1)
    nmm_s, diag_s, str_s, sh_s = (torch.gather(a, 1, order)
                                  for a in (g_nmm, g_diags, g_str, g_sh))
    best_nmm, best_diag = nmm_s[:, 0], diag_s[:, 0]
    best_str, best_sh = str_s[:, 0], sh_s[:, 0]
    # the same alignment seen from two overlapping windows is resolved
    # on the host; within one window a lane equal in (diag, shard,
    # strand) to the best is a duplicate
    dup = ((diag_s == best_diag[:, None]) & (sh_s == best_sh[:, None])
           & (str_s == best_str[:, None]))
    second_nmm = torch.where(dup, 2 ** 15, nmm_s).min(dim=1).values
    max_nmm = (lengths.to(torch.float32)
               * config.max_mismatch_frac).to(torch.int32)
    mapped = (best_diag != INVALID) & (best_nmm <= max_nmm)
    return {"diag": best_diag, "shard": best_sh, "strand": best_str,
            "nmismatch": best_nmm, "second_nmismatch": second_nmm,
            "mapped": mapped}


def make_genome_sharded_aligner(mesh: DeviceMesh, db: GenomeDB,
                                config: AlignConfig, overlap: int = 1024,
                                parts: dict | None = None):
    """(device_arrays, fn(device_arrays, batch) -> per-read results,
    bases). Results carry `shard` and `diag` (window-local); use
    rebase_results for uint64 univcoords. db may be a uint64-position
    (large=True) build: each window's index is built anew in 32 bits.
    parts: shard_genome_host(db, index shards, overlap) where the caller
    has it already (a second grid over the same windows)."""
    n_shards = mesh.shape[INDEX_AXIS]
    if parts is None:
        parts = shard_genome_host(db, n_shards, overlap)
    elif len(parts["bases"]) != n_shards:
        raise ValueError(f"{len(parts['bases'])} windows for {n_shards} "
                         f"index shards")
    k = db.k
    arrays = _place_shards(mesh, parts, ("genome_packed", "genome_nmask",
                                         "offsets", "positions"))

    def align(arrays, batch):
        def body(_i, row_devs, b):
            lanes = []
            for j, d in enumerate(row_devs):
                wi = _window_index(arrays, j, d, k)
                with _device_scope(d):
                    got = _window_lanes(wi, config,
                                        *(b[key].to(d) for key in
                                          ("codes", "nmask", "lengths")))
                lanes.append(tuple(t.to(row_devs[0]) for t in got))
            return _global_best(lanes, b["lengths"], config)
        return _run_data_shards(mesh, _batch(batch), body)

    return arrays, align, parts["bases"]


def rebase_results(results: dict, bases: np.ndarray) -> np.ndarray:
    """(shard, local diag) -> uint64 global univcoords (host side)."""
    shard = np.asarray(torch.as_tensor(results["shard"]).cpu())
    diag = np.asarray(torch.as_tensor(results["diag"]).cpu()).astype(
        np.uint64)
    return bases[shard] + diag
