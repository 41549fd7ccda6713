"""GMAP stage 1: candidate genomic regions (port of tpumap/gmap/stage1.py).

Sample the query's k-mers against the genome k-mer index and cluster the
hit diagonals into candidate regions: the exons of one gene sit on
increasing diagonals separated by their introns, so the prevalent-
diagonal reduction runs with a large merge slop (the longest gene span).
The device half is torch ops on the index's device; `_regions_from_rows`
turns each query's top runs into regions on the host.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpumap_torch.ops import seed
from tpumap_torch.ops.mode import MODE_SPACES, map_codes
from tpumap_torch.utils import dna


@dataclass(frozen=True)
class Stage1Config:
    # query oligo sampling stride, coprime with the index's sampling
    # interval (3) so every genome residue class is probed
    sample_interval: int = 5
    max_occ: int = 16             # overabundant-oligo cap
    top_regions: int = 5
    # cluster slop ~ the longest gene span (gmap --totallength)
    maxtotallen: int = 200_000
    region_pad: int = 2_000
    # repetitive-region fallback: keep the first max_occ hits of
    # overabundant oligos instead of dropping them
    keep_overabundant: bool = False
    # gmap --mode: seed in the reduced base space against the matching
    # mode-transformed index
    mode: str = "standard"


def _region_diags(index, codes, nmask, lengths, config: Stage1Config,
                  space: str | None = None):
    """(diags, counts, lasts) of each row's top_regions slop-merged runs
    (tpumap stage1.py:50-70)."""
    codes = map_codes(codes, space)
    offsets, positions = index.mode_index(space)
    oligos, valid = seed.query_oligos(codes, nmask, lengths, index.k)
    NQ = oligos.shape[1]
    step = config.sample_interval
    qpos = torch.arange(0, NQ, step, dtype=torch.int64, device=codes.device)
    diags = seed.lookup_diagonals(offsets, positions, oligos[:, ::step],
                                  valid[:, ::step], qpos, config.max_occ,
                                  keep_overabundant=config.keep_overabundant)
    return seed.prevalent_diagonals(diags.reshape(diags.shape[0], -1),
                                    config.top_regions,
                                    merge_slop=config.maxtotallen,
                                    return_last=True)


def find_regions_bulk(index, queries: list,
                      config: Stage1Config = Stage1Config()):
    """Candidate regions for many queries in one device pass. queries:
    list of (codes, nmask); returns a list (parallel to queries) of
    region lists as find_regions gives them."""
    Nq = len(queries)
    Q = max(len(c) for c, _ in queries)
    Qp = 256
    while Qp < Q:
        Qp *= 2
    qc = np.zeros((2 * Nq, Qp), np.uint8)
    qn = np.zeros((2 * Nq, Qp), bool)
    lengths = np.zeros(2 * Nq, np.int32)
    for i, (codes, nmask) in enumerate(queries):
        L = len(codes)
        qc[2 * i, :L] = codes
        qn[2 * i, :L] = nmask
        qc[2 * i + 1, :L] = dna.revcomp_codes(codes)
        qn[2 * i + 1, :L] = nmask[::-1]
        lengths[2 * i] = lengths[2 * i + 1] = L
    dev = index.device
    K = config.top_regions
    diags = np.zeros((2 * Nq, K), np.int64)
    counts = np.zeros((2 * Nq, K), np.int32)
    lasts = np.zeros((2 * Nq, K), np.int64)
    spaces = MODE_SPACES[config.mode]
    # fwd rows (2i) and rc rows (2i+1) seed in their own spaces against
    # their own mode tables; in standard mode one pass takes both
    passes = ([(slice(None), None)] if spaces == (None, None) else
              [(slice(0, None, 2), spaces[0]), (slice(1, None, 2),
                                                spaces[1])])
    for rows, sp in passes:
        out = _region_diags(index, torch.from_numpy(qc[rows]).to(dev),
                            torch.from_numpy(qn[rows]).to(dev),
                            torch.from_numpy(lengths[rows]).to(dev),
                            config, sp)
        for dst, t in zip((diags, counts, lasts), out):
            dst[rows] = t.cpu().numpy()
    return [_regions_from_rows(index, diags[2 * i:2 * i + 2],
                               counts[2 * i:2 * i + 2],
                               lasts[2 * i:2 * i + 2], len(codes), config)
            for i, (codes, _n) in enumerate(queries)]


def find_regions(index, query_codes: np.ndarray, query_nmask: np.ndarray,
                 config: Stage1Config = Stage1Config()):
    """Candidate regions for one query (both orientations): a list of
    (gstart, gend, weight, strand) by weight, descending; gstart and
    gend are univcoords clipped to the genome."""
    return find_regions_bulk(index, [(query_codes, query_nmask)],
                             config)[0]


def _regions_from_rows(index, diags, counts, lasts, Q,
                       config: Stage1Config):
    """tpumap stage1.py:139-184, as it is."""
    chrom_offsets = index.chrom_offsets.cpu().numpy().astype(np.int64)
    regions = []
    spans = []
    for strand in (0, 1):
        for r in range(diags.shape[1]):
            if counts[strand, r] <= 1:
                continue
            d0, d1 = int(diags[strand, r]), int(lasts[strand, r])
            weight = int(counts[strand, r])
            # wide sparse clusters are slop-merged junk: small regions
            # around the endpoint diagonals instead of one huge region
            if d1 - d0 > 4 * Q + 20_000 and weight <= 8:
                spans.append((d0, d0, weight, strand))
                spans.append((d1, d1, weight, strand))
            elif d1 - d0 > config.maxtotallen:
                # a dense wide train (a repeat family chained through
                # the slop): endpoint windows of maxtotallen
                spans.append((d0, min(d0 + config.maxtotallen, d1),
                              weight, strand))
                spans.append((max(d1 - config.maxtotallen, d0), d1,
                              weight, strand))
            else:
                spans.append((d0, d1, weight, strand))
    for (d0, d1, weight, strand) in spans:
        gstart = max(d0 - config.region_pad, 0)
        gend = min(d1 + Q + config.region_pad, index.genome_length)
        # a gene region never crosses a chromosome boundary
        lo = gstart
        while lo < gend:
            c = int(np.searchsorted(chrom_offsets, lo, side="right")) - 1
            chrom_end = int(chrom_offsets[c + 1])
            hi = min(gend, chrom_end)
            regions.append((lo, hi, weight, strand))
            lo = hi
    regions.sort(key=lambda t: -t[2])
    return regions[:config.top_regions]
