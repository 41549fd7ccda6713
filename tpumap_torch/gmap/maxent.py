"""MaxEnt splice-site probability models (Yeo & Burge 2004).

The port's copy of tpumap/gmap/maxent.py; the code is unchanged.

Functional equivalent of the reference's src/maxent.c Maxent_donor_prob /
Maxent_acceptor_prob (and the genome-direct variants in src/maxent_hr.c):
donor sites are scored from a 9-mer (3 exon | GT | 4 intron), acceptors
from a 23-mer (20 intron ending in AG | 3 exon), via lookup-table products
plus a consensus-dinucleotide odds factor, mapped to a probability
odds/(1+odds).

Model coefficients live in tpumap_torch/data/maxent_tables.npz, the
port's copy of tpumap/data/maxent_tables.npz (extracted once
by tools/gen_maxent_tables.py; see that script for provenance). All
functions are vectorized over candidate site arrays (host numpy).

Margins (matching src/maxent.h:4-10):
  DONOR_LEFT=3 exon bases, DONOR_RIGHT=6 intron bases (GT + 4)
  ACCEPTOR_LEFT=20 intron bases (..AG), ACCEPTOR_RIGHT=3 exon bases
"""
from __future__ import annotations

import pathlib

import numpy as np

DONOR_LEFT, DONOR_RIGHT = 3, 6
ACCEPTOR_LEFT, ACCEPTOR_RIGHT = 20, 3

_BG = np.array([0.27, 0.23, 0.23, 0.27])   # background A C G T
_DONOR_DI1 = np.array([0.0040, 0.0032, 0.9896, 0.0032]) / _BG
_DONOR_DI2 = np.array([0.0034, 0.0039, 0.0042, 0.9884]) / _BG
_ACC_DI1 = np.array([0.9903, 0.0032, 0.0034, 0.0030]) / _BG
_ACC_DI2 = np.array([0.0027, 0.0037, 0.9905, 0.0030]) / _BG

_DATA = pathlib.Path(__file__).resolve().parent.parent / "data" / "maxent_tables.npz"
_tables = None


def tables() -> dict:
    global _tables
    if _tables is None:
        z = np.load(_DATA)
        _tables = {k: z[k] for k in z.files}
    return _tables


def _hash(codes: np.ndarray, start: int, length: int) -> np.ndarray:
    """codes [..., W] -> base-4 hash of codes[..., start:start+length]."""
    h = np.zeros(codes.shape[:-1], dtype=np.int64)
    for j in range(length):
        h = h * 4 + codes[..., start + j]
    return h


def donor_prob(codes: np.ndarray, nmask: np.ndarray | None = None) -> np.ndarray:
    """codes [..., 9] (3 exon | GT | 4 intron) -> probability [...]."""
    t = tables()
    codes = np.asarray(codes, dtype=np.int64)
    idx = _hash(codes, 0, 3) * (4 ** 4) + _hash(codes, 5, 4)
    maxent = t["me2x3donor"][idx]
    odds = _DONOR_DI1[codes[..., 3]] * _DONOR_DI2[codes[..., 4]] * maxent
    prob = odds / (1.0 + odds)
    if nmask is not None:
        prob = np.where(np.asarray(nmask).any(axis=-1), 0.0, prob)
    return prob


def acceptor_prob(codes: np.ndarray, nmask: np.ndarray | None = None) -> np.ndarray:
    """codes [..., 23] (20 intron ..AG | 3 exon) -> probability [...]."""
    t = tables()
    codes = np.asarray(codes, dtype=np.int64)
    s0 = t["me2x3acc1"][_hash(codes, 0, 7)]
    s1 = t["me2x3acc2"][_hash(codes, 7, 7)]
    s2 = t["me2x3acc3"][_hash(codes, 14, 4) * (4 ** 3) + _hash(codes, 20, 3)]
    s3 = t["me2x3acc4"][_hash(codes, 4, 7)]
    s4 = t["me2x3acc5"][_hash(codes, 11, 7)]
    s5 = t["me2x3acc6"][_hash(codes, 4, 3)]
    s6 = t["me2x3acc7"][_hash(codes, 7, 4)]
    s7 = t["me2x3acc8"][_hash(codes, 11, 3)]
    s8 = t["me2x3acc9"][_hash(codes, 14, 4)]
    maxent = (s0 * s1 * s2 * s3 * s4) / (s5 * s6 * s7 * s8)
    odds = _ACC_DI1[codes[..., 18]] * _ACC_DI2[codes[..., 19]] * maxent
    prob = odds / (1.0 + odds)
    if nmask is not None:
        prob = np.where(np.asarray(nmask).any(axis=-1), 0.0, prob)
    return prob


def donor_prob_at(region_codes: np.ndarray, region_nmask: np.ndarray,
                  first_intron_pos: np.ndarray) -> np.ndarray:
    """Donor probs at genomic positions (position of first intron base)."""
    pos = np.atleast_1d(np.asarray(first_intron_pos, dtype=np.int64))
    off = np.arange(-DONOR_LEFT, DONOR_RIGHT)
    idx = pos[:, None] + off[None, :]
    ok = (idx >= 0) & (idx < len(region_codes))
    codes = np.where(ok, region_codes[np.clip(idx, 0, len(region_codes) - 1)], 0)
    bad = ~ok | (region_nmask[np.clip(idx, 0, len(region_codes) - 1)] != 0)
    return donor_prob(codes, bad)


def antidonor_prob_at(region_codes: np.ndarray, region_nmask: np.ndarray,
                      first_exon_after: np.ndarray) -> np.ndarray:
    """Antisense donor probs (Maxent_hr_antidonor_prob, src/maxent_hr.c):
    the donor model evaluated on the minus strand. `first_exon_after` is
    the + coordinate one past the antisense intron's right edge (= the
    gene-space exon|intron boundary read on the minus strand)."""
    pos = np.atleast_1d(np.asarray(first_exon_after, dtype=np.int64))
    # minus-strand (3 exon | 6 intron) window = revcomp of +[e-6, e+3)
    idx = pos[:, None] + (np.arange(2, -7, -1))[None, :]
    ok = (idx >= 0) & (idx < len(region_codes))
    cl = np.clip(idx, 0, len(region_codes) - 1)
    codes = np.where(ok, 3 - region_codes[cl], 0)
    bad = ~ok | (region_nmask[cl] != 0)
    return donor_prob(codes, bad)


def antiacceptor_prob_at(region_codes: np.ndarray, region_nmask: np.ndarray,
                         first_intron_pos: np.ndarray) -> np.ndarray:
    """Antisense acceptor probs (Maxent_hr_antiacceptor_prob):
    `first_intron_pos` is the + coordinate of the antisense intron's left
    edge (= the gene-space intron|exon boundary read on the minus strand).
    Window = revcomp of +[s-3, s+20)."""
    pos = np.atleast_1d(np.asarray(first_intron_pos, dtype=np.int64))
    idx = pos[:, None] + (np.arange(19, -4, -1))[None, :]
    ok = (idx >= 0) & (idx < len(region_codes))
    cl = np.clip(idx, 0, len(region_codes) - 1)
    codes = np.where(ok, 3 - region_codes[cl], 0)
    bad = ~ok | (region_nmask[cl] != 0)
    return acceptor_prob(codes, bad)


def acceptor_prob_at(region_codes: np.ndarray, region_nmask: np.ndarray,
                     last_intron_pos: np.ndarray) -> np.ndarray:
    """Acceptor probs (position of last intron base, the G of AG)."""
    pos = np.atleast_1d(np.asarray(last_intron_pos, dtype=np.int64))
    off = np.arange(-ACCEPTOR_LEFT + 1, ACCEPTOR_RIGHT + 1)
    idx = pos[:, None] + off[None, :]
    ok = (idx >= 0) & (idx < len(region_codes))
    codes = np.where(ok, region_codes[np.clip(idx, 0, len(region_codes) - 1)], 0)
    bad = ~ok | (region_nmask[np.clip(idx, 0, len(region_codes) - 1)] != 0)
    return acceptor_prob(codes, bad)
