"""Alignment-mode base spaces (port of tpumap/ops/mode.py).

Bisulfite reads (mode cmet) carry C->T conversions and RNA-editing reads
(atoi, ttoc) A->G or T->C, so seeding and verification compare reads and
genome in a reduced base space. On 2-bit packed words (A=00 C=01 G=10
T=11) each transform is a bit trick:
    ct: C->T   set bit1 where bit0 is 1
    ga: G->A   clear bit1 where bit0 is 0
    ag: A->G   set bit1 where both bits are 0
    tc: T->C   clear bit1 where both bits are 1
A read aligned on the minus strand sees the complementary conversion,
hence the (plus, minus) pairs of MODE_SPACES.
"""
from __future__ import annotations

import numpy as np
import torch

from tpumap_torch.index.build import build_kmer_index
from tpumap_torch.ops.u32 import to_i32, u32
from tpumap_torch.utils import dna

LOW = 0x55555555

# per-code maps of each space (seeding transforms read codes with them)
CODE_MAPS = {
    "ct": np.array([0, 3, 2, 3], dtype=np.uint8),
    "ga": np.array([0, 1, 0, 3], dtype=np.uint8),
    "ag": np.array([2, 1, 2, 3], dtype=np.uint8),
    "tc": np.array([0, 1, 2, 1], dtype=np.uint8),
}

# the space of each mode per aligned strand (plus, minus)
MODE_SPACES = {
    "standard": (None, None),
    "cmet-stranded": ("ct", "ga"),
    "atoi-stranded": ("ag", "tc"),
    "ttoc-stranded": ("tc", "ag"),
}

# the space argument of the K1 kernel (csrc/verify.cu)
SPACE_CODES = {None: 0, "ct": 1, "ga": 2, "ag": 3, "tc": 4}


def add_mode_index(db, space: str) -> None:
    """GenomeDB.add_mode_index(space) (tpumap's method reads CODE_MAPS
    from tpumap/ops/mode.py, which imports JAX): the k-mer table of the
    genome mapped into the space, under db.mode_indexes[space]; db is a
    GenomeDB of either package."""
    codes = dna.unpack_2bit(db.genome_packed, db.genome_length)
    nmask = db.get_nmask(0, db.genome_length).astype(bool)
    db.mode_indexes = db.mode_indexes or {}
    db.mode_indexes[space] = build_kmer_index(CODE_MAPS[space][codes], nmask,
                                              db.k, db.interval)


def map_codes(codes: torch.Tensor, space: str | None) -> torch.Tensor:
    """uint8 codes mapped through CODE_MAPS[space]."""
    if space is None:
        return codes
    cmap = torch.from_numpy(CODE_MAPS[space]).to(codes.device)
    return cmap[codes.to(torch.int64)]


def transform_packed(words: torch.Tensor, space: str | None) -> torch.Tensor:
    """A base-space transform of 2-bit packed words: int64 values in
    [0, 2^32) stay int64, int32 bit patterns stay int32. Every `~` term
    is masked with LOW, so int64 values never gain bits above 31."""
    if space is None:
        return words
    if words.dtype == torch.int32:
        return to_i32(transform_packed(u32(words), space))
    w = words
    if space == "ct":
        return w | ((w & LOW) << 1)
    if space == "ga":
        return w & ~((~w & LOW) << 1)
    if space == "ag":
        return w | ((~(w | (w >> 1)) & LOW) << 1)
    if space == "tc":
        return w & ~(((w & (w >> 1)) & LOW) << 1)
    raise ValueError(space)
