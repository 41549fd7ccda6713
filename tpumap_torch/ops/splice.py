"""Splice-site scoring.

The port's copy of tpumap/ops/splice.py, unchanged but for its imports.

Round-1 model: canonical dinucleotide scoring (GT-AG > GC-AG/AT-AC > none)
used for junction placement, the same decision structure as the reference's
bridge scoring in src/dynprog_genome.c (canonicity) — the MaxEnt
donor/acceptor probability models (src/maxent.c, src/maxent_hr.c, the
Yeo & Burge 2004 maximum-entropy splice model) plug in here as device LUTs
in a later milestone (see gmap/maxent.py).
"""
from __future__ import annotations

import numpy as np

# code pairs (intron first two, intron last two) -> (name, bonus)
# sense: GT-AG, GC-AG, AT-AC; antisense equivalents: CT-AC, CT-GC, GT-AT
_CANONICAL = {
    ((2, 3), (0, 2)): ("GT-AG", 20.0),
    ((2, 1), (0, 2)): ("GC-AG", 12.0),
    ((0, 3), (0, 1)): ("AT-AC", 8.0),
    ((1, 3), (0, 1)): ("CT-AC", 20.0),
    ((1, 3), (2, 1)): ("CT-GC", 12.0),
    ((2, 3), (0, 3)): ("GT-AT", 8.0),
}


def splice_score_canonical(region_codes: np.ndarray, diag_left: int,
                           diag_right: int, cand_q: np.ndarray):
    """Score candidate exon boundaries q* for a junction.

    For boundary q*: the intron occupies genomic [diag_left + q*,
    diag_right + q*). Returns (float bonus[NC], list[str] kinds[NC]).
    """
    R = len(region_codes)
    g_don = cand_q + diag_left        # first intron base
    g_acc = cand_q + diag_right - 1   # last intron base
    bonus = np.zeros(len(cand_q), dtype=np.float64)
    kinds = [""] * len(cand_q)
    for i in range(len(cand_q)):
        d0, d1, a0, a1 = g_don[i], g_don[i] + 1, g_acc[i] - 1, g_acc[i]
        if d0 < 0 or a1 >= R or a0 < d1:
            continue
        key = ((int(region_codes[d0]), int(region_codes[d1])),
               (int(region_codes[a0]), int(region_codes[a1])))
        if key in _CANONICAL:
            kinds[i], bonus[i] = _CANONICAL[key]
    return bonus, kinds
