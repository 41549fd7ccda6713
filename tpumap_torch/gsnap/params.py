"""Refinement-ladder trigger parameters (shared host/device; a copy of
tpumap/gsnap/params.py).

Mirrors the reference's method-ladder economics (src/stage1hr-single.c
found_score thresholds, src/path-solve.c, src/spliceends.c
min_shortend): which reads escalate from the substitution cascade to
the indel DP and chain-DP splice stages.
"""

INDEL_NMM_TRIGGER = 4     # reads with >= this many mismatches get a DP pass
CLIP_INDEL_TRIGGER = 5    # or >= this many soft-clipped bases: a short
#                           clipped tail often hides an END indel whose
#                           few tail mismatches stay under the nmm
#                           trigger (Dynprog_end5/3_gap QUERYEND_INDELS
#                           role, src/dynprog_end.h:26,48)
INDEL_BAND = 32
INDEL_MARGIN = 4
SPLICE_NMM_TRIGGER = 6    # and >= this many get the splice-junction pass
CLIP_SPLICE_TRIGGER = 6   # or >= this many soft-clipped bases (a clipped
#                           end is often an unplaced exon, spliceends.c;
#                           6 = MIN_FRAG: a hidden exon of >= 6 bases
#                           leaves >= ~5-6 clipped; lower floods the
#                           fixed chain compaction with trim noise and
#                           OVERFLOWS real spliced rows out (the
#                           round-4 recall collapse; cf. min_shortend)
MAX_CAND_PAIRS = 8
CHAIN_K = 8               # candidate diagonals per read in the chain solver
MIN_INTRON = 9
