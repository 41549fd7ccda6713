"""GSNAP native ("standard") output format — the reference's DEFAULT
output when -A is not given (src/path-print-alignment.c
Path_print_alignment). The port's copy of tpumap/io/gsnapfmt.py; its
MaxEnt calls go to the port's gmap/maxent.py.

Shape (pinned against the reference binary):

  >ALIGNED_SEQ\tNPATHS\tACCESSION
   SEGMENT\tqlo..qhi\t[+-]chr:glo..ghi\tANNOT[,dir:...,splice_type:...]
  ,SEGMENT\t...                                  (continuation segments)
  <blank line>

Segment text is read-length wide: read bases over the aligned span
(genome-mismatch positions shown as the lowercase genome base), lowercase
intron/deletion context bases at junctions, '-' padding elsewhere.
Unmapped reads print only the header with NPATHS = 0.
"""
from __future__ import annotations

import numpy as np

from tpumap_torch.index.build import GenomeDB
from tpumap_torch.io.sam import SamRecord, _cigar_ops


def _lowercase_mismatches(db: GenomeDB, seq: str, univ: int) -> str:
    g = db.get_seq(univ, len(seq))
    return "".join(gc.lower() if rc != gc else rc
                   for rc, gc in zip(seq, g))


def _coords(db: GenomeDB, rec: SamRecord, glo_off: int, glen: int) -> str:
    lo = rec.pos + glo_off
    hi = lo + glen - 1
    if rec.flag & 16:
        # minus strand: descending coordinates relative to the read
        return f"-{rec.rname}:{hi}..{lo}"
    return f"+{rec.rname}:{lo}..{hi}"


def _univ(db: GenomeDB, rec: SamRecord) -> int:
    return int(db.chrom_offsets[db.chrom_names.index(rec.rname)]
               + rec.pos - 1)


def _splice_probs(db: GenomeDB, don_univ: int, acc_univ: int):
    """MaxEnt donor/acceptor probabilities at an intron's two ends
    (first intron base / last intron base, + strand model)."""
    try:
        from tpumap_torch.gmap import maxent
        W = 40
        start = max(don_univ - W, 0)
        codes = db.get_codes(start, acc_univ - start + W).astype(np.uint8)
        nmask = np.zeros(len(codes), dtype=bool)
        dp = float(maxent.donor_prob_at(codes, nmask,
                                        np.array([don_univ - start]))[0])
        ap = float(maxent.acceptor_prob_at(codes, nmask,
                                           np.array([acc_univ - start]))[0])
        return dp, ap
    except Exception:
        return 0.0, 0.0


def native_alignment(db: GenomeDB, rec_seq: str, acc: str,
                     rec: SamRecord) -> str:
    """One query's native-format block from its primary SAM record."""
    if rec.flag & 4:
        return f">{rec_seq}\t0\t{acc}\n\n"
    nh = next((int(t[5:]) for t in rec.tags if t.startswith("NH:i:")), 1)
    seq = rec.seq
    L = len(seq)
    minus = bool(rec.flag & 16)
    strand_ch = "-" if minus else "+"
    univ0 = _univ(db, rec)

    # split the CIGAR into exon segments at N/D/I boundaries
    segs = []      # (qstart, qend, goff, glen) 0-based, goff rel to univ0
    junctions = []  # ("splice"|"del"|"ins", size, between segs i,i+1)
    q = g = 0
    cur_q, cur_g = 0, 0
    open_seg = False
    for n, op in _cigar_ops(rec.cigar):
        if op in "M=X":
            if not open_seg:
                cur_q, cur_g = q, g
                open_seg = True
            q += n
            g += n
        elif op == "S":
            if not open_seg:
                cur_q, cur_g = q, g
            q += n
        elif op in "ND":
            if open_seg:
                segs.append((cur_q, q, cur_g, g - cur_g))
                open_seg = False
            junctions.append(("splice" if op == "N" else "del", n))
            g += n
        elif op == "I":
            if open_seg:
                segs.append((cur_q, q, cur_g, g - cur_g))
                open_seg = False
            junctions.append(("ins", n))
            q += n
    if open_seg:
        segs.append((cur_q, q, cur_g, g - cur_g))
    if not segs:
        return f">{rec_seq}\t0\t{acc}\n\n"

    xs = next((t[5:] for t in rec.tags if t.startswith("XS:A:")), None)
    dirname = {"+": "sense", "-": "antisense"}.get(xs, "sense")

    _comp = str.maketrans("ACGTacgt", "TGCAtgca")

    def rc_case(s):
        return s.translate(_comp)[::-1]

    header_seq = rc_case(rec_seq) if minus else rec_seq
    out = [f">{header_seq}\t{nh}\t{acc}"]
    rows = []
    for i, (qs, qe, goff, glen) in enumerate(segs):
        body = _lowercase_mismatches(db, seq[qs:qe], univ0 + goff)
        left_j = junctions[i - 1] if i > 0 else None
        right_j = junctions[i] if i < len(junctions) else None
        prefix_pad = qs
        lead = ""
        if left_j is not None:
            kind, size = left_j
            if kind == "splice":
                lead = db.get_seq(univ0 + goff - 2, 2).lower()
                prefix_pad = qs - len(lead)
            elif kind == "del":
                lead = ""
        trail = ""
        if right_j is not None:
            kind, size = right_j
            if kind == "splice":
                trail = db.get_seq(univ0 + goff + glen, 2).lower()
            elif kind == "del":
                trail = db.get_seq(univ0 + goff + glen, size).lower()
        suffix_pad = L - qe - len(trail)
        line_seq = ("-" * max(prefix_pad, 0) + lead + body + trail
                    + "-" * max(suffix_pad, 0))

        # annotations: start/end trims at the outer edges, junction info
        # at the inner edges
        if left_j is None:
            left_ann = f"start:{qs}"
        else:
            kind, size = left_j
            if kind == "splice":
                _dp, ap = _splice_probs(db, univ0 + goff - size,
                                        univ0 + goff - 1)
                left_ann = f"acceptor:{ap:.2f}"
            else:
                left_ann = f"{kind}:{size}"
        if right_j is None:
            right_ann = f"end:{L - qe}"
        else:
            kind, size = right_j
            if kind == "splice":
                dp, _ap = _splice_probs(db, univ0 + goff + glen,
                                        univ0 + goff + glen + size - 1)
                right_ann = f"donor:{dp:.2f}"
            else:
                right_ann = f"{kind}:{size}"
        ann = f"{left_ann}..{right_ann}"
        sp = [j for j in junctions if j[0] == "splice"]
        if sp and (left_j or right_j):
            near = right_j if right_j and right_j[0] == "splice" else left_j
            if near and near[0] == "splice":
                which = "2" if right_j is near else "1"
                ann += (f",dir:{dirname},splice_type:consistent,"
                        f"splice_dist_{which}:{near[1]}")
        lo = rec.pos + goff
        hi = lo + glen - 1
        if minus:
            # native format shows the read in ITS OWN orientation
            # (reference minus-strand output): reverse-complement the
            # display, swap the q-range and trim/junction sides, list
            # descending genome coordinates
            line_seq = ("-" * max(suffix_pad, 0) + rc_case(trail)
                        + rc_case(body) + rc_case(lead)
                        + "-" * max(prefix_pad, 0))
            qlo, qhi = L - qe + 1, L - qs
            coords = f"-{rec.rname}:{hi}..{lo}"
            swap = {"start": "end", "end": "start",
                    "donor": "acceptor", "acceptor": "donor"}
            la = left_ann.split(":")
            ra = right_ann.split(":")
            ann = (f"{swap.get(ra[0], ra[0])}:{ra[1]}.."
                   f"{swap.get(la[0], la[0])}:{la[1]}")
            if "," in right_ann or "," in left_ann:
                pass
            sp_extra = ""
            if "splice_dist" in left_ann + right_ann:
                near = (right_j if right_j and right_j[0] == "splice"
                        else left_j)
                which = "1" if (right_j is near) else "2"
                sp_extra = (f",dir:{dirname},splice_type:consistent,"
                            f"splice_dist_{which}:{near[1]}")
                ann = ann.split(",")[0] + sp_extra
            rows.append((qlo, f"{line_seq}\t{qlo}..{qhi}\t{coords}\t"
                              f"{ann}"))
        else:
            coords = f"+{rec.rname}:{lo}..{hi}"
            rows.append((qs + 1, f"{line_seq}\t{qs + 1}..{qe}\t{coords}\t"
                                 f"{ann}"))
    rows.sort(key=lambda r: r[0])
    for i, (_k, row) in enumerate(rows):
        out.append((" " if i == 0 else ",") + row)
    return "\n".join(out) + "\n\n"
