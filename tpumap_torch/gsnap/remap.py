"""Transcript remapping + RNA velocity of genome-path alignments.

Capability analog of the reference's src/transcript-remap.c
(Transcript_remap_all / _geneplus / _geneminus), src/exon.c
(Exon_list_validp, Exon_print_list) and src/transcript-velocity.c
(velocity_single / velocity_paired): given a read's GENOME alignment
(segments between splice junctions), find every overlapping transcript,
classify the alignment's consistency with its exon structure
(per-exon boundary characters), split into valid / invalid sets, assign
a spliced/unspliced/both velocity, and render the reference's
``XX:Z:`` (valid) / ``XY:Z:`` (invalid) SAM tags:

    XX:Z:<label>:<trstart>..<trend>:<S|U|B>:<fc><exoni+1><lc>|...

Boundary characters (transcript-remap.c:428-557):
    '.'  at a read end, inside or at the boundary of an exon
    's'  exactly at an exon boundary across a splice (consistent)
    'y'  a splice lands mid-exon (inconsistent junction)
    'i'  segment boundary inside an intron (retained intron evidence)
    'x'  segment straddles an exon/intron boundary
    'u'  outside the transcript (UTR extension)
"""
from __future__ import annotations

from bisect import bisect_right
from dataclasses import dataclass, field

import numpy as np


@dataclass
class ExonMark:
    firstchar: str
    exoni: int          # 0-based exon index in transcription order
    lastchar: str


@dataclass
class TranscriptHit:
    trnum: int
    label: str
    trstart: int        # 1-based transcript coords, inclusive
    trend: int
    exons: list[ExonMark] = field(default_factory=list)
    velocity: str = "*"
    intronp: bool = False

    def exon_string(self) -> str:
        return "|".join(f"{e.firstchar}{e.exoni + 1}{e.lastchar}"
                        for e in self.exons)


class TranscriptRemapper:
    """Per-transcriptome remapping state: a per-chromosome interval list
    of transcript genomic spans (the transcript_map_iit role,
    src/transcript-remap.c:60) + gene-space exon tables."""

    def __init__(self, tr):
        self.tr = tr
        # genomic span per transcript
        T = tr.ntranscripts
        span_lo = np.zeros(T, np.int64)
        span_hi = np.zeros(T, np.int64)
        for t in range(T):
            lo = int(tr.exon_offsets[t])
            hi = int(tr.exon_offsets[t + 1])
            starts = tr.exonstarts[lo:hi].astype(np.int64)
            lens = tr.exonlens[lo:hi].astype(np.int64)
            if int(tr.strand[t]) < 0:
                span_lo[t] = int((starts - lens + 1).min())
                span_hi[t] = int(starts.max()) + 1
            else:
                span_lo[t] = int(starts.min())
                span_hi[t] = int((starts + lens).max())
        order = np.argsort(span_lo, kind="stable")
        self._lo = span_lo[order]
        self._hi = span_hi[order]
        self._trnum = order
        self._cummax_hi = np.maximum.accumulate(self._hi)

    def overlapping(self, gstart: int, gend: int) -> list[int]:
        """Transcripts whose genomic span intersects [gstart, gend)."""
        j = bisect_right(self._lo, gend - 1)
        out = []
        for i in range(j - 1, -1, -1):
            if self._cummax_hi[i] <= gstart:
                break
            if self._hi[i] > gstart:
                out.append(int(self._trnum[i]))
        return sorted(out)

    # ------------------------------------------------------------------

    def _gene_space(self, trnum: int):
        """(exon_gs, exon_ge, bounds, minus, C): exon intervals in GENE
        space (ascending in transcription order; half-open), cumulative
        transcript bounds, and the minus-strand flip constant C with
        G(g) = C - 1 - g."""
        tr = self.tr
        lo = int(tr.exon_offsets[trnum])
        hi = int(tr.exon_offsets[trnum + 1])
        starts = tr.exonstarts[lo:hi].astype(np.int64)
        lens = tr.exonlens[lo:hi].astype(np.int64)
        bounds = tr.exonbounds[lo:hi].astype(np.int64)
        minus = int(tr.strand[trnum]) < 0
        if minus:
            C = int(starts.max()) + 1
            gs = C - 1 - starts             # first transcribed base
            ge = gs + lens
        else:
            C = 0
            gs = starts
            ge = starts + lens
        return gs, ge, bounds, minus, C

    def remap(self, segments: list[tuple[int, int]]):
        """Remap one alignment -> (valid_hits, invalid_hits).

        segments: [(gstart, gend)] half-open genome univcoords of the
        alignment's exons, ascending (junction-split; indels need not be
        split). The Transcript_remap_all analog.
        """
        if not segments:
            return [], []
        galo = min(s for s, _ in segments)
        gahi = max(e for _, e in segments)
        valid, invalid = [], []
        for trnum in self.overlapping(galo, gahi):
            hit = self._remap_one(trnum, segments)
            if hit is None:
                continue
            if _exon_list_validp(hit.exons):
                valid.append(hit)
            else:
                invalid.append(hit)
        return valid, invalid

    def _remap_one(self, trnum: int, segments):
        gs, ge, bounds, minus, C = self._gene_space(trnum)
        nex = len(gs)
        trlength = int(bounds[-1])
        # segments in gene space, transcription order, inclusive ends
        if minus:
            segs = [(C - 1 - (e - 1), C - 1 - s) for s, e in segments]
            segs = segs[::-1]
        else:
            segs = [(s, e - 1) for s, e in segments]

        hit = TranscriptHit(trnum=trnum, label=self.tr.labels[trnum],
                            trstart=-1, trend=0)
        exons: list[ExonMark] = []
        overall_trstart = None
        overall_trend = None
        for si, (astart, aend) in enumerate(segs):
            first_seg = si == 0
            last_seg = si == len(segs) - 1
            # exoni: rightmost exon starting at or before astart
            exoni = int(np.searchsorted(gs, astart, side="right")) - 1
            if exoni < 0:
                firstchar = "u"                 # starts before transcript
                trstart = 1
                exoni = 0
            else:
                exend = int(ge[exoni]) - 1      # last exon base
                if astart == int(gs[exoni]):
                    trstart = int(bounds[exoni]) - (exend - astart)
                    firstchar = "." if (exoni == 0 or first_seg) else "s"
                elif astart <= exend:           # mid-exon start
                    trstart = int(bounds[exoni]) - (exend - astart)
                    firstchar = "." if first_seg else "y"
                elif exoni >= nex - 1:          # starts after transcript
                    trstart = trlength + 1
                    firstchar = "u"
                elif aend < int(gs[exoni + 1]):
                    # segment entirely within an intron
                    trstart = int(bounds[exoni]) + 1
                    firstchar = "i"
                    hit.intronp = True
                    exoni += 1
                else:                           # straddles intron|exon
                    trstart = int(bounds[exoni]) + 1
                    firstchar = "x"
            if overall_trstart is None:
                overall_trstart = trstart

            # exonj: rightmost exon starting at or before aend
            exonj = int(np.searchsorted(gs, aend, side="right")) - 1
            if exonj < 0:
                lastchar = "u"                  # ends before transcript
                overall_trend = 0
                exonj = 0
            else:
                exendj = int(ge[exonj]) - 1
                if aend == exendj:
                    overall_trend = int(bounds[exonj])
                    lastchar = "." if exonj == nex - 1 else "s"
                elif aend < exendj:             # mid-exon end
                    overall_trend = int(bounds[exonj]) - (exendj - aend)
                    lastchar = "." if last_seg else "y"
                elif exonj == nex - 1:          # ends after transcript
                    overall_trend = trlength
                    lastchar = "u"
                elif astart > exendj:
                    # entire segment inside the intron after exonj
                    overall_trend = int(bounds[exonj])
                    lastchar = "i"
                else:                           # straddles exon|intron
                    overall_trend = int(bounds[exonj])
                    lastchar = "x"

            # interior exons fully spanned by this segment (retained
            # introns between them)
            i = exoni
            while i < exonj:
                exons.append(ExonMark(firstchar, i, "i"))
                hit.intronp = True
                firstchar = "i"
                i += 1
            if lastchar == "i" and exoni > exonj:
                # intron-interior segment: single 'i..i' mark
                exons.append(ExonMark("i", exonj, "i"))
                hit.intronp = True
            else:
                exons.append(ExonMark(firstchar, exonj, lastchar))
        if not exons or overall_trstart is None:
            return None
        hit.exons = exons
        hit.trstart = max(1, int(overall_trstart))
        hit.trend = min(trlength, int(overall_trend or overall_trstart))
        return hit


def _exon_list_validp(exons: list[ExonMark]) -> bool:
    """src/exon.c:165 Exon_list_validp (repairable distinction dropped)."""
    if not exons:
        return False
    if len(exons) == 1:
        e = exons[0]
        if e.firstchar in "ix" or e.lastchar in "ix":
            return False
        if e.firstchar == "u" and e.lastchar == "u":
            return False
        return True
    first, last = exons[0], exons[-1]
    if first.firstchar in "ix" or first.lastchar in "ixu":
        return False
    last_exoni = first.exoni
    for e in exons[1:-1]:
        if e.firstchar in "ixu" or e.lastchar in "ixu":
            return False
        if e.exoni != last_exoni + 1:
            return False
        last_exoni = e.exoni
    if last.firstchar in "ixu" or last.lastchar == "i" \
            or last.lastchar == "x":
        return False
    if last.exoni != last_exoni + 1:
        return False
    return True


# ----------------------------------------------------------------------
# velocity (src/transcript-velocity.c)

def velocity_single(hit: TranscriptHit, gene_nexons: int) -> str:
    """Retained x Spliced -> B / S / U (transcript-velocity.c:16-22)."""
    if gene_nexons == 1:
        spliced, retained = True, False
    elif len(hit.exons) == 1:
        spliced = False
        e = hit.exons[0]
        retained = ((e.firstchar == "i" and e.lastchar == "i")
                    or e.firstchar == "x" or e.lastchar == "x")
    else:
        spliced = True
        retained = (hit.exons[0].firstchar == "x"
                    or hit.exons[-1].lastchar == "x")
    if retained:
        return "U"
    return "S" if spliced else "B"


def velocity_paired(hit5: TranscriptHit, hit3: TranscriptHit,
                    gene_nexons: int) -> str:
    """Joint classification of both ends (transcript-velocity.c:114)."""
    def _retained(h):
        e0, eN = h.exons[0], h.exons[-1]
        return ((e0.firstchar == "i" and e0.lastchar == "i"
                 and len(h.exons) == 1)
                or e0.firstchar == "x" or eN.lastchar == "x")

    if gene_nexons == 1:
        spliced, retained = True, False
    elif len(hit5.exons) == 1 and len(hit3.exons) == 1:
        spliced = hit5.exons[0].exoni != hit3.exons[0].exoni
        retained = _retained(hit5) or _retained(hit3)
    else:
        spliced = True
        retained = _retained(hit5) or _retained(hit3)
    if retained:
        return "U"
    return "S" if spliced else "B"


def assign_velocities(tr, valid, invalid) -> None:
    for h in valid + invalid:
        h.velocity = velocity_single(h, tr.nexons(h.trnum))


import re as _re

_CIG = _re.compile(r"(\d+)([MIDNSHP=X])")


def segments_from_record(db, rec) -> list[tuple[int, int]]:
    """Genome univcoord segments [(start, end)) of a SAM record, split at
    N (introns); M/=/X/D advance the genome inside a segment."""
    if rec.flag & 4 or rec.rname == "*":
        return []
    try:
        ci = db.chrom_names.index(rec.rname)
    except ValueError:
        return []
    g = int(db.chrom_offsets[ci]) + rec.pos - 1
    segs = []
    seg_start = g
    for n, op in _CIG.findall(rec.cigar):
        n = int(n)
        if op in "M=XD":
            g += n
        elif op == "N":
            if g > seg_start:
                segs.append((seg_start, g))
            g += n
            seg_start = g
    if g > seg_start:
        segs.append((seg_start, g))
    return segs


def tag_record(remapper: TranscriptRemapper, db, rec) -> list[TranscriptHit]:
    """Remap one SAM record, set velocities, append its XX/XY tag.
    Returns the valid hits (for paired-end joint velocity)."""
    segs = segments_from_record(db, rec)
    if not segs:
        return []
    valid, invalid = remapper.remap(segs)
    assign_velocities(remapper.tr, valid, invalid)
    rec.tags.extend(xx_tags(valid, invalid))
    return valid


def tag_pair(remapper: TranscriptRemapper, db, rec5, rec3) -> None:
    """Remap both ends of a pair; transcripts seen by BOTH ends get the
    joint spliced/unspliced classification (Transcript_velocity_paired,
    src/transcript-velocity.c:364), others fall back to single-end."""
    tr = remapper.tr
    sides = []
    for rec in (rec5, rec3):
        segs = segments_from_record(db, rec)
        valid, invalid = remapper.remap(segs) if segs else ([], [])
        sides.append((rec, valid, invalid))
    by_tr = [{h.trnum: h for h in valid} for _, valid, _ in sides]
    for s, (rec, valid, invalid) in enumerate(sides):
        other = by_tr[1 - s]
        for h in valid + invalid:
            mate = other.get(h.trnum)
            if mate is not None:
                h.velocity = velocity_paired(h, mate, tr.nexons(h.trnum))
            else:
                h.velocity = velocity_single(h, tr.nexons(h.trnum))
        rec.tags.extend(xx_tags(valid, invalid))


def xx_tags(valid: list[TranscriptHit],
            invalid: list[TranscriptHit]) -> list[str]:
    """The XX:Z: / XY:Z: SAM tags (src/path-print-sam.c:1005-1010:
    XY printed only when there are no valid transcripts)."""
    def fmt(hits):
        return ",".join(f"{h.label}:{h.trstart}..{h.trend}:{h.velocity}:"
                        f"{h.exon_string()}" for h in hits)

    if valid:
        return [f"XX:Z:{fmt(valid)}"]
    if invalid:
        return [f"XY:Z:{fmt(invalid)}"]
    return []
