"""SAM output (host side): a copy of tpumap/io/sam.py, so the port's SAM
stays byte-identical to tpumap's.

Capability analog of src/path-print-sam.c (Path_print_sam) + samheader.c.
Takes finished alignment records and prints SAM lines; CIGAR/MD/NM are
computed from the alignment structure plus the host genome.
"""
from __future__ import annotations

import re
import sys
from dataclasses import dataclass, field

import numpy as np

from tpumap_torch import native
from tpumap_torch.index.build import GenomeDB
from tpumap_torch.utils import dna


@dataclass
class SamRecord:
    qname: str
    flag: int
    rname: str = "*"
    pos: int = 0               # 1-based
    mapq: int = 0
    cigar: str = "*"
    rnext: str = "*"
    pnext: int = 0
    tlen: int = 0
    seq: str = "*"
    qual: str = "*"
    tags: list[str] = field(default_factory=list)

    # secondary alignments attached by the -n/--npaths path; each is a
    # SamRecord flagged 0x100 and printed right after the primary
    secondaries: list | None = None

    def line(self) -> str:
        cols = [self.qname, str(self.flag), self.rname, str(self.pos),
                str(self.mapq), self.cigar, self.rnext, str(self.pnext),
                str(self.tlen), self.seq, self.qual] + self.tags
        return "\t".join(cols)

    def lines(self) -> str:
        """Primary + attached secondary records, newline-terminated."""
        out = self.line() + "\n"
        for sec in self.secondaries or ():
            out += sec.line() + "\n"
        return out


def header(db: GenomeDB, program_args: str = "", rg: str | None = None,
           sort_order: str = "unsorted", rg_name: str | None = None,
           rg_library: str | None = None,
           rg_platform: str | None = None) -> str:
    lines = [f"@HD\tVN:1.6\tSO:{sort_order}"]
    for i, name in enumerate(db.chrom_names):
        lines.append(f"@SQ\tSN:{name}\tLN:{db.chrom_length(i)}")
    if rg:
        rg_line = f"@RG\tID:{rg}"
        if rg_name:
            rg_line += f"\tSM:{rg_name}"
        if rg_library:
            rg_line += f"\tLB:{rg_library}"
        if rg_platform:
            rg_line += f"\tPL:{rg_platform}"
        lines.append(rg_line)
    lines.append(f"@PG\tID:tpumap\tPN:tpumap\tVN:0.1.0\tCL:{program_args}")
    return "\n".join(lines) + "\n"


_SPACE_MAPS = {
    None: {},
    "ct": {"C": "T"},
    "ga": {"G": "A"},
    "ag": {"A": "G"},
    "tc": {"T": "C"},
}


def md_and_nm(read_seq: str, genome_seq: str,
              space: str | None = None) -> tuple[str, int]:
    """MD tag + NM count for an ungapped alignment.

    With `space` set (cmet/atoi modes), mode conversions (e.g. genome C
    read as T in bisulfite data) are counted as matches, like the
    reference's mode-aware mismatch kernels.
    """
    if (space is None and len(read_seq) == len(genome_seq)
            and "N" not in read_seq):
        lib = native.get_lib()
        if lib:
            buf = bytes(4 * len(read_seq) + 16)
            nm = lib.md_nm(read_seq.encode(), genome_seq.encode(),
                           len(read_seq), buf)
            return buf[:buf.index(0)].decode(), int(nm)
    conv = _SPACE_MAPS.get(space, {})
    md, run, nm = [], 0, 0
    for r, g in zip(read_seq, genome_seq):
        # query N prints as a match (reference emission under the default
        # query_unk_mismatch_p=false, src/gsnap.c:336); genome N is a
        # mismatch (genome_unk_mismatch_p=true, src/gsnap.c:337)
        if (r == g or conv.get(g) == r or r == "N") and g != "N":
            run += 1
        else:
            md.append(str(run))
            md.append(g)
            run = 0
            nm += 1
    md.append(str(run))
    return "".join(md), nm


def cigar_from_ops(ops) -> str:
    """Edit transcript (0=M, 1=I, 2=D, forward order) -> CIGAR string."""
    names = "MID"
    out = []
    run, n = None, 0
    for o in ops:
        c = names[o]
        if c == run:
            n += 1
        else:
            if run:
                out.append(f"{n}{run}")
            run, n = c, 1
    if run:
        out.append(f"{n}{run}")
    return "".join(out) or "*"


def md_nm_from_ops(ops, read_seq: str, genome_seq: str) -> tuple[str, int]:
    """MD tag + NM for an alignment with indels.

    genome_seq covers exactly the genome bases consumed by the alignment.
    """
    md, run, nm = [], 0, 0
    i = j = 0
    k = 0
    n_ops = len(ops)
    while k < n_ops:
        o = ops[k]
        if o == 0:      # match/mismatch
            r, g = read_seq[i], genome_seq[j]
            if (r == g or r == "N") and g != "N":
                run += 1
            else:
                md.append(f"{run}{g}")
                run = 0
                nm += 1
            i += 1
            j += 1
            k += 1
        elif o == 1:    # insertion (query only)
            while k < n_ops and ops[k] == 1:
                i += 1
                nm += 1
                k += 1
        else:           # deletion (genome only)
            md.append(f"{run}^")
            run = 0
            while k < n_ops and ops[k] == 2:
                md.append(genome_seq[j])
                j += 1
                nm += 1
                k += 1
    md.append(str(run))
    return "".join(md), nm


def gapped_record(db: GenomeDB, qname: str, seq: str, qual: str | None,
                  pos0: int, strand: int, mapq: int, ops) -> SamRecord:
    """SAM record from a DP edit transcript (forward order, M/I/D codes)."""
    oriented = dna.revcomp(seq) if strand else seq
    glen = sum(1 for o in ops if o != 1)
    rname, chrpos = db.chrpos(pos0)
    genome_seq = db.get_seq(pos0, glen)
    md, nm = md_nm_from_ops(ops, oriented, genome_seq)
    q = qual or "*"
    if strand and qual:
        q = qual[::-1]
    return SamRecord(
        qname=qname, flag=16 if strand else 0, rname=rname, pos=chrpos + 1,
        mapq=mapq, cigar=cigar_from_ops(ops), seq=oriented, qual=q,
        tags=[f"NM:i:{nm}", f"MD:Z:{md}"])


def spliced_record(db: GenomeDB, qname: str, seq: str, qual: str | None,
                   diagA: int, diagB: int, qstar: int, qlen: int,
                   strand: int, mapq: int, sense: int) -> SamRecord:
    """SAM record for a one-intron spliced read: qM nN (L-q)M.

    diagA/diagB are univdiagonals of the left/right exon parts; the intron
    spans genomic [diagA + qstar, diagB + qstar).
    """
    oriented = dna.revcomp(seq) if strand else seq
    rname, chrpos = db.chrpos(diagA)
    intron = diagB - diagA
    left = db.get_seq(diagA, qstar)
    right = db.get_seq(diagB + qstar, qlen - qstar)
    md, nm = md_and_nm(oriented, left + right)
    q = qual or "*"
    if strand and qual:
        q = qual[::-1]
    # XS = transcript strand on the genome: the canonical dinucleotides are
    # read from the + genome, so sense=+1 (GT..AG) means '+' regardless of
    # the read's own orientation
    tags = [f"NM:i:{nm}", f"MD:Z:{md}"]
    if sense:
        tags.append(f"XS:A:{'+' if sense == 1 else '-'}")
    return SamRecord(
        qname=qname, flag=16 if strand else 0, rname=rname, pos=chrpos + 1,
        mapq=mapq, cigar=f"{qstar}M{intron}N{qlen - qstar}M",
        seq=oriented, qual=q, tags=tags)


def multi_exon_record(db: GenomeDB, qname: str, seq: str, qual: str | None,
                      segs: list[tuple[int, int, int]], genome_strand: int,
                      mapq: int, sense: int,
                      extra_tags: list[str] | None = None) -> SamRecord:
    """SAM record for a multi-exon alignment with KNOWN junction structure
    (the transcriptome-guided path, src/trpath-convert.c + Path_print_sam).

    segs: [(genome_univcoord_leftmost, query_offset, length)] in ascending
    genome order, query offsets referring to the genome-plus-oriented read;
    gaps between segments become N (intron) CIGAR ops.
    """
    oriented = dna.revcomp(seq) if genome_strand else seq
    rname, chrpos = db.chrpos(segs[0][0])
    cigar_parts = []
    gseq_parts = []
    prev_end = None
    for (g, qoff, n) in segs:
        if prev_end is not None:
            intron = g - prev_end
            cigar_parts.append(f"{intron}N")
        cigar_parts.append(f"{n}M")
        gseq_parts.append(db.get_seq(g, n))
        prev_end = g + n
    md, nm = md_and_nm(oriented, "".join(gseq_parts))
    q = qual or "*"
    if genome_strand and qual:
        q = qual[::-1]
    tags = [f"NM:i:{nm}", f"MD:Z:{md}"]
    if sense:
        tags.append(f"XS:A:{'+' if sense > 0 else '-'}")
    tags.extend(extra_tags or [])
    return SamRecord(
        qname=qname, flag=16 if genome_strand else 0, rname=rname,
        pos=chrpos + 1, mapq=mapq, cigar="".join(cigar_parts),
        seq=oriented, qual=q, tags=tags)


def fusion_records(db: GenomeDB, qname: str, seq: str, qual: str | None,
                   diagA: int, diagB: int, qstar: int, strand: int,
                   mapq: int) -> list[SamRecord]:
    """Two SAM records for a fusion/translocation split read
    (src/path-fusion.c capability): the read prefix [0, qstar) aligns at
    diagA, the suffix [qstar, L) at diagB (arbitrary distance/chromosome,
    same orientation). The longer piece is primary, the other is
    SUPPLEMENTARY (0x800), linked with SA:Z tags (the modern SAM
    convention for the reference's distant/fusion output)."""
    L = len(seq)
    oriented = dna.revcomp(seq) if strand else seq
    q = qual or "*"
    if strand and qual:
        q = qual[::-1]
    rnameA, posA = db.chrpos(diagA)
    rnameB, posB = db.chrpos(diagB + qstar)
    strand_ch = "-" if strand else "+"

    mdA, nmA = md_and_nm(oriented[:qstar], db.get_seq(diagA, qstar))
    mdB, nmB = md_and_nm(oriented[qstar:], db.get_seq(diagB + qstar,
                                                      L - qstar))
    cigA = f"{qstar}M{L - qstar}S"
    cigB = f"{qstar}S{L - qstar}M"
    saA = f"SA:Z:{rnameB},{posB + 1},{strand_ch},{cigB},{mapq},{nmB};"
    saB = f"SA:Z:{rnameA},{posA + 1},{strand_ch},{cigA},{mapq},{nmA};"
    flag = 16 if strand else 0
    a_primary = qstar >= L - qstar          # longer piece is primary
    recA = SamRecord(qname=qname, flag=flag | (0 if a_primary else 0x800),
                     rname=rnameA, pos=posA + 1,
                     mapq=mapq, cigar=cigA, seq=oriented, qual=q,
                     tags=[f"NM:i:{nmA}", f"MD:Z:{mdA}", saA])
    recB = SamRecord(qname=qname, flag=flag | (0x800 if a_primary else 0),
                     rname=rnameB,
                     pos=posB + 1, mapq=mapq, cigar=cigB, seq=oriented,
                     qual=q, tags=[f"NM:i:{nmB}", f"MD:Z:{mdB}", saB])
    return [recA, recB] if a_primary else [recB, recA]


def fusion_records_inverted(db: GenomeDB, qname: str, seq: str,
                            qual: str | None, d_fwd: int, d_rc: int,
                            qstar: int, fwd_first: bool,
                            mapq: int) -> list[SamRecord]:
    """Two SAM records for an INVERTED (cross-strand) fusion split read
    (src/path-fusion.c inversion joins): one piece aligns forward, the
    other as the reverse complement.

    fwd_first=True: read[0, qstar) forward at univdiagonal d_fwd (read
    coords) and read[qstar, L) inverted — i.e. rc(read)[0, L-qstar) at
    univdiagonal d_rc (rc-read coords).
    fwd_first=False: read[0, qstar) inverted — rc(read)[L-qstar, L) at
    d_rc — and read[qstar, L) forward at d_fwd."""
    L = len(seq)
    rcseq = dna.revcomp(seq)
    q = qual or "*"
    rcq = qual[::-1] if qual else "*"
    if fwd_first:
        # fwd piece: read[0:qstar) at d_fwd
        posF_u, lenF, cigF = d_fwd, qstar, f"{qstar}M{L - qstar}S"
        segF = seq[:qstar]
        gF = d_fwd
        # rc piece: rc(read)[0:L-qstar) at d_rc
        posR_u, lenR, cigR = d_rc, L - qstar, f"{L - qstar}M{qstar}S"
        segR = rcseq[:L - qstar]
        gR = d_rc
    else:
        # rc piece: rc(read)[L-qstar:L) at d_rc + (L - qstar)
        posR_u, lenR, cigR = (d_rc + (L - qstar), qstar,
                              f"{L - qstar}S{qstar}M")
        segR = rcseq[L - qstar:]
        gR = d_rc + (L - qstar)
        # fwd piece: read[qstar:L) at d_fwd + qstar
        posF_u, lenF, cigF = d_fwd + qstar, L - qstar, f"{qstar}S{L - qstar}M"
        segF = seq[qstar:]
        gF = d_fwd + qstar
    rnameF, posF = db.chrpos(posF_u)
    rnameR, posR = db.chrpos(posR_u)
    mdF, nmF = md_and_nm(segF, db.get_seq(gF, lenF))
    mdR, nmR = md_and_nm(segR, db.get_seq(gR, lenR))
    saF = f"SA:Z:{rnameR},{posR + 1},-,{cigR},{mapq},{nmR};"
    saR = f"SA:Z:{rnameF},{posF + 1},+,{cigF},{mapq},{nmF};"
    f_primary = lenF >= lenR                # longer piece is primary
    recF = SamRecord(qname=qname, flag=0 | (0 if f_primary else 0x800),
                     rname=rnameF, pos=posF + 1, mapq=mapq, cigar=cigF,
                     seq=seq, qual=q,
                     tags=[f"NM:i:{nmF}", f"MD:Z:{mdF}", saF])
    recR = SamRecord(qname=qname, flag=16 | (0x800 if f_primary else 0),
                     rname=rnameR, pos=posR + 1, mapq=mapq, cigar=cigR,
                     seq=rcseq, qual=rcq,
                     tags=[f"NM:i:{nmR}", f"MD:Z:{mdR}", saR])
    return [recF, recR] if f_primary else [recR, recF]


def unmapped_record(qname: str, seq: str, qual: str | None) -> SamRecord:
    return SamRecord(qname=qname, flag=4, seq=seq, qual=qual or "*")


_SENSE_PLUS = {("G", "T", "A", "G"), ("G", "C", "A", "G"),
               ("A", "T", "A", "C")}
_SENSE_MINUS = {("C", "T", "A", "C"), ("C", "T", "G", "C"),
                ("G", "T", "A", "T")}


def _junction_sense(db: GenomeDB, don_pos: int, acc_end: int,
                    known=None) -> int:
    """Transcription sense of an intron [don_pos, acc_end) on the + genome
    from its boundary dinucleotides: +1 GT..AG-side, -1 antisense, 0.
    Non-canonical boundaries fall back to the known-splicing annotation
    (a known junction carries its strand, src/knownsplicing.c sense)."""
    d = db.get_seq(don_pos, 2)
    a = db.get_seq(acc_end - 2, 2)
    key = (d[0], d[1], a[0], a[1])
    if key in _SENSE_PLUS:
        return 1
    if key in _SENSE_MINUS:
        return -1
    if known is not None:
        dp, ae = np.uint64(don_pos), np.uint64(acc_end)
        for arr, sense in ((known.junctions, 1), (known.anti_junctions, -1)):
            if len(arr):
                j = np.searchsorted(arr[:, 0], dp)
                while j < len(arr) and arr[j, 0] == dp:
                    if arr[j, 1] == ae:
                        return sense
                    j += 1
        if (dp in known.donor and ae in known.acceptor):
            return 1
        if (dp in known.antiacceptor and ae in known.antidonor):
            return -1
    return 0


def path_record(db: GenomeDB, qname: str, seq: str, qual: str | None,
                segs: list[tuple[int, int]], q_start: int, q_end: int,
                strand: int, mapq: int, min_intron: int = 9,
                known=None) -> SamRecord:
    """SAM record from a chain-DP path (ops/pathdp.chain_solve output):
    soft-clipped ends + N-exon structure with introns (N) and deletions
    (D) between segments — the Path_print_sam analog for paths solved by
    the batched solver (src/path-print-sam.c:1852 + src/path.h segments).

    segs: [(qpos, univdiagonal)] ascending query order; segment i covers
    query [qpos_i, qpos_{i+1} or q_end) at genome univdiagonal diag_i.
    Raises ValueError on a segment shorter than the insertion after it
    (the chain stages mend such paths first: driver._mend_overrun).
    """
    L = len(seq)
    oriented = dna.revcomp(seq) if strand else seq
    q = qual or "*"
    if strand and qual:
        q = qual[::-1]
    cig = []
    if q_start:
        cig.append(f"{q_start}S")
    ops: list[int] = []
    read_parts, genome_parts = [], []
    senses = []
    for i, (q0, d) in enumerate(segs):
        q1 = segs[i + 1][0] if i + 1 < len(segs) else q_end
        gap = segs[i + 1][1] - d if i + 1 < len(segs) else 0
        # insertion junction (gap < 0, src/junction.h:5 INS_JUNCTION):
        # the next segment sits |gap| diagonals EARLIER; query bases
        # [q1 - |gap|, q1) are inserted relative to the genome, and this
        # segment's M run ends where the insertion begins
        n_ins = -gap if gap < 0 else 0
        n = q1 - n_ins - q0
        if n < 0:
            raise ValueError(f"path_record: segment {i} of {qname} has "
                             f"{q1 - q0} bases before a {n_ins}-base "
                             f"insertion")
        cig.append(f"{n}M")
        ops.extend([0] * n)
        read_parts.append(oriented[q0:q1 - n_ins])
        genome_parts.append(db.get_seq(d + q0, n))
        if i + 1 < len(segs):
            if n_ins:
                cig.append(f"{n_ins}I")
                ops.extend([1] * n_ins)
                read_parts.append(oriented[q1 - n_ins:q1])
            elif gap >= min_intron:
                cig.append(f"{gap}N")
                senses.append(_junction_sense(db, d + q1,
                                              segs[i + 1][1] + q1,
                                              known=known))
            else:
                cig.append(f"{gap}D")
                ops.extend([2] * gap)
                genome_parts.append(db.get_seq(d + q1, gap))
    if L - q_end:
        cig.append(f"{L - q_end}S")
    md, nm = md_nm_from_ops(ops, "".join(read_parts), "".join(genome_parts))
    rname, chrpos = db.chrpos(segs[0][1] + q_start)
    tags = [f"NM:i:{nm}", f"MD:Z:{md}"]
    net = sum(senses)
    if any(s != 0 for s in senses):
        tags.append(f"XS:A:{'+' if net >= 0 else '-'}")
    elif senses:
        tags.append("XS:A:?")
    return SamRecord(
        qname=qname, flag=16 if strand else 0, rname=rname, pos=chrpos + 1,
        mapq=mapq, cigar="".join(cig), seq=oriented, qual=q, tags=tags)


def ungapped_record(db: GenomeDB, qname: str, seq: str, qual: str | None,
                    diag: int, strand: int, mapq: int,
                    nmismatch: int, space: str | None = None,
                    snp: bool = False, q_start: int = 0,
                    q_end: int | None = None) -> SamRecord:
    """SAM record for an ungapped (substitution-only) alignment, with
    optional soft-clipped ends ([q_start, q_end) aligned, the rest S —
    the Path_trim soft-clip emission, src/path-print-sam.c clip policy).

    diag = univcoord of query base 0 in the aligned orientation; strand 1
    means the read aligned as its reverse complement. With snp=True and a
    SNP-tolerant db, NM stays reference-based and XW/XV carry the
    both-diff / SNP-explained counts (src/path-print-sam.c:932-945).
    """
    L = len(seq)
    if q_end is None:
        q_end = L
    rname, chrpos = db.chrpos(diag + q_start)
    oriented = dna.revcomp(seq) if strand else seq
    genome_seq = db.get_seq(diag + q_start, q_end - q_start)
    md, nm = md_and_nm(oriented[q_start:q_end], genome_seq, space)
    tags = [f"NM:i:{nm}", f"MD:Z:{md}"]
    if snp and db.genomealt_packed is not None:
        alt_seq = db.get_alt_seq(diag + q_start, q_end - q_start)
        bothdiff = sum(1 for r, g, a in zip(oriented[q_start:q_end],
                                            genome_seq, alt_seq)
                       if r != g and r != a)
        tags.append(f"XW:i:{bothdiff}")
        tags.append(f"XV:i:{nm - bothdiff}")
    flag = 16 if strand else 0
    q = qual or "*"
    if strand and qual:
        q = qual[::-1]
    cigar = ((f"{q_start}S" if q_start else "")
             + f"{q_end - q_start}M"
             + (f"{L - q_end}S" if L - q_end else ""))
    return SamRecord(
        qname=qname, flag=flag, rname=rname, pos=chrpos + 1, mapq=mapq,
        cigar=cigar, seq=oriented, qual=q, tags=tags)


def extend_soft_clips(db: GenomeDB, rec: SamRecord) -> None:
    """gsnap --extend-soft-clips (src/gsnap.c:698): convert terminal soft
    clips back to M and recompute MD/NM over the extended span."""
    if rec.flag & 4 or rec.cigar == "*":
        return
    ops = _cigar_ops(rec.cigar)
    if not any(op == "S" for _n, op in ops):
        return
    if ops and ops[0][1] == "S":
        n = ops.pop(0)[0]
        if rec.pos - 1 - n < 0:
            n_fit = rec.pos - 1
        else:
            n_fit = n
        ops.insert(0, (n_fit, "M"))
        if n_fit < n:
            ops.insert(0, (n - n_fit, "S"))
        rec.pos -= n_fit
    if ops and ops[-1][1] == "S":
        n = ops.pop(-1)[0]
        chrlen = db.chrom_length(db.chrom_names.index(rec.rname))
        span = rec.pos - 1 + sum(m for m, op in ops if op in "MDN=X")
        n_fit = min(n, chrlen - span)
        ops.append((n_fit, "M"))
        if n_fit < n:
            ops.append((n - n_fit, "S"))
    # merge adjacent M runs
    merged: list[tuple[int, str]] = []
    for n, op in ops:
        if merged and merged[-1][1] == op:
            merged[-1] = (merged[-1][0] + n, op)
        else:
            merged.append((n, op))
    rec.cigar = "".join(f"{n}{op}" for n, op in merged)
    recompute_md(db, rec)


# --- SAM output post-processing (reference SAM-option flags) ----------------

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")


def _cigar_ops(cigar: str):
    return [(int(n), op) for n, op in _CIGAR_RE.findall(cigar)]


def extended_cigar(cigar: str, md: str) -> str:
    """Rewrite M runs as =/X runs using the MD string
    (gsnap --sam-extended-cigar, src/gsnap.c:702)."""
    if cigar == "*" or "M" not in cigar:
        return cigar
    stream = []                     # '='/'X' per M-consumed genome base
    for t in re.findall(r"\d+|\^[A-Za-z]+|[A-Za-z]", md):
        if t[0] == "^":
            continue                # deletion bases belong to D ops
        if t.isdigit():
            stream.extend("=" * int(t))
        else:
            stream.append("X")
    out, k = [], 0
    for n, op in _cigar_ops(cigar):
        if op != "M":
            out.append(f"{n}{op}")
            continue
        j = 0
        while j < n:
            ch = stream[k] if k < len(stream) else "="
            run = 0
            while j < n and (stream[k] if k < len(stream) else "=") == ch:
                run += 1
                j += 1
                k += 1
            out.append(f"{run}{ch}")
    return "".join(out)


def strip_zero_m(cigar: str) -> str:
    """Remove 0M entries (gsnap --sam-use-0M=0)."""
    ops = [(n, op) for n, op in _cigar_ops(cigar) if not (n == 0 and op == "M")]
    return "".join(f"{n}{op}" for n, op in ops) or "*"


def cigar_query_length(cigar: str) -> int:
    """Query bases consumed by the CIGAR (M/I/S/=/X)."""
    return sum(n for n, op in _cigar_ops(cigar) if op in "MIS=X")


def check_cigar(rec: SamRecord, action: str = "warning") -> bool:
    """--action-if-cigar-error: verify CIGAR length against SEQ length.
    Returns False if the record should not be printed."""
    if rec.cigar == "*" or rec.seq == "*":
        return True
    if cigar_query_length(rec.cigar) == len(rec.seq):
        return True
    if action == "ignore":
        return True
    if action == "warning":
        sys.stderr.write(f"warning: CIGAR length disagrees with sequence "
                         f"length for {rec.qname}\n")
        return True
    if action == "noprint":
        rec.cigar = "*"
        return True
    raise ValueError(f"CIGAR length disagrees with sequence length for "
                     f"{rec.qname}")


def apply_sam_options(rec: SamRecord, extended_cigar_p: bool = False,
                      use_0m: bool = True, force_xs_dir: bool = False,
                      sparse_secondaries: bool = False,
                      multiple_primaries: bool = False,
                      cigar_action: str = "warning") -> SamRecord:
    """Apply output-shaping SAM flags to a record and its secondaries."""
    all_recs = [rec] + list(rec.secondaries or ())
    prim_nm = next((t for t in rec.tags if t.startswith("NM:i:")), None)
    for r in all_recs:
        if extended_cigar_p:
            mdv = next((t[5:] for t in r.tags if t.startswith("MD:Z:")), "")
            r.cigar = extended_cigar(r.cigar, mdv)
        if not use_0m:
            r.cigar = strip_zero_m(r.cigar)
        if force_xs_dir:
            r.tags = [t if t != "XS:A:?" else "XS:A:+" for t in r.tags]
        check_cigar(r, cigar_action)
    for r in all_recs[1:]:
        if (multiple_primaries and prim_nm is not None
                and prim_nm in r.tags):
            r.flag &= ~0x100
        if sparse_secondaries and r.flag & 0x100:
            r.seq, r.qual = "*", "*"
    return rec


# --- paired-end overlap handling (--clip-overlap / --merge-overlap) ---------

def ref_consumed(cigar: str) -> int:
    """Reference bases consumed by the CIGAR (M/D/N/=/X)."""
    return sum(n for n, op in _cigar_ops(cigar) if op in "MDN=X")


def _univ(db: GenomeDB, rec: SamRecord) -> int:
    return int(db.chrom_offsets[db.chrom_names.index(rec.rname)]
               + rec.pos - 1)


def recompute_md(db: GenomeDB, rec: SamRecord) -> None:
    """Rebuild MD/NM tags from the record's CIGAR + position (used after
    CIGAR surgery so 'mismatches and the MD string reflect the clipped
    CIGAR', gsnap --extend-soft-clips help text)."""
    g = _univ(db, rec)
    qpos, parts_read, parts_genome, ops = 0, [], [], []
    for n, op in _cigar_ops(rec.cigar):
        if op in "M=X":
            parts_read.append(rec.seq[qpos:qpos + n])
            parts_genome.append(db.get_seq(g, n))
            ops.extend([0] * n)
            qpos += n
            g += n
        elif op == "I":
            parts_read.append(rec.seq[qpos:qpos + n])
            ops.extend([1] * n)
            qpos += n
        elif op == "D":
            parts_genome.append(db.get_seq(g, n))
            ops.extend([2] * n)
            g += n
        elif op == "N":
            g += n
        elif op == "S":
            qpos += n
    md, nm = md_nm_from_ops(ops, "".join(parts_read), "".join(parts_genome))
    rec.tags = [t for t in rec.tags
                if not (t.startswith("MD:Z:") or t.startswith("NM:i:"))]
    rec.tags = [f"NM:i:{nm}", f"MD:Z:{md}"] + rec.tags


def clip_record_left(rec: SamRecord, ref_clip: int) -> SamRecord | None:
    """Soft-clip the first `ref_clip` reference bases off an alignment
    (CIGAR + POS surgery). Returns None if nothing would remain."""
    ops = _cigar_ops(rec.cigar)
    lead_s = q_clip = 0
    remaining = ref_clip
    new_ops: list | None = None
    for idx, (n, op) in enumerate(ops):
        if remaining <= 0:
            new_ops = ops[idx:]
            break
        if op == "S":
            lead_s += n
        elif op in "M=X":
            take = min(n, remaining)
            q_clip += take
            remaining -= take
            if take < n:
                new_ops = [(n - take, op)] + ops[idx + 1:]
                break
        elif op == "I":
            q_clip += n
        elif op in "DN":
            take = min(n, remaining)
            remaining -= take
            if take < n:
                new_ops = [(n - take, op)] + ops[idx + 1:]
                break
    if new_ops is None:
        new_ops = []
    extra = 0                      # leading D/N after the cut: skip them
    while new_ops and new_ops[0][1] in "DN":
        extra += new_ops[0][0]
        new_ops.pop(0)
    if not any(op in "M=X" for _n, op in new_ops):
        return None
    total_s = lead_s + q_clip
    rec.cigar = ((f"{total_s}S" if total_s else "")
                 + "".join(f"{n}{op}" for n, op in new_ops))
    rec.pos += ref_clip + extra
    return rec


def clip_overlap_pair(db: GenomeDB, s1: SamRecord, s2: SamRecord) -> None:
    """gsnap --clip-overlap: when both ends of a pair align to
    overlapping reference intervals, soft-clip the overlap off the
    downstream record (the leftmost end keeps its bases).

    Note: dead code in the 2024-02-22 reference (Stage3pair_overlap is
    compiled out under `#ifdef TO_FIX`, path-print-sam.c:2011), so this
    implementation exceeds the reference."""
    if (s1.flag & 4) or (s2.flag & 4) or s1.rname != s2.rname:
        return
    low, high = (s1, s2) if s1.pos <= s2.pos else (s2, s1)
    end_low = low.pos + ref_consumed(low.cigar) - 1
    ov = end_low - high.pos + 1
    if ov <= 0:
        return
    if ov >= ref_consumed(high.cigar):
        ov = ref_consumed(high.cigar) - 1       # keep at least one base
        if ov <= 0:
            return
    if clip_record_left(high, ov) is not None:
        recompute_md(db, high)


def merge_overlap_pair(db: GenomeDB, s1: SamRecord,
                       s2: SamRecord) -> SamRecord | None:
    """gsnap --merge-overlap (beta in the reference too): overlapping
    FR ends merge into ONE single-end record spanning the union.
    Only simple all-M alignments merge; returns None otherwise.

    Note: in the 2024-02-22 reference this feature is dead code — the
    overlap computation and Pathpair_merge call sit inside `#ifdef
    TO_FIX` blocks that are never defined (path-print-sam.c:2011,2057),
    so reference gsnap prints both ends unmerged regardless of the
    flag.  This working all-M implementation therefore exceeds the
    reference; extending it to indel/spliced CIGARs has no oracle to
    match against."""
    if (s1.flag & 4) or (s2.flag & 4) or s1.rname != s2.rname:
        return None
    for r in (s1, s2):
        if _cigar_ops(r.cigar) != [(len(r.seq), "M")]:
            return None
    low, high = (s1, s2) if s1.pos <= s2.pos else (s2, s1)
    end_low = low.pos + len(low.seq) - 1
    end_high = high.pos + len(high.seq) - 1
    if high.pos > end_low + 1:
        return None                              # disjoint: nothing to merge
    span = max(end_low, end_high) - low.pos + 1
    seq = list(low.seq) + ["N"] * (span - len(low.seq))
    qual = (list(low.qual) + ["!"] * (span - len(low.seq))
            if low.qual != "*" else None)
    off = high.pos - low.pos
    for k, (b, q) in enumerate(zip(high.seq,
                                   high.qual if high.qual != "*"
                                   else "!" * len(high.seq))):
        p = off + k
        if p >= len(low.seq):                    # beyond read-1: read-2 wins
            seq[p] = b
            if qual is not None:
                qual[p] = q
    merged = SamRecord(
        qname=low.qname, flag=low.flag & 16, rname=low.rname, pos=low.pos,
        mapq=min(s1.mapq, s2.mapq), cigar=f"{span}M",
        seq="".join(seq), qual="".join(qual) if qual is not None else "*",
        tags=[])
    recompute_md(db, merged)
    return merged
