"""SAM output (host side): the records of tpumap/io/sam.py that the
port emits, copied so its SAM stays byte-identical to tpumap's.

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


_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")


def _cigar_ops(cigar: str):
    return [(int(n), op) for n, op in _CIGAR_RE.findall(cigar)]


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
