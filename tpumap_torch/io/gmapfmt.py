"""Additional GMAP output formats: PSL, EST_match, splicesites/introns,
SAM (samse/sampe), exons (-E), protein (-P/-Q).

The port's copy of tpumap/io/gmapfmt.py, unchanged but for its imports.

Format analogs of the corresponding printers in src/pair.c
(Pair_print_pslformat_nt:7538, Pair_print_gff3 EST_match variant,
splicesites/introns map formats, Pair_print_sam:6537) — formats verified
against oracle runs on the HER2 fixture.
"""
from __future__ import annotations

import numpy as np

from tpumap_torch.gmap.engine import ExonChain
from tpumap_torch.gmap.translation import best_orf, translate_codes
from tpumap_torch.utils import dna


def _wrap(seq: str, width: int = 50) -> str:
    return "\n".join(seq[i:i + width] for i in range(0, len(seq), width))


def psl(chain: ExonChain, query_acc: str, qlen: int, tname: str, tsize: int,
        chrom_offset: int = 0) -> str:
    matches = chain.matches
    mismatches = chain.mismatches
    introns = [i for i in chain.introns if i.kind == "intron"]
    t_num_insert = len(introns)
    t_base_insert = sum(i.length for i in introns)
    strand = "-" if chain.strand else "+"
    q_start = chain.exons[0].qstart
    q_end = chain.exons[-1].qend
    if chain.strand:
        q_start, q_end = qlen - chain.exons[-1].qend, qlen - chain.exons[0].qstart
    t_start = chain.exons[0].gstart + chrom_offset
    t_end = chain.exons[-1].gend + chrom_offset
    sizes = ",".join(str(e.qend - e.qstart) for e in chain.exons) + ","
    qstarts = ",".join(str(e.qstart) for e in chain.exons) + ","
    tstarts = ",".join(str(e.gstart + chrom_offset) for e in chain.exons) + ","
    return "\t".join(map(str, [
        matches, mismatches, 0, 0, 0, 0, t_num_insert, t_base_insert,
        strand, query_acc, qlen, q_start, q_end, tname, tsize,
        t_start, t_end, len(chain.exons), sizes, qstarts, tstarts])) + "\n"


def est_match(chain: ExonChain, query_acc: str, seqid: str, source: str,
              qlen: int, chrom_offset: int = 0, pathnum: int = 1) -> str:
    """-f 4: one EST_match row with the full Gap series."""
    from tpumap_torch.io.gff3 import _dirname
    g_lo = chain.exons[0].gstart + 1 + chrom_offset
    g_hi = chain.exons[-1].gend + chrom_offset
    strand = "-" if chain.strand else "+"
    gaps = []
    for i, e in enumerate(chain.exons):
        gaps.append(f"M{e.qend - e.qstart}")
        if i < len(chain.introns):
            intr = chain.introns[i]
            if intr.kind == "intron":
                gaps.append(f"N{intr.length}")
    t1, t2 = 1, qlen
    total = chain.matches + chain.mismatches
    pct = str(round(100 * chain.matches / max(total, 1)))
    cov = 100.0 * (chain.exons[-1].qend - chain.exons[0].qstart) / max(qlen, 1)
    ident = 100.0 * chain.matches / max(total, 1)
    attrs = (f"ID={query_acc}.path{pathnum};Name={query_acc};"
             f"Dir={_dirname(chain)};Target={query_acc} {t1} {t2} +;"
             f"Gap={' '.join(gaps)};coverage={cov:.1f};identity={ident:.1f};"
             f"matches={chain.matches};mismatches={chain.mismatches};"
             f"indels=0;unknowns=0")
    return ("\t".join([seqid, source, "EST_match", str(g_lo), str(g_hi),
                       pct, strand, ".", attrs]) + "\n###\n")


def splicesites(chain: ExonChain, query_acc: str, chrname: str = "",
                chrom_offset: int = 0) -> str:
    """-f 6: GSNAP splicing-file donor/acceptor entries."""
    lines = []
    ne = len(chain.exons)
    for i, intr in enumerate(chain.introns):
        if intr.kind != "intron":
            continue
        e1, e2 = chain.exons[i], chain.exons[i + 1]
        lines.append(f">{query_acc}.exon{i + 1}/{ne} {chrname}:"
                     f"{e1.gend + chrom_offset}..{e1.gend + 1 + chrom_offset}"
                     f" donor {intr.length}")
        lines.append(f">{query_acc}.exon{i + 2}/{ne} {chrname}:"
                     f"{e2.gstart + chrom_offset}..{e2.gstart + 1 + chrom_offset}"
                     f" acceptor {intr.length}")
    return "\n".join(lines) + ("\n" if lines else "")


def introns_fmt(chain: ExonChain, query_acc: str, chrname: str = "",
                chrom_offset: int = 0) -> str:
    lines = []
    real = [i for i in chain.introns if i.kind == "intron"]
    ni = len(real)
    n = 0
    for i, intr in enumerate(chain.introns):
        if intr.kind != "intron":
            continue
        n += 1
        e1, e2 = chain.exons[i], chain.exons[i + 1]
        lines.append(f">{query_acc}.intron{n}/{ni} {chrname}:"
                     f"{e1.gend + chrom_offset}.."
                     f"{e2.gstart + 1 + chrom_offset}")
    return "\n".join(lines) + ("\n" if lines else "")


def sam_se(chain: ExonChain, query_acc: str, seq: str, qual: str | None,
           rname: str, chrom_offset: int = 0, qlen: int = 0,
           paired_flag: bool = False, npaths: int = 1,
           region_codes: np.ndarray | None = None) -> str:
    """-f samse / sampe: SAM with N-gapped CIGAR (ungapped exons)."""
    flag = (16 if chain.strand else 0) | (1 if paired_flag else 0)
    pos = chain.exons[0].gstart + 1 + chrom_offset
    cig = []
    lead = chain.exons[0].qstart
    if lead:
        cig.append(f"{lead}S")
    for i, e in enumerate(chain.exons):
        cig.append(f"{e.qend - e.qstart}M")
        if i < len(chain.introns):
            intr = chain.introns[i]
            if intr.kind == "intron":
                cig.append(f"{intr.length}N")
            elif intr.kind == "deletion":
                cig.append(f"{intr.length}D")
            else:
                cig.append(f"{intr.length}I")
    tail = qlen - chain.exons[-1].qend
    if tail:
        cig.append(f"{tail}S")
    oriented = dna.revcomp(seq) if chain.strand else seq
    # MD across exons
    if region_codes is not None:
        gseq = "".join(dna.BASES[region_codes[e.gstart + j]]
                       for e in chain.exons
                       for j in range(e.gend - e.gstart))
        from tpumap_torch.io.sam import md_and_nm
        md, nm = md_and_nm(
            oriented[chain.exons[0].qstart:chain.exons[-1].qend], gseq)
    else:
        md, nm = str(chain.matches), chain.mismatches
    mapq = 40 if npaths == 1 else 0
    xs = {1: "+", -1: "-"}.get(chain.cdna_direction, None)
    tags = [f"MD:Z:{md}", f"NH:i:{npaths}", "HI:i:1", f"NM:i:{nm}",
            f"SM:i:{mapq}", f"XQ:i:{mapq}", "X2:i:0", "XO:Z:UU"]
    if xs:
        tags.append(f"XS:A:{xs}")
    cols = [query_acc, str(flag), rname, str(pos), str(mapq), "".join(cig),
            "*", "0", "0", oriented, qual or "*"] + tags
    return "\t".join(cols) + "\n"


def exons_fmt(chain: ExonChain, header: str, query_codes_aligned: np.ndarray,
              region_codes: np.ndarray, genomic: bool = False,
              with_introns: bool = False) -> str:
    """-E cdna / genomic [+introns]."""
    orf_s, _, _ = best_orf(np.asarray(query_codes_aligned))
    parts = [f">{header}\n<path 1>\n"]
    for i, e in enumerate(chain.exons):
        if genomic:
            s = dna.decode(region_codes[e.gstart:e.gend])
        else:
            s = dna.decode(query_codes_aligned[e.qstart:e.qend])
        if i == 0:
            parts.append(f"<exon {i + 1}>\n{_wrap(s)}\n</exon>\n")
        else:
            phase = (e.qstart - orf_s) % 3
            parts.append(f"<exon {i + 1}, phase {phase}>\n{_wrap(s)}\n</exon>\n")
        if with_introns and i < len(chain.introns) and \
                chain.introns[i].kind == "intron":
            intr = dna.decode(
                region_codes[chain.exons[i].gend:chain.exons[i + 1].gstart])
            parts.append(f"<intron {i + 1}>\n{_wrap(intr)}\n</intron>\n")
    parts.append("</path>\n")
    return "".join(parts)


def protein_fmt(chain: ExonChain, header: str,
                query_codes_aligned: np.ndarray,
                region_codes: np.ndarray, genomic: bool = False, orf_kw=None) -> str:
    """-P (cDNA translation) / -Q (genomic translation)."""
    orf_s, orf_e, aa = best_orf(np.asarray(query_codes_aligned),
                                **(orf_kw or {}))
    if genomic:
        qlen = len(query_codes_aligned)
        gside = np.zeros(qlen, dtype=np.uint8)
        for e in chain.exons:
            gside[e.qstart:e.qend] = region_codes[e.gstart:e.gend]
        aa_full = translate_codes(gside[orf_s:orf_e])
        aa = aa_full[:-1] if aa_full.endswith("*") else aa_full
    return f">{header}\n{_wrap(aa)}\n"


def bedpe(chain: ExonChain, chrname: str, chrom_offset: int = 0,
          query_seq: str | None = None) -> str:
    """-f bedpe: one line per intron/deletion/insertion junction
    (src/pair.c Pair_print_bedpe:3868-4010): breakpoint pairs in BED
    half-open coordinates, type DELETION (intron or deletion; column 11 =
    gap length) or INSERTION (column 11 = inserted cDNA bases)."""
    lines = []
    for i, intr in enumerate(chain.introns):
        e1, e2 = chain.exons[i], chain.exons[i + 1]
        left_end = e1.gend + chrom_offset          # 1-based end == 0-based end-exclusive
        right_start = e2.gstart + chrom_offset + 1  # 1-based start
        if intr.kind in ("intron", "deletion"):
            lines.append(
                f"{chrname}\t{left_end - 1}\t{left_end}\t"
                f"{chrname}\t{right_start - 1}\t{right_start}\t"
                f"DELETION\t0\t+\t+\t{right_start - left_end - 1}")
        elif intr.kind == "insertion" and query_seq is not None:
            ins = query_seq[e1.qend:e2.qstart]
            lines.append(
                f"{chrname}\t{left_end - 1}\t{left_end}\t"
                f"{chrname}\t{right_start - 1}\t{right_start}\t"
                f"INSERTION\t0\t+\t+\t{ins}")
    return "".join(l + "\n" for l in lines)


def iit_map_fmt(chain, accession: str, header: str,
                chrname: str | None, chrom_offset: int = 0,
                exons: bool = False) -> str:
    """gmap -f 8 (map_ranges) / -f 7 (map_exons):
    '>acc chr:lo..hi' + query header line [+ per-exon 'lo hi' lines]
    (src/pair.c Pair_print_iit_map / Pair_print_iit_exon_map)."""
    lo = chain.exons[0].gstart + 1 + chrom_offset
    hi = chain.exons[-1].gend + chrom_offset
    if chain.strand:
        lo, hi = hi, lo
    out = [f">{accession} {chrname or ''}:{lo}..{hi}\n{header}\n"]
    if exons:
        es = chain.exons if not chain.strand else list(reversed(chain.exons))
        for e in es:
            a = e.gstart + 1 + chrom_offset
            b = e.gend + chrom_offset
            if chain.strand:
                a, b = b, a
            out.append(f"{a} {b}\n")
    return "".join(out)
