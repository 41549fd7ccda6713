"""GFF3 printers for spliced alignments.

The port's copy of tpumap/io/gff3.py, unchanged but for its imports.

Byte-format analog of the reference's GFF3 output (src/pair.c
Pair_print_gff3: gene format -f 2, match_cdna format -f 3), driven from an
ExonChain instead of a Pair_T array. Coordinates are 1-based inclusive.
"""
from __future__ import annotations

from tpumap_torch.gmap.engine import ExonChain
from tpumap_torch.gmap.translation import best_orf

DIR_NAMES = {1: "sense", -1: "antisense", 0: "indeterminate"}


def _pct(matches: int, total: int) -> str:
    if total == 0:
        return "100"
    # reference prints exon score as integer percent (pair.c gff3 exon rows)
    return str(round(100 * matches / total))


def header(command_line: str = "") -> str:
    return ("##gff-version   3\n"
            f"# Generated by tpumap using call: {command_line}\n")


def _oriented_exons(chain: ExonChain, qlen: int):
    """Exons in original-query order with original-query Target coords.

    For minus-strand alignments the engine aligned the reverse complement;
    the reference reports exons in the original query's coordinate order
    (ascending Target, descending genomic), so map [qs, qe) ->
    [qlen - qe, qlen - qs) and reverse the listing.
    """
    if not chain.strand:
        return [(e, e.qstart + 1, e.qend) for e in chain.exons]
    qlen = qlen or max(e.qend for e in chain.exons)
    return [(e, qlen - e.qend + 1, qlen - e.qstart)
            for e in reversed(chain.exons)]


def _dirname(chain: ExonChain) -> str:
    # Dir is reported in the original query's orientation
    d = chain.cdna_direction * (-1 if chain.strand else 1)
    return DIR_NAMES[d]


def match_cdna(chain: ExonChain, query_acc: str, seqid: str, source: str,
               pathnum: int = 1, chrom_offset: int = 0,
               qlen: int = 0) -> str:
    """-f 3 (gff3_match_cdna) body for one path."""
    lines = []
    dirname = _dirname(chain)
    strand = "-" if chain.strand else "+"
    for e, t1, t2 in _oriented_exons(chain, qlen):
        gs, ge = e.gstart + 1 + chrom_offset, e.gend + chrom_offset
        total = e.qend - e.qstart
        attrs = (f"ID={query_acc}.path{pathnum};Name={query_acc};"
                 f"Dir={dirname};Target={query_acc} {t1} {t2};"
                 f"Gap=M{total}")
        lines.append("\t".join([seqid, source, "cDNA_match", str(gs), str(ge),
                                _pct(e.matches, total), strand, ".", attrs]))
    lines.append("###")
    return "\n".join(lines) + "\n"


def gene(chain: ExonChain, query_acc: str, seqid: str, source: str,
         query_codes=None, pathnum: int = 1, mrnanum: int = 1,
         chrom_offset: int = 0, qlen: int = 0) -> str:
    """-f 2 (gff3_gene) body for one path: gene/mRNA/exon/CDS rows.

    Presentation follows the reference (verified against oracle runs on
    all strand/direction combinations): the gene is reported on the
    TRANSCRIPT's genomic strand (aligned strand flipped when the cDNA
    direction is antisense); exons/CDS are listed in transcript order;
    Target coordinates are in the original query's space, suffixed '+'
    when the query is the sense sequence, '-' (exons) or '.' (CDS)
    otherwise.
    """
    lines = []
    dirname = _dirname(chain)
    eff = chain.cdna_direction * (-1 if chain.strand else 1)
    presented_minus = bool(chain.strand) ^ (eff == -1)
    strand = "-" if presented_minus else "+"
    g_lo = min(e.gstart for e in chain.exons) + 1 + chrom_offset
    g_hi = max(e.gend for e in chain.exons) + chrom_offset
    qlen = qlen or max(e.qend for e in chain.exons)
    path_id = f"{query_acc}.path{pathnum}"
    mrna_id = f"{query_acc}.mrna{mrnanum}"
    lines.append("\t".join([seqid, source, "gene", str(g_lo), str(g_hi), ".",
                            strand, ".",
                            f"ID={path_id};Name={query_acc};Dir={dirname}"]))
    total_span = sum(e.qend - e.qstart for e in chain.exons)
    coverage = 100.0 * total_span / qlen if qlen else 0.0
    ident = (100.0 * chain.matches / max(chain.matches + chain.mismatches, 1))
    lines.append("\t".join([
        seqid, source, "mRNA", str(g_lo), str(g_hi), ".", strand, ".",
        f"ID={mrna_id};Name={query_acc};Parent={path_id};Dir={dirname};"
        f"coverage={coverage:.1f};identity={ident:.1f};"
        f"matches={chain.matches};mismatches={chain.mismatches};"
        f"indels=0;unknowns=0"]))
    def orig_span(qs, qe):
        """aligned-space [qs, qe) -> original-query 1-based inclusive."""
        if chain.strand:
            return qlen - qe + 1, qlen - qs
        return qs + 1, qe

    # transcript order = genomic ascending on '+', descending on '-'
    tx_exons = list(chain.exons) if not presented_minus else list(
        reversed(chain.exons))
    exon_sign = "+" if eff >= 0 else "-"
    for i, e in enumerate(tx_exons, 1):
        gs, ge = e.gstart + 1 + chrom_offset, e.gend + chrom_offset
        total = e.qend - e.qstart
        t1, t2 = orig_span(e.qstart, e.qend)
        lines.append("\t".join([
            seqid, source, "exon", str(gs), str(ge),
            _pct(e.matches, total), strand, ".",
            f"ID={mrna_id}.exon{i};Name={query_acc};Parent={mrna_id};"
            f"Target={query_acc} {t1} {t2} {exon_sign}"]))
    # CDS rows from the best ORF of the SENSE transcript
    if query_codes is not None and len(query_codes):
        sense_codes = query_codes if eff >= 0 else (3 - query_codes)[::-1]
        orf_s, orf_e, _aa = best_orf(sense_codes)
        # sense space == aligned space iff the gene presents on '+'
        if presented_minus:
            a_s, a_e = qlen - orf_e, qlen - orf_s
        else:
            a_s, a_e = orf_s, orf_e
        cds_sign = "+" if eff >= 0 else "."
        cdsnum = 0
        consumed = 0
        for e in tx_exons:
            lo = max(e.qstart, a_s)
            hi = min(e.qend, a_e)
            if hi <= lo:
                continue
            cdsnum += 1
            # the reference prints cumulative-bases mod 3 here, not the
            # spec's "bases to skip" phase — match its convention
            phase = consumed % 3
            consumed += hi - lo
            gs = e.gstart + (lo - e.qstart) + 1 + chrom_offset
            ge = e.gstart + (hi - e.qstart) + chrom_offset
            o1, o2 = orig_span(lo, hi)
            lines.append("\t".join([
                seqid, source, "CDS", str(gs), str(ge),
                _pct(e.matches, e.qend - e.qstart), strand, str(phase),
                f"ID={mrna_id}.cds{cdsnum};Name={query_acc};Parent={mrna_id};"
                f"Target={query_acc} {o1} {o2} {cds_sign}"]))
    lines.append("###")
    return "\n".join(lines) + "\n"
