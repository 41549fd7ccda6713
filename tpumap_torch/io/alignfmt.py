"""GMAP summary (-S) and alignment (-A) text formats.

Byte-format analog of the reference's default output (src/pair.c
Pair_print_pathsummary / Pair_print_alignment; golden:
tests/align.test.ok). The alignment is rendered over a unified column
stream: one column per aligned query/genome base plus a fixed marker per
intron (ngap donor bases, '...', ngap acceptor bases; '>>>...>>>' match
row; intron length centered in the query row), wrapped in wraplength-column
blocks of ruler / aa.g / genome / match / query / aa.c rows.

Minus-strand queries honor gmap -I/--invertmode (src/pair.c invertmode):
  0 (default)  cDNA shown in its original orientation; genome minus strand,
               coordinates descending (the stream is the reverse complement
               of the aligned stream)
  1            cDNA inverted; genome minus-strand text, ascending coords
  2            cDNA inverted; genome plus-strand text (the aligned stream)

The port's copy of tpumap/io/alignfmt.py, unchanged but for its imports:
the aa annotation reads the port's translation._ACTIVE, which
--translation-code sets.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from tpumap_torch.gmap.engine import ExonChain
from tpumap_torch.gmap.translation import best_orf, translate_codes
from tpumap_torch.utils import dna

BLOCK = 50
_COMP = str.maketrans("ACGTacgt", "TGCAtgca")


def make_ruler(block: int) -> str:
    r = ""
    for c in range(1, block + 1):
        if c % 10 == 5:
            r += "."
        elif c % 10 == 0:
            r += ":"
        else:
            r += " "
    return r


RULER = make_ruler(BLOCK)


def commafmt(n: int) -> str:
    return f"{n:,}"


@dataclass
class Column:
    gchar: str = " "
    qchar: str = " "
    mchar: str = " "
    gpos: int = -1       # 1-based genomic coordinate or -1
    qpos: int = -1       # 1-based query coordinate (displayed numbering)
    aag: str = " "
    aac: str = " "
    aanum: int = -1      # aa index if an aa letter sits here
    aapos: int = -1      # running aa_g count (reference pairs[i].aapos;
    #                      per-row margin numbers read this)
    marker: int = -1     # intron-marker group id (-1 = not a marker col)


def build_columns(chain: ExonChain, query_codes: np.ndarray,
                  region_codes: np.ndarray, genome_offset: int = 0,
                  orf=None, qpos_map=None, ngap: int = 3,
                  nolengths: bool = False, aa_dir: int = 1) -> list[Column]:
    """Column stream for one path, in ALIGNED orientation.

    query_codes: ALIGNED orientation codes. genome_offset: added to region
    coords for display (univcoord/chrpos base). orf: optional (qs, qe, aa)
    from best_orf on the aligned query. qpos_map: aligned 0-based query
    position -> displayed 1-based number (default q + 1).
    """
    qlen = len(query_codes)
    if qpos_map is None:
        qpos_map = lambda q: q + 1   # noqa: E731
    cols: list[Column] = []
    width = 2 * ngap + 3
    # amino acid placement: letter at the first base of each codon
    aag_by_q = {}
    aac_by_q = {}
    aanum_by_q = {}
    if orf is not None:
        orf_s, orf_e, _ = orf
        # genomic-side codes along the query positions
        gside = np.zeros(qlen, dtype=np.uint8)
        covered = np.zeros(qlen, dtype=bool)
        for e in chain.exons:
            gside[e.qstart:e.qend] = region_codes[e.gstart:e.gend]
            covered[e.qstart:e.qend] = True
        n_aa = (orf_e - orf_s) // 3
        for a in range(n_aa):
            if aa_dir > 0:
                qpos = orf_s + 3 * a
                if qpos + 2 >= qlen:
                    break
                cod = query_codes[qpos:qpos + 3]
                gcod = (gside[qpos:qpos + 3]
                        if covered[qpos:qpos + 3].all() else cod)
                aac_by_q[qpos] = translate_codes(cod)
                aag_by_q[qpos] = translate_codes(gcod)
            else:
                # codons read DESCENDING in aligned space (the original
                # cDNA orientation of a minus-strand hit); letter at the
                # reading-direction first base
                qpos = orf_e - 1 - 3 * a
                if qpos - 2 < 0:
                    break
                cod = dna.revcomp_codes(query_codes[qpos - 2:qpos + 1])
                gcod = (dna.revcomp_codes(gside[qpos - 2:qpos + 1])
                        if covered[qpos - 2:qpos + 1].all() else cod)
                aac_by_q[qpos] = translate_codes(cod)
                aag_by_q[qpos] = translate_codes(gcod)
            aanum_by_q[qpos] = a + 1

    for i, e in enumerate(chain.exons):
        if i > 0:
            prev = chain.exons[i - 1]
            ilen = e.gstart - prev.gend
            intr = chain.introns[i - 1] if i - 1 < len(chain.introns) \
                else None
            if intr is not None and intr.kind != "intron":
                # non-intron gaps render INLINE (INDEL_COMP columns,
                # src/pair.c:2314): deletion = genome base over '-' over
                # a space; insertion = space over '-' over the query base
                for j in range(prev.gend, e.gstart):      # deletion
                    cols.append(Column(
                        gchar=dna.BASES[region_codes[j]], qchar=" ",
                        mchar="-", gpos=j + 1 + genome_offset))
                for q in range(prev.qend, e.qstart):      # insertion
                    cols.append(Column(
                        gchar=" ", qchar=dna.BASES[query_codes[q]],
                        mchar="-", qpos=qpos_map(q),
                        aag=aag_by_q.get(q, " "), aac=aac_by_q.get(q, " "),
                        aanum=aanum_by_q.get(q, -1)))
            elif ilen > 0:
                label = "" if nolengths else str(ilen)
                pad = (width - len(label)) // 2
                lab = " " * pad + label + " " * (width - pad - len(label))
                gleft = [dna.BASES[region_codes[prev.gend + j]]
                         for j in range(ngap)] \
                    if prev.gend + ngap <= len(region_codes) else ["N"] * ngap
                gright = [dna.BASES[region_codes[e.gstart - ngap + j]]
                          for j in range(ngap)] \
                    if e.gstart - ngap >= 0 else ["N"] * ngap
                gchars = gleft + ["."] * 3 + gright
                gposs = ([prev.gend + 1 + j for j in range(ngap)] + [-1] * 3
                         + [e.gstart - ngap + 1 + j for j in range(ngap)])
                mrow = ">" * ngap + "..." + ">" * ngap
                for j in range(width):
                    cols.append(Column(gchar=gchars[j], qchar=lab[j],
                                       mchar=mrow[j],
                                       gpos=(gposs[j] + genome_offset
                                             if gposs[j] > 0 else -1),
                                       marker=i))
        for q in range(e.qstart, e.qend):
            g = e.gstart + (q - e.qstart)
            gc = dna.BASES[region_codes[g]]
            qc = dna.BASES[query_codes[q]]
            cols.append(Column(
                gchar=gc, qchar=qc, mchar="|" if gc == qc else " ",
                gpos=g + 1 + genome_offset, qpos=qpos_map(q),
                aag=aag_by_q.get(q, " "), aac=aac_by_q.get(q, " "),
                aanum=aanum_by_q.get(q, -1)))
    return cols


def annotate_aa_genomic(cols: list[Column], fulllength: bool = False):
    """Forward aa annotation per the reference's Translation_via_genomic
    (src/translation.c:1716): the ORF is found on the GENOME-side
    sequence of the alignment; aa.g letters follow the genome frame
    (deletion bases included, insertion columns skipped) and aa.c
    letters translate the cDNA in ITS OWN frame from the same start,
    ending at the cDNA's first stop — the two rows drift apart across
    frameshifting indels (mark_cdna_forward/terminate_cdna_forward).
    Margin numbers use the running aa_g count (pairs[i].aapos).

    Mutates cols; returns (orf, orf_display) for path_summary, or
    (None, None) when no translation exists."""
    from tpumap_torch.gmap.translation import _ACTIVE

    body = [c for c in cols if c.marker < 0]
    gcols = [c for c in body if c.gchar != " "]
    if len(gcols) < 3:
        return None, None
    code_of = {"A": 0, "C": 1, "G": 2, "T": 3}
    gcodes = np.array([code_of.get(c.gchar, 0) for c in gcols],
                      dtype=np.uint8)
    gs, ge, aa = best_orf(gcodes, fulllength=fulllength)
    nlet = (ge - gs) // 3
    letters = aa + ("*" if nlet == len(aa) + 1 else "")
    if not letters:
        return None, None
    for k, ch in enumerate(letters):
        if gs + 3 * k < len(gcols):
            gcols[gs + 3 * k].aag = ch
    aapos = 0
    for c in cols:
        if c.aag != " ":
            aapos += 1
        c.aapos = aapos
    # cDNA translation from the same start column, query frame, stop at
    # the first stop codon
    start_idx = body.index(gcols[gs])
    qseq = [c for c in body[start_idx:] if c.qchar != " "]
    ci = 0
    while ci + 3 <= len(qseq):
        codon = qseq[ci].qchar + qseq[ci + 1].qchar + qseq[ci + 2].qchar
        ch = _ACTIVE.get(codon, "X")
        qseq[ci].aac = ch
        ci += 3
        if ch == "*":
            break
    # translation query span: min/max querypos over aa.g letters
    # (deletion columns inherit the preceding query position), rightpos
    # = maxpos + 2 clamped (translation.c:1825-1829)
    lastq = 0
    minq = maxq = None
    qmax_seen = 0
    for c in cols:
        if c.qpos > 0:
            lastq = c.qpos - 1
            qmax_seen = max(qmax_seen, c.qpos)
        if c.aag != " ":
            q_eff = lastq
            minq = q_eff if minq is None else min(minq, q_eff)
            maxq = q_eff if maxq is None else max(maxq, q_eff)
    if minq is None:
        return None, None
    right = min(maxq + 2, qmax_seen - 1)
    orf = (minq, right + 1, aa)
    orf_display = (minq + 1, right + 1)
    return orf, orf_display


def _complement_cols(cols: list[Column]) -> None:
    for c in cols:
        c.gchar = c.gchar.translate(_COMP)
        if c.marker < 0:
            c.qchar = c.qchar.translate(_COMP)


def _reverse_cols(cols: list[Column], ngap: int,
                  nolengths: bool) -> list[Column]:
    """Reverse the stream (mode-0 minus display): complemented genome read
    descending; intron labels and match arrows re-rendered."""
    out = list(reversed(cols))
    for c in out:
        c.gchar = c.gchar.translate(_COMP)
        if c.marker < 0:
            c.qchar = c.qchar.translate(_COMP)
        else:
            c.mchar = {"<": ">", ">": "<"}.get(c.mchar, c.mchar)
    # re-render each marker group's label text left-to-right
    width = 2 * ngap + 3
    i = 0
    while i < len(out):
        if out[i].marker < 0:
            i += 1
            continue
        j = i
        while j < len(out) and out[j].marker == out[i].marker:
            j += 1
        group = out[i:j]
        label = ""
        if not nolengths:
            digits = "".join(ch for c in group for ch in c.qchar
                             if ch.isdigit())
            label = digits[::-1] if digits else ""
        pad = (width - len(label)) // 2
        lab = " " * pad + label + " " * (width - pad - len(label))
        for k, c in enumerate(group):
            c.qchar = lab[k] if k < len(lab) else " "
        i = j
    return out


def render_blocks(cols: list[Column], block: int = BLOCK,
                  margin: bool = True) -> str:
    ruler_s = make_ruler(block) if block != BLOCK else RULER
    out = []
    for start in range(0, len(cols), block):
        blk = cols[start:start + block]
        gnum = next((c.gpos for c in blk if c.gpos > 0), 0)
        qnum = next((c.qpos for c in blk if c.qpos > 0), 0)
        aagnum = next((c.aapos for c in blk if c.aag != " "), 0)
        aacnum = next((c.aapos for c in blk if c.aac != " "), 0)
        if aagnum <= 0 and aacnum <= 0:
            # legacy (query-frame) annotation: one shared number
            aagnum = next((c.aanum for c in blk if c.aanum > 0), 0)
            aacnum = aagnum
        # every row is a fixed-width buffer (15 + block) — the reference
        # keeps all trailing spaces; aa rows drop their prefix entirely
        # when the block contains no amino-acid letter
        if margin:
            ruler = f"{start:>14} " + ruler_s[:len(blk)]
            aagl = (f"aa.g{aagnum:>10} " if aagnum else " " * 15) + \
                "".join(c.aag for c in blk)
            genome = f"{gnum:>14} " + "".join(c.gchar for c in blk)
            match = " " * 15 + "".join(c.mchar for c in blk)
            query = f"{qnum:>14} " + "".join(c.qchar for c in blk)
            aacl = (f"aa.c{aacnum:>10} " if aacnum else " " * 15) + \
                "".join(c.aac for c in blk)
        else:
            ruler = ruler_s[:len(blk)]
            aagl = "".join(c.aag for c in blk)
            genome = "".join(c.gchar for c in blk)
            match = "".join(c.mchar for c in blk)
            query = "".join(c.qchar for c in blk)
            aacl = "".join(c.aac for c in blk)
        out.append("\n".join([ruler, aagl, genome, match, query, aacl]))
    return "\n\n".join(out) + "\n\n"


@dataclass
class _Block:
    """Display exon: pieces joined by non-intron junctions merged into
    one block (the reference's pairs-array exon, delimited by gapp pairs
    only — src/pair.c:2211)."""
    qstart: int
    qend: int
    gstart: int
    gend: int
    matches: int
    den: int        # match/mismatch + indel columns (src/pair.c:2316)


def _display_blocks(chain: ExonChain):
    """(blocks, introns-between-blocks) merging indel-joined pieces."""
    blocks: list[_Block] = []
    bintrons = []
    cur = None
    for i, e in enumerate(chain.exons):
        if cur is None:
            cur = _Block(e.qstart, e.qend, e.gstart, e.gend,
                         e.matches, e.qend - e.qstart)
        else:
            # join: indel columns between the previous piece and this one
            cur.den += (e.gstart - cur.gend) + (e.qstart - cur.qend)
            cur.den += e.qend - e.qstart
            cur.matches += e.matches
            cur.qend, cur.gend = e.qend, e.gend
        nxt = chain.introns[i] if i < len(chain.introns) else None
        if nxt is None or nxt.kind == "intron":
            blocks.append(cur)
            cur = None
            if nxt is not None:
                bintrons.append(nxt)
    if cur is not None:
        blocks.append(cur)
    return blocks, bintrons


def exon_summary_lines(chain: ExonChain, genome_offset: int = 0,
                       qlen: int = 0, view: str = "plus") -> str:
    """view: 'plus' (ascending), 'minus0' (reversed display: genome
    descending, query ascending original), or 'minus12' (aligned order,
    query numbering descending original)."""
    lines = []
    exons, introns = _display_blocks(chain)
    reversed_view = view == "minus0"
    order = (list(range(len(exons)))[::-1] if reversed_view
             else list(range(len(exons))))
    for row, i in enumerate(order):
        e = exons[i]
        # den counts indel columns too; pct floors (src/pair.c:2244)
        pct = (int(100 * e.matches // e.den) if e.den else 100)
        if view == "minus0":
            gl = f"{e.gend + genome_offset}-{e.gstart + 1 + genome_offset}"
            ql = f"({qlen - e.qend + 1}-{qlen - e.qstart})"
        elif view == "minus12":
            gl = f"{e.gstart + 1 + genome_offset}-{e.gend + genome_offset}"
            ql = f"({qlen - e.qstart}-{qlen - e.qend + 1})"
        else:
            gl = f"{e.gstart + 1 + genome_offset}-{e.gend + genome_offset}"
            ql = f"({e.qstart + 1}-{e.qend})"
        line = f"    {gl}  {ql}   {pct}%"
        # intron following this exon in DISPLAY order
        iidx = (i - 1) if reversed_view else i
        if 0 <= iidx < len(introns) and row < len(order) - 1:
            intr = introns[iidx]
            if intr.kind == "intron":
                d = chain.cdna_direction * (-1 if reversed_view else 1)
                arrow = {1: "->", -1: "<-", 0: "=="}[d]
                # probabilities print in display order: the reversed view
                # leads with the higher-coordinate (acceptor-in-aligned)
                # site, which is the donor read on the minus strand
                p1, p2 = ((intr.acceptor_prob, intr.donor_prob)
                          if reversed_view
                          else (intr.donor_prob, intr.acceptor_prob))
                line += (f" {arrow}   ...{intr.length}...  "
                         f"{p1:.3f}, {p2:.3f}")
        lines.append(line)
    return "\n".join(lines) + "\n"


def path_summary(chain: ExonChain, qlen: int, chrname: str | None,
                 genome_offset: int, pathnum: int = 1,
                 orf=None, aa_changes: str = "",
                 orf_display=None) -> str:
    minus = bool(chain.strand)
    g_lo = chain.exons[0].gstart + 1 + genome_offset
    g_hi = chain.exons[-1].gend + genome_offset
    q_lo = chain.exons[0].qstart + 1
    q_hi = chain.exons[-1].qend
    if minus:
        q_lo, q_hi = qlen - q_hi + 1, qlen - q_lo + 1
        g_lo, g_hi = g_hi, g_lo
    gspan = g_hi - g_lo + (-1 if minus else 1)
    strand = "-" if minus else "+"
    dirname = {1: "sense", -1: "antisense", 0: "indeterminate"}[
        chain.cdna_direction * (-1 if minus else 1)]
    matches, mm = chain.matches, chain.mismatches
    qind, tind = chain.qindels, chain.tindels
    denom = max(matches + mm + qind + tind, 1)   # src/pair.c:1410
    cov = 100.0 * (chain.exons[-1].qend - chain.exons[0].qstart) / max(qlen, 1)
    trimmed_len = chain.exons[-1].qend - chain.exons[0].qstart
    nexons = len(_display_blocks(chain)[0])
    lines = [
        f"  Path {pathnum}: query {q_lo}..{q_hi} ({qlen} bp) => genome "
        f"{commafmt(g_lo)}..{commafmt(g_hi)} ({gspan} bp)",
        f"    cDNA direction: {dirname}",
        (f"    Genomic pos: {chrname + ':' if chrname else ''}"
         f"{commafmt(g_lo)}..{commafmt(g_hi)} ({strand} strand)"),
        f"    Number of exons: {nexons}",
        f"    Coverage: {cov:.1f} (query length: {qlen} bp)",
        (f"    Trimmed coverage: {cov:.1f} (trimmed length: {trimmed_len} bp, "
         f"trimmed region: {q_lo}..{q_hi})"),
        (f"    Percent identity: {100.0 * matches / denom:.1f} "
         f"({matches} matches, {mm} mismatches, {qind + tind} indels,"
         f" 0 unknowns)"),
    ]
    if qind + tind > 0:      # src/pair.c:1419
        lines.append(
            f"    Non-intron gaps: {chain.qopens} openings, {qind} bases"
            f" in cdna; {chain.topens} openings, {tind} bases in genome")
    if orf is not None:
        orf_s, orf_e, aa = orf
        if orf_display is None:
            orf_display = (orf_s + 1, orf_e)
        lines.append(
            f"    Translation: {orf_display[0]}..{orf_display[1]} "
            f"({len(aa)} aa)")
        lines.append(f"    Amino acid changes: {aa_changes}")
    return "\n".join(lines) + "\n"


def print_alignment(header: str, chain: ExonChain, query_codes_aligned,
                    region_codes, qlen: int, chrname: str | None = None,
                    genome_offset: int = 0, summary_only: bool = False,
                    invertmode: int = 0, wraplength: int = BLOCK,
                    ngap: int = 3, nolengths: bool = False,
                    nomargin: bool = False, fulllength: bool = False,
                    cdsstart: int | None = None) -> str:
    """Full -A (or -S with summary_only) text for one query, one path."""
    minus = bool(chain.strand)
    aligned = np.asarray(query_codes_aligned)

    def _orf(codes):
        return best_orf(codes, fulllength=fulllength, cdsstart=cdsstart)

    aa_dir = 1
    if minus:
        # translate in the coding direction: sense-in-aligned uses the
        # aligned codes (reported descending in original numbering);
        # otherwise the original cDNA orientation (src/pair.c,
        # src/translation.c behavior observed on the reference)
        if chain.cdna_direction > 0:
            orf = _orf(aligned)
            orf_display = ((qlen - orf[0], qlen - orf[1] + 1)
                           if orf is not None else None)
            orf_for_cols = orf
        else:
            orig = dna.revcomp_codes(aligned)
            orf_orig = _orf(orig)
            orf_display = ((orf_orig[0] + 1, orf_orig[1])
                           if orf_orig is not None else None)
            # map the original-orientation ORF onto aligned coordinates:
            # codon at orig [s, s+3) = aligned [Q-s-3, Q-s)
            orf_for_cols = None
            if orf_orig is not None:
                s, e, aa = orf_orig
                orf_for_cols = (qlen - e, qlen - s, aa)
            orf = orf_orig
            aa_dir = -1
    elif cdsstart is not None:
        orf = _orf(aligned)
        orf_display = None
        orf_for_cols = orf
    else:
        # plus strand, no -a: reference-faithful genomic-frame
        # translation on the column stream (annotate_aa_genomic) — the
        # ORF and both aa rows come from the annotation below
        orf = orf_display = orf_for_cols = None
    qpos_map = (lambda q: qlen - q) if minus else None
    cols = build_columns(chain, aligned, np.asarray(region_codes),
                         genome_offset, orf=orf_for_cols,
                         qpos_map=qpos_map, ngap=ngap, nolengths=nolengths,
                         aa_dir=aa_dir)
    if not minus and cdsstart is None:
        orf, orf_display = annotate_aa_genomic(cols,
                                               fulllength=fulllength)
    parts = [f">{header}\n", "Paths (1):\n"]
    parts.append(path_summary(chain, qlen, chrname, genome_offset, orf=orf,
                              orf_display=orf_display))
    view = ("plus" if not minus
            else ("minus0" if invertmode == 0 else "minus12"))
    parts.append("\nAlignments:\n  Alignment for path 1:\n\n")
    parts.append(exon_summary_lines(chain, genome_offset, qlen=qlen,
                                    view=view))
    if summary_only:
        parts.append("\n")
        return "".join(parts)
    parts.append("\n")
    if minus:
        if invertmode == 0:
            cols = _reverse_cols(cols, ngap, nolengths)
        elif invertmode == 1:
            _complement_cols(cols)
        # invertmode 2: aligned stream as built
    parts.append(render_blocks(cols, block=wraplength,
                               margin=not nomargin))
    return "".join(parts)


def continuous_rows(chain: ExonChain, query_codes_aligned, region_codes,
                    qlen: int, genome_offset: int = 0,
                    invertmode: int = 0) -> list[Column]:
    """Column stream for the continuous formats (gmap -3/-4), honoring
    the minus-strand invertmode like print_alignment."""
    minus = bool(chain.strand)
    aligned = np.asarray(query_codes_aligned)
    qpos_map = (lambda q: qlen - q) if minus else None
    cols = build_columns(chain, aligned, np.asarray(region_codes),
                         genome_offset, orf=None, qpos_map=qpos_map)
    if minus:
        if invertmode == 0:
            cols = _reverse_cols(cols, 3, False)
        elif invertmode == 1:
            _complement_cols(cols)
    return cols


def continuous_fmt(header: str, chain: ExonChain, query_codes_aligned,
                   region_codes, qlen: int, genome_offset: int = 0,
                   invertmode: int = 0) -> str:
    """gmap -3: one genome/match/query row triple for the whole path
    (src/pair.c Pair_print_continuous)."""
    cols = continuous_rows(chain, query_codes_aligned, region_codes, qlen,
                           genome_offset, invertmode)
    g = "".join(c.gchar for c in cols)
    m = "".join(c.mchar for c in cols)
    q = "".join(c.qchar for c in cols)
    return f">{header}\n{g}\n{m}\n{q}\n"


def continuous_by_exon_body(chain: ExonChain, query_codes_aligned,
                            region_codes, qlen: int,
                            genome_offset: int = 0,
                            invertmode: int = 0) -> str:
    """gmap -4 body: three rows per exon (src/pair.c
    Pair_print_continuous_byexon)."""
    cols = continuous_rows(chain, query_codes_aligned, region_codes, qlen,
                           genome_offset, invertmode)
    # split at marker groups
    blocks, cur = [], []
    for c in cols:
        if c.marker >= 0:
            if cur:
                blocks.append(cur)
                cur = []
        else:
            cur.append(c)
    if cur:
        blocks.append(cur)
    parts = []
    for blk in blocks:
        g = "".join(c.gchar for c in blk)
        m = "".join(c.mchar for c in blk)
        q = "".join(c.qchar for c in blk)
        parts.append(f"{g}\n{m}\n{q}\n\n")
    return "".join(parts)


def coords_fmt(header: str, chain: ExonChain, query_codes_aligned,
               region_codes, qlen: int, genome_offset: int = 0) -> str:
    """gmap -f 9 (coords): one line per aligned base:
    'aaNum[ aaLetter]\\tqpos base\\tgpos gpos gbase\\t[aag]'
    (src/pair.c Pair_print_coordinates)."""
    aligned = np.asarray(query_codes_aligned)
    orf = best_orf(aligned)
    cols = build_columns(chain, aligned, np.asarray(region_codes),
                         genome_offset, orf=orf)
    parts = [f">{header}\n"]
    aanum = 0
    for c in cols:
        if c.marker >= 0 or c.qpos < 0:
            continue
        if c.aanum > 0:
            aanum = c.aanum
        aa_c = f"{aanum} {c.aac}" if c.aac != " " else f"{aanum}"
        aa_g = c.aag if c.aag != " " else ""
        parts.append(f"{aa_c}\t{c.qpos} {c.qchar}\t"
                     f"{c.gpos} {c.gpos} {c.gchar}\t{aa_g}\n")
    return "".join(parts)
