"""Annotation-format converters: GFF3/GTF/PSL -> map-file text for
iit_store, plus VCF -> SNP map (the port's copy of
tpumap/cli/converters.py: pure text, verbatim but for the program
names).

Mirror of the reference Perl tools (util/gff3_splicesites.pl,
gff3_introns.pl, gff3_genes.pl, gtf_*.pl, psl_*.pl, vcf_iit.pl): each
reads an annotation file and prints iit_store FASTA-format map entries.
Output conventions (1-based inclusive coordinates):

* splicesites: ">GENE.TR.exonI/N chr:d..d+1 donor LEN" with d = last exon
  base, and ">GENE.TR.exonI+1/N chr:a-1..a acceptor LEN" with a = first
  base of the next exon; coordinates reversed on the minus strand
  (util/gff3_splicesites.pl.in:403-404,458-459).
* introns: ">GENE.TR.intronI/N chr:end..start" spanning last exon base ..
  first next-exon base (util/gff3_introns.pl.in:402).
* genes: ">transcript chr:start..end\\ngene_name gene_id\\n<exon lines>"
  (util/gff3_genes.pl.in:407-427) — the trindex input.
"""
from __future__ import annotations

import re
import sys
from dataclasses import dataclass, field


@dataclass
class Tx:
    transcript_id: str          # splicesites/introns label part 2 (feature ID)
    gene_label: str             # splicesites/introns label part 1 (gene ID)
    tx_label: str               # genes-format header label (transcript_id attr)
    gene_line2: str             # genes-format second line ("gene_name gene_id")
    chrom: str
    strand: str
    exons: list = field(default_factory=list)   # [(start, end)] 1-based

    def sorted_exons(self):
        """Exons in transcription order."""
        ex = sorted(self.exons)
        return ex[::-1] if self.strand == "-" else ex


def _attr_gff3(attrs: str) -> dict:
    out = {}
    for kv in attrs.strip().split(";"):
        kv = kv.strip()
        if "=" in kv:
            k, v = kv.split("=", 1)
            out[k] = v
    return out


def _attr_gtf(attrs: str) -> dict:
    out = {}
    for m in re.finditer(r'(\w+)\s+"([^"]*)"', attrs):
        out[m.group(1)] = m.group(2)
    return out


def parse_gff3(fh):
    """Yield Tx records from GFF3 (gene/mRNA|transcript/exon features).

    Label conventions follow the reference Perl tools: splicesites/introns
    use the gene/transcript feature IDs (util/gff3_splicesites.pl.in:59,74);
    the genes format uses GENCODE-style gene_id/gene_name/transcript_id
    attributes when present (util/gff3_genes.pl.in print_gene/print_coords),
    falling back to the IDs.
    """
    genes = {}       # gene ID -> (gene_name attr, gene_id attr)
    txs: dict[str, Tx] = {}
    order: list[str] = []
    for line in fh:
        if line.startswith("#") or not line.strip():
            continue
        cols = line.rstrip("\n").split("\t")
        if len(cols) < 9:
            continue
        chrom, _src, ftype, start, end, _score, strand, _phase, attrs = cols[:9]
        a = _attr_gff3(attrs)
        if ftype == "gene":
            gid = a.get("ID", "")
            genes[gid] = (a.get("gene_name", a.get("Name", gid)),
                          a.get("gene_id", gid))
        elif ftype in ("mRNA", "transcript") or ftype.endswith("RNA"):
            tid = a.get("ID", "")
            parent = a.get("Parent", "")
            gname, gid_attr = genes.get(parent, (parent or tid,
                                                 parent or tid))
            txs[tid] = Tx(transcript_id=tid, gene_label=parent or tid,
                          tx_label=a.get("transcript_id", tid),
                          gene_line2=f"{gname} {gid_attr}",
                          chrom=chrom, strand=strand)
            order.append(tid)
        elif ftype == "exon":
            for parent in a.get("Parent", "").split(","):
                if parent not in txs:
                    txs[parent] = Tx(transcript_id=parent,
                                     gene_label=parent, tx_label=parent,
                                     gene_line2=f"{parent} {parent}",
                                     chrom=chrom, strand=strand)
                    order.append(parent)
                txs[parent].exons.append((int(start), int(end)))
    for tid in order:
        if txs[tid].exons:
            yield txs[tid]


def parse_gtf(fh):
    """Yield Tx records from GTF (exon features grouped by transcript_id)."""
    txs: dict[str, Tx] = {}
    order: list[str] = []
    for line in fh:
        if line.startswith("#") or not line.strip():
            continue
        cols = line.rstrip("\n").split("\t")
        if len(cols) < 9 or cols[2] != "exon":
            continue
        chrom, _s, _f, start, end, _sc, strand, _ph, attrs = cols[:9]
        a = _attr_gtf(attrs)
        tid = a.get("transcript_id", "")
        if tid not in txs:
            gid = a.get("gene_id", tid)
            gname = a.get("gene_name")
            # gtf_genes second line = cat of gene_id and gene_name
            # (util/gtf_genes: cat_info("gene_id","gene_name"))
            line2 = f"{gid} {gname}" if gname else gid
            txs[tid] = Tx(transcript_id=tid, gene_label=gid,
                          tx_label=tid, gene_line2=line2,
                          chrom=chrom, strand=strand)
            order.append(tid)
        txs[tid].exons.append((int(start), int(end)))
    for tid in order:
        yield txs[tid]


def parse_psl(fh):
    """Yield Tx records from PSL alignments (qName = transcript)."""
    for line in fh:
        cols = line.rstrip("\n").split("\t")
        if len(cols) < 21 or not cols[0].isdigit():
            continue
        strand = cols[8][-1]
        qname, tname = cols[9], cols[13]
        sizes = [int(x) for x in cols[18].rstrip(",").split(",")]
        tstarts = [int(x) for x in cols[20].rstrip(",").split(",")]
        exons = [(ts + 1, ts + sz) for ts, sz in zip(tstarts, sizes)]
        yield Tx(transcript_id=qname, gene_label=qname, tx_label=qname,
                 gene_line2=qname, chrom=tname, strand=strand, exons=exons)


# ---------------------------------------------------------------------------
# emitters


def emit_splicesites(tx: Tx, out, ttype: str = "exon") -> None:
    ex = tx.sorted_exons()
    n = len(ex)
    base = f"{tx.gene_label}.{tx.transcript_id}.{ttype}"
    if tx.strand == "+":
        for i in range(n - 1):
            d = ex[i][1]                 # last exon base
            a = ex[i + 1][0]             # first base of next exon
            ilen = a - d - 1
            if ilen < 0:
                continue
            out.write(f">{base}{i + 1}/{n} {tx.chrom}:{d}..{d + 1} donor {ilen}\n")
            out.write(f">{base}{i + 2}/{n} {tx.chrom}:{a - 1}..{a} acceptor {ilen}\n")
    else:
        for i in range(n - 1):
            d = ex[i][0]                 # lowest coord of exon i (transcription order)
            a = ex[i + 1][1]
            ilen = d - a - 1
            if ilen < 0:
                continue
            out.write(f">{base}{i + 1}/{n} {tx.chrom}:{d}..{d - 1} donor {ilen}\n")
            out.write(f">{base}{i + 2}/{n} {tx.chrom}:{a + 1}..{a} acceptor {ilen}\n")


def emit_introns(tx: Tx, out, ttype: str = "exon") -> None:
    ex = tx.sorted_exons()
    n = len(ex)
    base = f"{tx.gene_label}.{tx.transcript_id}.intron"
    if tx.strand == "+":
        for i in range(n - 1):
            if ex[i + 1][0] - ex[i][1] - 1 >= 0:
                out.write(f">{base}{i + 1}/{n - 1} "
                          f"{tx.chrom}:{ex[i][1]}..{ex[i + 1][0]}\n")
    else:
        for i in range(n - 1):
            if ex[i][0] - ex[i + 1][1] - 1 >= 0:
                out.write(f">{base}{i + 1}/{n - 1} "
                          f"{tx.chrom}:{ex[i][0]}..{ex[i + 1][1]}\n")


def emit_genes(tx: Tx, out) -> None:
    ex = tx.sorted_exons()
    if tx.strand == "+":
        lo = ex[0][0]
        hi = ex[-1][1]
        out.write(f">{tx.tx_label} {tx.chrom}:{lo}..{hi}\n")
        out.write(tx.gene_line2 + "\n")
        for s, e in ex:
            out.write(f"{s} {e}\n")
    else:
        hi = ex[0][1]
        lo = ex[-1][0]
        out.write(f">{tx.tx_label} {tx.chrom}:{hi}..{lo}\n")
        out.write(tx.gene_line2 + "\n")
        for s, e in ex:
            out.write(f"{e} {s}\n")


def vcf_to_snps(fh, out) -> None:
    """VCF -> SNP map entries: >rsID chr:pos RA (ref/alt single bases),
    the vcf_iit/dbsnp_iit equivalent consumed by snpindex."""
    for line in fh:
        if line.startswith("#") or not line.strip():
            continue
        cols = line.rstrip("\n").split("\t")
        if len(cols) < 5:
            continue
        chrom, pos, rsid, ref, alts = cols[0], cols[1], cols[2], cols[3], cols[4]
        if len(ref) != 1:
            continue
        for alt in alts.split(","):
            if len(alt) == 1 and alt in "ACGT" and ref in "ACGT" and alt != ref:
                label = rsid if rsid != "." else f"{chrom}_{pos}_{ref}{alt}"
                out.write(f">{label} {chrom}:{pos} {ref}{alt}\n")


# ---------------------------------------------------------------------------
# CLI mains


def _converter_main(parser_fn, emit_fn, prog, argv=None):
    import argparse
    ap = argparse.ArgumentParser(prog=prog)
    ap.add_argument("input", nargs="?", help="annotation file (default stdin)")
    args = ap.parse_args(argv)
    fh = open(args.input) if args.input else sys.stdin
    for tx in parser_fn(fh):
        emit_fn(tx, sys.stdout)
    if args.input:
        fh.close()
    return 0


def gff3_splicesites_main(argv=None):
    return _converter_main(parse_gff3, emit_splicesites,
                           "tpumap_torch-gff3_splicesites", argv)


def gff3_introns_main(argv=None):
    return _converter_main(parse_gff3, emit_introns,
                           "tpumap_torch-gff3_introns", argv)


def gff3_genes_main(argv=None):
    return _converter_main(parse_gff3, lambda tx, out: emit_genes(tx, out),
                           "tpumap_torch-gff3_genes", argv)


def gtf_splicesites_main(argv=None):
    return _converter_main(parse_gtf, emit_splicesites,
                           "tpumap_torch-gtf_splicesites", argv)


def gtf_introns_main(argv=None):
    return _converter_main(parse_gtf, emit_introns,
                           "tpumap_torch-gtf_introns", argv)


def gtf_genes_main(argv=None):
    return _converter_main(parse_gtf, lambda tx, out: emit_genes(tx, out),
                           "tpumap_torch-gtf_genes", argv)


def psl_splicesites_main(argv=None):
    return _converter_main(parse_psl, emit_splicesites,
                           "tpumap_torch-psl_splicesites", argv)


def psl_introns_main(argv=None):
    return _converter_main(parse_psl, emit_introns,
                           "tpumap_torch-psl_introns", argv)


def psl_genes_main(argv=None):
    return _converter_main(parse_psl, lambda tx, out: emit_genes(tx, out),
                           "tpumap_torch-psl_genes", argv)


def vcf_iit_main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(prog="tpumap_torch-vcf_iit")
    ap.add_argument("input", nargs="?")
    args = ap.parse_args(argv)
    fh = open(args.input) if args.input else sys.stdin
    vcf_to_snps(fh, sys.stdout)
    if args.input:
        fh.close()
    return 0


# --- dbSNP / GVF / Ensembl / transcript-splicesites / MD converters ---------

_REVC = {"A": "T", "C": "G", "G": "C", "T": "A"}

# exception types explicitly known to util/dbsnp_iit.pl's %allowp table
# (all currently 0 = exclude); unknown types are excluded implicitly
_DBSNP_ALLOWP = {
    "RefAlleleMismatch": 0, "RefAlleleRevComp": 0, "DuplicateObserved": 0,
    "MixedObserved": 0, "FlankMismatchGenomeLonger": 0,
    "FlankMismatchGenomeEqual": 0, "FlankMismatchGenomeShorter": 0,
    "NamedDeletionZeroSpan": 0, "NamedInsertionNonzeroSpan": 0,
    "SingleClassLongerSpan": 0, "SingleClassZeroSpan": 0,
    "SingleClassTriAllelic": 0, "SingleClassQuadAllelic": 0,
    "ObservedWrongFormat": 0, "ObservedTooLong": 0,
    "ObservedContainsIupac": 0, "ObservedMismatch": 0,
    "MultipleAlignments": 0, "NonIntegerChromCount": 0,
    "AlleleFreqSumNot1": 0, "InconsistentAlleles": 0,
    "SingleAlleleFreq": 0,
}


def _snp_line(rsid, chrname, chrpos, a, b, strand):
    if strand == "-":
        a, b = _REVC[a], _REVC[b]
    snp_type = a + b if a <= b else b + a
    return f">{rsid} {chrname}:{chrpos} {snp_type} {strand}\n"


def dbsnp_iit_main(argv=None):
    """util/dbsnp_iit.pl: UCSC dbSNP flat file -> SNP IIT input
    ('>rsid chr:pos XY strand' lines for single-base SNPs)."""
    import argparse
    import sys
    ap = argparse.ArgumentParser(prog="tpumap_torch-dbsnp_iit")
    ap.add_argument("-c", dest="chr", default=None,
                    help="restrict to this chromosome")
    ap.add_argument("-w", dest="weight", type=int, default=1,
                    help="max item weight to accept (1=most confident)")
    ap.add_argument("-e", dest="exceptions", default=None,
                    help="UCSC exceptions file (rsids to exclude)")
    ap.add_argument("files", nargs="*", default=["-"])
    args = ap.parse_args(argv)

    exclude = set()
    if args.exceptions:
        import gzip
        op = gzip.open if args.exceptions.endswith(".gz") else open
        with op(args.exceptions, "rt") as fh:
            for line in fh:
                f = line.rstrip("\r\n").split("\t")
                if len(f) > 5 and _DBSNP_ALLOWP.get(f[5], 0) == 0:
                    exclude.add(f[4])

    def lines():
        for path in args.files:
            fh = sys.stdin if path == "-" else open(path)
            yield from fh
            if path != "-":
                fh.close()

    for line in lines():
        f = line.rstrip("\r\n").split("\t")
        if len(f) < 18 or f[11] != "single":
            continue
        chrname = f[1]
        if args.chr and chrname != args.chr:
            continue
        if int(f[17]) > args.weight:
            continue
        rsid = f[4]
        if rsid in exclude:
            continue
        if len(f) > 18 and f[18].strip() and any(
                _DBSNP_ALLOWP.get(e, 0) == 0
                for e in f[18].split(",") if e.strip()):
            continue
        obs = f[9]
        if (len(obs) == 3 and obs[1] == "/" and obs[0] in _REVC
                and obs[2] in _REVC):
            sys.stdout.write(_snp_line(rsid, chrname, int(f[2]) + 1,
                                       obs[0], obs[2], f[6]))
    return 0


def gvf_iit_main(argv=None):
    """util/gvf_iit.pl: GVF SNV records -> SNP IIT input."""
    import argparse
    import sys
    ap = argparse.ArgumentParser(prog="tpumap_torch-gvf_iit")
    ap.add_argument("files", nargs="*", default=["-"])
    args = ap.parse_args(argv)
    for path in args.files:
        fh = sys.stdin if path == "-" else open(path)
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\r\n").split("\t")
            if len(f) < 9 or f[2] != "SNV":
                continue
            rsid = alleleA = alleleB = None
            for item in f[8].split(";"):
                if item.startswith("Dbxref="):
                    rsid = item.split("=", 1)[1].split(":")[-1]
                elif item.startswith("Reference_seq="):
                    alleleA = item.split("=", 1)[1][:1]
                elif item.startswith("Variant_seq="):
                    alleleB = item.split("=", 1)[1][:1]
            strand = f[6]
            if (rsid is None or strand not in ("+", "=")
                    or alleleA not in _REVC or alleleB not in _REVC):
                continue
            a, b = alleleA, alleleB
            snp_type = a + b if a <= b else b + a
            sys.stdout.write(f">{rsid} {f[0]}:{f[3]} {snp_type} {strand}\n")
        if path != "-":
            fh.close()
    return 0


def ensembl_genes_main(argv=None):
    """util/ensembl_genes.pl: processed ensGene table -> genes IIT input
    (same row layout as the reference script: acc, chr:..., strand at
    col 3, exon count at col 6, starts/ends lists at cols 7/8, gene
    name at col 10)."""
    import argparse
    import sys
    ap = argparse.ArgumentParser(prog="tpumap_torch-ensembl_genes")
    ap.add_argument("-P", action="store_true",
                    help="remove 'chr' prefix from chromosome names")
    ap.add_argument("files", nargs="*", default=["-"])
    args = ap.parse_args(argv)
    for path in args.files:
        fh = sys.stdin if path == "-" else open(path)
        for line in fh:
            f = line.rstrip("\r\n").split("\t")
            if len(f) < 11:
                continue
            acc = f[0].lstrip(">")
            chrname = f[1].split(":")[0]
            if args.P:
                chrname = chrname.replace("chr", "", 1)
            strand = f[3]
            starts = [int(x) for x in f[7].split(",") if x]
            ends = [int(x) for x in f[8].split(",") if x]
            genename = f[10]
            if len(starts) != int(f[6]):
                sys.stderr.write(f"Reported number of exons {f[7]} != "
                                 f"observed {len(starts)}: Skipping "
                                 f"{line.rstrip()}\n")
                continue
            if strand == "+":
                sys.stdout.write(f">{acc} {chrname}:{starts[0] + 1}.."
                                 f"{ends[-1]}\n{genename}\n")
                for s, e in zip(starts, ends):
                    sys.stdout.write(f"{s + 1} {e}\n")
            elif strand == "-":
                starts_r = starts[::-1]
                ends_r = ends[::-1]
                sys.stdout.write(f">{acc} {chrname}:{ends_r[0]}.."
                                 f"{starts_r[-1] + 1}\n{genename}\n")
                for s, e in zip(starts_r, ends_r):
                    sys.stdout.write(f"{e} {s + 1}\n")
            else:
                sys.stderr.write("Strand is neither + nor -: Skipping "
                                 f"{line.rstrip()}\n")
        if path != "-":
            fh.close()
    return 0


def _gtf_info(attrs: str) -> dict:
    import re
    out = {}
    for m in re.finditer(r'(\S+) "([^"]+)";?|(\S+) ([^\s;]+);?', attrs):
        if m.group(1):
            out.setdefault(m.group(1), m.group(2))
        elif m.group(3):
            out.setdefault(m.group(3), m.group(4))
    return out


def gtf_transcript_splicesites_main(argv=None):
    """util/gtf_transcript_splicesites.pl (no -d mode): GTF exons ->
    TRANSCRIPT-coordinate donor/acceptor sites
    ('>gene.tr.exonI/N tr:q..q+1 donor 0 +chr@gpos')."""
    import argparse
    import sys
    ap = argparse.ArgumentParser(prog="tpumap_torch-gtf_transcript_splicesites")
    ap.add_argument("-E", action="store_true",
                    help="order exons by the exon_number attribute")
    ap.add_argument("files", nargs="*", default=["-"])
    args = ap.parse_args(argv)

    def flush(exons, gene, tid, chrname, strand, sortp):
        if not exons:
            return
        ex = sorted(exons) if sortp else exons
        qends, qstarts = [], []
        qpos = 0
        if strand == "-" and sortp:
            ex = ex[::-1]
        for s, e in ex:
            qstarts.append(qpos)
            qpos += e - s + 1
            qends.append(qpos)
        qstarts = qstarts[1:]
        qends = qends[:-1]
        n = len(ex)
        if strand == "-":
            # donor at the exon START, acceptor at the next exon's END
            don = [s for s, _ in ex][:-1]
            acc = [e for _, e in ex][1:]
            pre = "-"
        else:
            don = [e for _, e in ex][:-1]
            acc = [s for s, _ in ex][1:]
            pre = "+"
        for i in range(n - 1):
            sys.stdout.write(
                f">{gene}.{tid}.exon{i + 1}/{n} {tid}:{qends[i]}.."
                f"{qends[i] + 1} donor 0 {pre}{chrname}@{don[i]}\n")
            sys.stdout.write(
                f">{gene}.{tid}.exon{i + 2}/{n} {tid}:{qstarts[i]}.."
                f"{qstarts[i] + 1} acceptor 0 {pre}{chrname}@{acc[i]}\n")

    exons, gene, tid, chrname, strand, sortp = [], "", "", "", "+", False
    for path in args.files:
        fh = sys.stdin if path == "-" else open(path)
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\r\n").split("\t")
            if len(f) < 9 or f[2] != "exon":
                continue
            info = _gtf_info(f[8])
            t = info.get("transcript_id", "")
            if t != tid:
                flush(exons, gene, tid, chrname, strand, sortp)
                exons, sortp = [], False
                gene = info.get("gene_id", info.get("gene_name", ""))
                tid, chrname, strand = t, f[0], f[6]
            if args.E and "exon_number" in info:
                enum = int(info["exon_number"]) - 1
                while len(exons) <= enum:
                    exons.append(None)
                exons[enum] = (int(f[3]), int(f[4]))
            else:
                sortp = True
                exons.append((int(f[3]), int(f[4])))
        if path != "-":
            fh.close()
    flush(exons, gene, tid, chrname, strand, sortp)
    return 0


def md_coords_main(argv=None):
    """util/md_coords.pl, non-interactive subset: NCBI seq_contig.md ->
    gmap_build coords file. Columns are given via -c
    contig,chr,start,end,dir[,strain] (the reference's interactive
    column/strain detection is replaced by explicit flags)."""
    import argparse
    import sys
    ap = argparse.ArgumentParser(prog="tpumap_torch-md_coords")
    ap.add_argument("-c", dest="cols", required=True,
                    help="contig,chr,chrstart,chrend,dir[,strain] "
                         "0-based column numbers")
    ap.add_argument("-o", dest="out", default="coords.txt")
    ap.add_argument("--strain", default=None,
                    help="keep only rows of this strain (reference "
                         "strain)")
    ap.add_argument("mdfile")
    args = ap.parse_args(argv)
    cols = [int(x) for x in args.cols.split(",")]
    ccol, chcol, scol, ecol, dcol = cols[:5]
    stcol = cols[5] if len(cols) > 5 else None
    with open(args.mdfile) as fh, open(args.out, "w") as out:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\r\n").split("\t")
            if len(f) <= max(ccol, chcol, scol, ecol, dcol):
                continue
            if stcol is not None and args.strain and \
                    f[stcol] != args.strain:
                continue
            contig = f[ccol]
            chrname = f[chcol]
            try:
                s, e = int(f[scol]), int(f[ecol])
            except ValueError:
                continue
            if f[dcol] == "-":
                out.write(f"{contig}\t{chrname}:{e}..{s}\n")
            else:
                out.write(f"{contig}\t{chrname}:{s}..{e}\n")
    sys.stderr.write(f"Wrote {args.out}\n")
    return 0


_TOOLS = {
    "gff3_splicesites": lambda a: gff3_splicesites_main(a),
    "gff3_introns": lambda a: gff3_introns_main(a),
    "gff3_genes": lambda a: gff3_genes_main(a),
    "gtf_splicesites": lambda a: gtf_splicesites_main(a),
    "gtf_introns": lambda a: gtf_introns_main(a),
    "gtf_genes": lambda a: gtf_genes_main(a),
    "gtf_transcript_splicesites":
        lambda a: gtf_transcript_splicesites_main(a),
    "psl_splicesites": lambda a: psl_splicesites_main(a),
    "psl_introns": lambda a: psl_introns_main(a),
    "psl_genes": lambda a: psl_genes_main(a),
    "vcf_iit": lambda a: vcf_iit_main(a),
    "dbsnp_iit": lambda a: dbsnp_iit_main(a),
    "gvf_iit": lambda a: gvf_iit_main(a),
    "ensembl_genes": lambda a: ensembl_genes_main(a),
    "md_coords": lambda a: md_coords_main(a),
}


def main(argv=None):
    """Dispatcher: `python -m tpumap_torch.cli.converters <tool> [args...]`."""
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in _TOOLS:
        sys.stderr.write("usage: python -m tpumap_torch.cli.converters "
                         "<tool> [args...]\ntools: "
                         + " ".join(sorted(_TOOLS)) + "\n")
        return 0 if argv and argv[0] in ("-h", "--help") else 2
    return _TOOLS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
