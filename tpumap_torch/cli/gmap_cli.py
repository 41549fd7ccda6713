"""tpumap_torch gmap: cDNA -> genome spliced alignment, the bulk path
(port of tpumap/cli/gmap_cli.py's -D/-d best-path run).

    python -m tpumap_torch.cli.gmap_cli -D DIR -d NAME [-f FMT] q.fa

-f takes 1 (psl), 2 (gff3_gene), 3 (gff3_match_cdna, the default) and
samse. The port runs tpumap's bulk path (its `-n 1`): stage 1 for a
batch of queries in one device pass, then the chain stage per window
bucket on the card and the host refinement. The run is on the card
unless --device cpu asks for the CPU. Every other option of tpumap's
gmap is not ported yet and raises NotImplementedError (ROADMAP.md item
14).
"""
from __future__ import annotations

import argparse
import sys
from collections import defaultdict
from dataclasses import replace

import numpy as np
import torch

from tpumap_torch.gmap import translation
from tpumap_torch.gmap.engine import (GmapConfig, _bucket,
                                      align_cdna_windows,
                                      align_cdna_windows_dispatch,
                                      align_cdna_windows_finish)
from tpumap_torch.gmap.stage1 import Stage1Config, find_regions_bulk
from tpumap_torch.index.build import GenomeDB
from tpumap_torch.index.device import DeviceIndex
from tpumap_torch.io import gff3, gmapfmt, sam
from tpumap_torch.io.fasta import read_fasta
from tpumap_torch.utils import dna

FORMATS = {"1": "psl", "psl": "psl", "2": "gff3_gene",
           "gff3_gene": "gff3_gene", "3": "gff3_match_cdna",
           "gff3_match_cdna": "gff3_match_cdna", "samse": "samse"}


def chain_goodness(chain) -> int:
    if chain is None:
        return -(10 ** 9)
    return chain.matches - 3 * chain.mismatches


def _filter_regions(regions, strand=None, chr_range=None):
    """gmap --strand / -c/--chrsubset: drop candidate regions on the
    wrong strand or outside the chromosome subset."""
    out = []
    for r in regions:
        if strand is not None and r[3] != strand:
            continue
        if chr_range is not None and not (chr_range[0] <= r[0]
                                          < chr_range[1]):
            continue
        out.append(r)
    return out


def align_queries_bulk(db: GenomeDB, index: DeviceIndex, encoded: list,
                       config: GmapConfig = GmapConfig(),
                       s1config: Stage1Config = Stage1Config(),
                       known=None, strand=None, chr_range=None):
    """Best path for many queries (tpumap gmap_cli.py:134-255): one
    stage-1 pass for the batch, then one chain pass per window-size
    bucket, all buckets dispatched before the first is refined on the
    host. Two rounds (the top region of each query, then the other
    regions of queries without a near-perfect path) and two
    repetitive-region retries (stage 1 keeping overabundant oligos, and
    the chain stage at max_occ 128 keeping them). Returns
    [(chain, univ_off) | None] parallel to encoded [(codes, nmask)]."""
    regions_per_q = [_filter_regions(regs, strand, chr_range)
                     for regs in find_regions_bulk(index, encoded,
                                                   s1config)]
    # a query whose every oligo is overabundant has no regions: retry
    # those keeping the first max_occ hits of each oligo
    noregion = [qi for qi, regs in enumerate(regions_per_q) if not regs]
    if noregion:
        s1_hi = replace(s1config, max_occ=64, keep_overabundant=True)
        retry = find_regions_bulk(index, [encoded[qi] for qi in noregion],
                                  s1_hi)
        for qi, regs in zip(noregion, retry):
            regions_per_q[qi] = _filter_regions(regs, strand, chr_range)

    def make_pair(qi, region):
        (gstart, gend, _w, strand) = region
        codes, nmask = encoded[qi]
        if strand:
            qq = dna.revcomp_codes(codes)
            nn = nmask[::-1]
        else:
            qq, nn = codes, nmask
        return (qq, nn, gstart, gend - gstart, strand)

    best = {}

    def run_round(work):            # work: list of (qi, region)
        # one device pass per window-size bucket, every bucket dispatched
        # before the first is refined on the host
        groups = defaultdict(list)
        for qi, r in work:
            groups[_bucket(r[1] - r[0])].append((qi, r))
        handles = []
        for _sz, subset in sorted(groups.items()):
            pairs = [make_pair(qi, r) for qi, r in subset]
            handles.append((subset, pairs, align_cdna_windows_dispatch(
                index, pairs, config)))
        for subset, pairs, h in handles:
            res = align_cdna_windows_finish(db, h, known=known)
            for (qi, _r), p, ch in zip(subset, pairs, res):
                if ch is None or not ch.exons:
                    continue
                if (qi not in best
                        or chain_goodness(ch) > chain_goodness(best[qi][0])):
                    best[qi] = (ch, p[2])

    # round 1: the top-weight region of each query; round 2 only for
    # queries without a near-perfect path there
    run_round([(qi, regs[0]) for qi, regs in enumerate(regions_per_q)
               if regs])
    rest = []
    for qi, regs in enumerate(regions_per_q):
        hit = best.get(qi)
        if hit is not None:
            qlen = len(encoded[qi][0])
            ch = hit[0]
            aligned = ch.matches + ch.mismatches
            if (ch.coverage >= 0.98 * qlen and aligned
                    and ch.matches >= 0.99 * aligned):
                continue
        rest.extend((qi, r) for r in regs[1:])
    if rest:
        run_round(rest)
    # a query with regions but no chain may have had every oligo over
    # the occupancy cap (tandem repeats): its top region again at a high
    # cap, keeping overabundant oligos
    missing = [qi for qi in range(len(encoded))
               if best.get(qi) is None and regions_per_q[qi]]
    if missing:
        cfg_hi = replace(config, max_occ=128, keep_overabundant=True)
        pairs = [make_pair(qi, regions_per_q[qi][0]) for qi in missing]
        res = align_cdna_windows(index, db, pairs, cfg_hi, known=known)
        for qi, p, ch in zip(missing, pairs, res):
            if ch is not None and ch.exons:
                best[qi] = (ch, p[2])
    return [best.get(qi) for qi in range(len(encoded))]


def passes_filters(chain, qlen, min_coverage, min_identity):
    """gmap --min-trimmed-coverage/--min-identity path filters."""
    if min_coverage > 0 and chain.coverage < min_coverage * qlen:
        return False
    aligned = chain.matches + chain.mismatches
    if min_identity > 0 and aligned and chain.matches < min_identity * aligned:
        return False
    return True


def _emit_db_hit(db, emit, fmt, rec, qcodes, chain, univ_off, source):
    chrom_idx = db.chrnum(univ_off + chain.exons[0].gstart)
    seqid = db.chrom_names[chrom_idx]
    chrom_offset = univ_off - int(db.chrom_offsets[chrom_idx])
    g_hi = chain.exons[-1].gend
    tsize = int(db.chrom_offsets[chrom_idx + 1]
                - db.chrom_offsets[chrom_idx])
    need_region = fmt in ("align", "summary", "samse", "sampe",
                          "protein_gen", "continuous",
                          "continuous_by_exon",
                          "coords") or fmt.startswith("exons:")
    emit(chain, rec, qcodes, seqid, source, chrom_offset,
         region_codes=db.get_codes(univ_off, g_hi + 16).astype(np.uint8)
         if need_region else None,
         chrname=seqid, tsize=tsize)


def _emitter(fmt: str, out):
    """tpumap main's emit for the ported formats: writes one path of a
    query to out."""
    def emit(chain, rec, qcodes, seqid, source, chrom_offset,
             region_codes=None, chrname=None, tsize=0):
        if fmt == "gff3_match_cdna":
            out.write(gff3.match_cdna(chain, rec.accession, seqid, source,
                                      chrom_offset=chrom_offset,
                                      qlen=len(qcodes)))
        elif fmt == "gff3_gene":
            out.write(gff3.gene(chain, rec.accession, seqid, source,
                                query_codes=qcodes,
                                chrom_offset=chrom_offset,
                                qlen=len(qcodes)))
        elif fmt == "psl":
            out.write(gmapfmt.psl(chain, rec.accession, len(qcodes), seqid,
                                  tsize, chrom_offset=chrom_offset))
        else:
            txt = gmapfmt.sam_se(chain, rec.accession, rec.sequence,
                                 rec.quality, seqid,
                                 chrom_offset=chrom_offset,
                                 qlen=len(qcodes),
                                 region_codes=region_codes)
            # tpumap re-parses each SAM line through its options; with
            # none given that is the identity and the CIGAR check
            for line in txt.splitlines():
                f = line.split("\t")
                sam.check_cigar(sam.SamRecord(f[0], int(f[1]), f[2],
                                              int(f[3]), int(f[4]), f[5],
                                              f[6], int(f[7]), int(f[8]),
                                              f[9], f[10], f[11:]))
            out.write(txt)
    return emit


def write_hits(db, fmt: str, out, source: str, recs, encoded, hits) -> None:
    """Write align_queries_bulk's hits of recs in fmt (psl, gff3_gene,
    gff3_match_cdna or samse), as tpumap's main does on its bulk path;
    queries without a hit print nothing."""
    emit = _emitter(fmt, out)
    for rec, (qcodes, _qn), hit in zip(recs, encoded, hits):
        if hit is None or not hit[0].exons:
            continue
        _emit_db_hit(db, emit, fmt, rec, qcodes, hit[0], hit[1], source)


def _not_ported(what: str):
    return NotImplementedError(
        f"tpumap_torch gmap: {what} is not ported yet (ROADMAP.md item "
        f"14); the port runs the -D/-d bulk path with -f 1, 2, 3 or samse")


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    ap = argparse.ArgumentParser(prog="tpumap_torch-gmap")
    ap.add_argument("-D", "--dir", help="genome database directory")
    ap.add_argument("-d", "--db", help="genome database name (informational)")
    ap.add_argument("-f", "--format", default=None,
                    help="1/psl, 2/gff3_gene, 3/gff3_match_cdna (default) "
                         "or samse")
    ap.add_argument("-n", "--npaths", type=int, default=1,
                    help="paths to report per query: 1, the bulk path "
                         "(tpumap's default of 5 is not ported yet)")
    ap.add_argument("--batch-size", "--input-buffer-size", dest="batch_size",
                    type=int, default=256, help="queries per device batch")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the index and the chain stage "
                         "(default cuda; cpu runs the plain versions)")
    ap.add_argument("queries", nargs="?", help="query FASTA")
    args, unknown = ap.parse_known_args(argv)
    if unknown:
        raise _not_ported(" ".join(unknown))
    if args.npaths != 1:
        raise _not_ported(f"-n {args.npaths}")
    if args.format is not None and args.format not in FORMATS:
        raise _not_ported(f"-f {args.format}")
    if args.dir is None or args.queries is None:
        ap.error("need -D and a query FASTA file")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("tpumap_torch-gmap: no CUDA device (pass "
                         "--device cpu to run the plain versions)")
    fmt = FORMATS[args.format or "3"]
    # tpumap's main sets the translation tables on every run
    translation.set_alt_start_codons(False)
    out = sys.stdout
    cmdline = "tpumap-gmap " + " ".join(argv)
    if fmt.startswith("gff3"):
        out.write(gff3.header(cmdline))
    db = GenomeDB.load(args.dir)
    index = DeviceIndex.from_host(db, device)
    source = args.db or db.name
    if fmt == "samse":
        out.write(sam.header(db, cmdline))

    recs = list(read_fasta(args.queries))
    config, s1config = GmapConfig(), Stage1Config()
    for bstart in range(0, len(recs), args.batch_size):
        group = recs[bstart:bstart + args.batch_size]
        encoded = [dna.encode(r.sequence) for r in group]
        write_hits(db, fmt, out, source, group, encoded,
                   align_queries_bulk(db, index, encoded, config, s1config))
    return 0


if __name__ == "__main__":
    sys.exit(main())
