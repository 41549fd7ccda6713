"""tpumap_torch-get-genome: extract genomic segments from a db (get-genome.c).

Output format matches the reference:
  >chr:start..end dbname:start..end
  sequence wrapped at 60 columns
Reverse-complement segments are requested as chr:end..start (start > end),
like the reference.

The port's copy of tpumap/cli/get_genome_cli.py: the same bytes out.
"""
from __future__ import annotations

import argparse
import re
import sys

from tpumap_torch.cli._errors import clean_errors

from tpumap_torch.index.build import GenomeDB
from tpumap_torch.utils import dna


def parse_region(db: GenomeDB, text: str):
    m = re.fullmatch(r"([^:]+):(\d+)(?:\.\.(\d+))?", text)
    if m:
        chrom, a, b = m.group(1), int(m.group(2)), m.group(3)
        b = int(b) if b else int(a)
    else:
        chrom, a, b = text, 1, None
    if chrom not in db.chrom_names:
        raise SystemExit(f"chromosome {chrom} not found")
    ci = db.chrom_names.index(chrom)
    clen = db.chrom_length(ci)
    if b is None:
        b = clen
    return chrom, int(db.chrom_offsets[ci]), a, b


@clean_errors
def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    ap = argparse.ArgumentParser(prog="tpumap_torch-get-genome")
    ap.add_argument("-D", "--dir", required=True)
    ap.add_argument("-d", "--db", help="database name (informational)")
    ap.add_argument("-m", "--map", dest="mapfile",
                    help="print entries of this map IIT overlapping the "
                         "region instead of the sequence "
                         "(get-genome -m, src/get-genome.c)")
    ap.add_argument("-S", "--snps", action="store_true",
                    help="print the SNP-substituted (genomealt) sequence")
    ap.add_argument("region", help="chr | chr:pos | chr:start..end "
                    "(start > end = reverse complement)")
    args = ap.parse_args(argv)
    db = GenomeDB.load(args.dir)
    chrom, coff, a, b = parse_region(db, args.region)

    if args.mapfile:
        from tpumap_torch.io.iit import IIT
        iit = IIT.read(args.mapfile if args.mapfile.endswith(".iit")
                       else args.mapfile + ".iit")
        lo, hi = (b, a) if a > b else (a, b)
        for idx in iit.get(chrom, lo, hi):
            sys.stdout.write(iit.header_line(int(idx)) + "\n")
            sys.stdout.write(iit.annotations[int(idx) - 1])
        return 0
    revcomp = a > b
    lo, hi = (b, a) if revcomp else (a, b)
    if args.snps:
        if db.genomealt_packed is None:
            raise SystemExit("-S requires a SNP-tolerant db "
                             "(tpumap_torch.cli.snpindex_cli)")
        seq = db.get_alt_seq(coff + lo - 1, hi - lo + 1)
    else:
        seq = db.get_seq(coff + lo - 1, hi - lo + 1)
    if revcomp:
        seq = dna.revcomp(seq)
    name = args.db or db.name
    sys.stdout.write(f">{chrom}:{a}..{b} {name}:{a}..{b}\n")
    for i in range(0, len(seq), 60):
        sys.stdout.write(seq[i:i + 60] + "\n")


if __name__ == "__main__":
    sys.exit(main())
