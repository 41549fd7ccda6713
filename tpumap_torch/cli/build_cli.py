"""tpumap_torch-build: genome database construction (gmap_build equivalent;
the port's copy of tpumap/cli/build_cli.py).

One Python driver replaces the reference's Perl orchestration
(util/gmap_build.pl -> fa_coords/gmap_process/gmapindex -A/-G/-U/-N/-O/-P):
the db directory holds tpumap's on-disk format, which either package
loads.
"""
from __future__ import annotations

import argparse
import os
import sys

from tpumap_torch.cli._errors import clean_errors

from tpumap_torch.index.build import build_db


@clean_errors
def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    ap = argparse.ArgumentParser(prog="tpumap_torch-build")
    ap.add_argument("-D", "--dir", default=".", help="destination directory")
    ap.add_argument("-d", "--db", required=True, help="genome name")
    ap.add_argument("-k", "--kmer", type=int, default=0,
                    help="k-mer size for the genome index (<=16; default: "
                         "auto from genome size, 15 for >=1 Gbp)")
    ap.add_argument("-q", "--sampling", type=int, default=3,
                    help="k-mer sampling interval")
    ap.add_argument("-c", "--circular", default="",
                    help="comma-separated circular chromosome names")
    ap.add_argument("--write-genomecomp", action="store_true",
                    help="also write a reference-format .genomecomp file")
    ap.add_argument("fasta", nargs="+", help="genome FASTA file(s)")
    args = ap.parse_args(argv)

    circular = set(filter(None, args.circular.split(",")))
    k = args.kmer
    if k == 0:
        # auto-size: the dense offsets array has 4^k entries; pick the
        # smallest k whose k-mer space is ~16x the genome size (seed
        # specificity) capped at the reference default 15
        import math
        total = sum(os.path.getsize(f) for f in args.fasta)
        k = max(8, min(15, math.ceil(math.log(max(total, 2) * 16, 4))))
        sys.stderr.write(f"Auto-selected k={k} for ~{total} bp genome "
                         f"(override with -k)\n")
    db = build_db(args.fasta, name=args.db, k=k,
                  interval=args.sampling, circular=circular)
    dbdir = os.path.join(args.dir, args.db)
    db.save(dbdir)
    if args.write_genomecomp:
        db.write_genomecomp(os.path.join(dbdir, f"{args.db}.genomecomp"))
    total = db.genome_length
    sys.stderr.write(
        f"Built {args.db}: {len(db.chrom_names)} contigs, {total} bp, "
        f"k={db.k}/q{db.interval}, {len(db.positions)} indexed positions "
        f"-> {dbdir}\n")


if __name__ == "__main__":
    sys.exit(main())
