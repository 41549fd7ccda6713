"""tpumap_torch-fa_coords: generate the coords file from genome FASTA.

Equivalent of util/fa_coords.pl: one line per contig mapping it into
chromosome coordinate space, linear/circular flag; golden-tested against
tests/coords1.test.ok.

The port's copy of tpumap/cli/fa_coords_cli.py: the same bytes out.
"""
from __future__ import annotations

import argparse
import sys

from tpumap_torch.cli._errors import clean_errors

from tpumap_torch.io.fasta import read_fasta

HEADER = (
    "# To rename a chromosome, edit each occurrence of that chromosome "
    "in the gmap_coordinates\n"
    "# The strain column has information copied from NCBI md files, but "
    "is not otherwise used by gmap_setup\n"
    "# To exclude a contig, place a '#' sign at the beginning of the "
    "line\n"
    "# The <primary> field means the primary segment for the given "
    "(altloc) contig\n"
    "#contig\tgmap_coordinates\tlinear/circular/<primary>\tstrain\n")


@clean_errors
def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    ap = argparse.ArgumentParser(prog="tpumap_torch-fa_coords")
    ap.add_argument("-o", "--output", help="output coords file")
    ap.add_argument("-c", "--circular", default="",
                    help="comma-separated circular chromosome names")
    ap.add_argument("fasta", nargs="+")
    args = ap.parse_args(argv)

    circular = set(filter(None, args.circular.split(",")))
    out = open(args.output, "w") if args.output else sys.stdout
    out.write(HEADER)
    for path in args.fasta:
        for rec in read_fasta(path):
            kind = "circular" if rec.accession in circular else "linear"
            out.write(f"{rec.accession}\t{rec.accession}:1.."
                      f"{len(rec.sequence)}\t{kind}\n")
    if args.output:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
