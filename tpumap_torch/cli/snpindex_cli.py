"""tpumap_torch-snpindex: make a genome database SNP-tolerant (the port's
copy of tpumap/cli/snpindex_cli.py).

Equivalent of the reference snpindex (src/snpindex.c): reads a SNP map
(.iit built from vcf_iit/dbsnp_iit output: ">label chr:pos RA" where R is
the reference allele and A the alternate) and augments the database with
an alternate genome + a SNP-tolerant k-mer index.
"""
from __future__ import annotations

import argparse
import sys

from tpumap_torch.cli._errors import clean_errors

import numpy as np

from tpumap_torch.index.build import GenomeDB
from tpumap_torch.io.iit import IIT
from tpumap_torch.utils import dna


def snps_from_iit(iit: IIT, db: GenomeDB):
    """Extract (univcoords, alt_codes) from a SNP map IIT; warns and skips
    entries whose stated reference allele disagrees with the genome."""
    chrom_off = {name: int(db.chrom_offsets[i])
                 for i, name in enumerate(db.chrom_names)}
    code = {b: i for i, b in enumerate("ACGT")}
    coords, alts, nbad = [], [], 0
    for idx in range(1, iit.total_nintervals + 1):
        divname, low, _high, _sign, typ = iit.interval(idx)
        if divname not in chrom_off or len(typ) != 2:
            continue
        ref, alt = typ[0].upper(), typ[1].upper()
        if ref not in code or alt not in code or ref == alt:
            continue
        coord = chrom_off[divname] + low - 1     # 1-based -> univcoord
        actual = db.get_seq(coord, 1)
        if actual != ref:
            nbad += 1
            continue
        coords.append(coord)
        alts.append(code[alt])
    if nbad:
        sys.stderr.write(f"Warning: {nbad} SNPs whose reference allele "
                         f"disagrees with the genome were skipped\n")
    return np.asarray(coords, dtype=np.int64), np.asarray(alts, dtype=np.uint8)


@clean_errors
def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    ap = argparse.ArgumentParser(prog="tpumap_torch-snpindex")
    ap.add_argument("-D", "--dir", required=True,
                    help="genome database directory")
    ap.add_argument("-v", "--snpsdb", default="snps",
                    help="name for the SNP set (informational)")
    ap.add_argument("snps_iit", help="SNP map IIT (vcf_iit | iit_store)")
    args = ap.parse_args(argv)

    db = GenomeDB.load(args.dir)
    iit = IIT.read(args.snps_iit)
    coords, alts = snps_from_iit(iit, db)
    n = db.add_snp_index(coords, alts)
    db.save(args.dir)
    sys.stderr.write(f"Applied {n} SNPs to {db.name}; SNP-tolerant index "
                     f"written to {args.dir}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
