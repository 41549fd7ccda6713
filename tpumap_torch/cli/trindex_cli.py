"""tpumap_torch-trindex: build a transcriptome index for TGGA (the port's
copy of tpumap/cli/trindex_cli.py).

Equivalent of the reference trindex (src/trindex.c): takes a genes map
IIT (from gff3_genes/gtf_genes | iit_store) plus the genome db and writes
the transcriptome db under <genome_db_dir>/<db>.transcripts/<name>/.
"""
from __future__ import annotations

import argparse
import os
import sys

from tpumap_torch.cli._errors import clean_errors

from tpumap_torch.gsnap.transcriptome import build_transcriptome
from tpumap_torch.index.build import GenomeDB
from tpumap_torch.io.iit import IIT


@clean_errors
def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    ap = argparse.ArgumentParser(prog="tpumap_torch-trindex")
    ap.add_argument("-D", "--dir", required=True,
                    help="genome database directory")
    ap.add_argument("-c", "--transcriptome", required=True,
                    help="transcriptome index name")
    ap.add_argument("-k", "--kmer", type=int, default=0,
                    help="k-mer size (default: auto)")
    ap.add_argument("genes_iit", help="genes map IIT (gff3_genes | iit_store)")
    args = ap.parse_args(argv)

    db = GenomeDB.load(args.dir)
    iit = IIT.read(args.genes_iit)
    tr = build_transcriptome(db, iit, name=args.transcriptome, k=args.kmer)
    outdir = os.path.join(args.dir, f"{db.name}.transcripts",
                          args.transcriptome)
    tr.save(outdir)
    sys.stderr.write(
        f"Built transcriptome {args.transcriptome}: {tr.ntranscripts} "
        f"transcripts, {len(tr.exonbounds)} exons, "
        f"{tr.trdb.genome_length} bp -> {outdir}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
