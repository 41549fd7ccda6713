"""tpumap_torch-cmetindex / -atoiindex: mode-transformed k-mer indexes (the
port's copy of tpumap/cli/modeindex_cli.py, over the port's
GenomeDB.add_mode_index).

Equivalents of the reference's offline index transforms (src/cmetindex.c,
src/atoiindex.c): add bisulfite (C->T / G->A) or RNA-editing (A->G / T->C)
k-mer indexes to an existing database directory.
"""
from __future__ import annotations

import argparse
import sys

from tpumap_torch.index.build import GenomeDB

SPACES = {"cmet": ("ct", "ga"), "atoi": ("ag", "tc")}


def run(kind: str, argv=None):
    ap = argparse.ArgumentParser(prog=f"tpumap_torch-{kind}index")
    ap.add_argument("-D", "--dir", required=True, help="database directory")
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
    db = GenomeDB.load(args.dir)
    for space in SPACES[kind]:
        sys.stderr.write(f"building {space} index...\n")
        db.add_mode_index(space)
    db.save(args.dir)
    sys.stderr.write(f"added {SPACES[kind]} indexes to {args.dir}\n")


def main_cmet(argv=None):
    run("cmet", argv)


def main_atoi(argv=None):
    run("atoi", argv)


if __name__ == "__main__":
    run("cmet" if "cmet" in sys.argv[0] else "atoi")
