"""tpumap_torch-cat: concatenate genome databases.

Equivalent of the reference indexdb_cat/gmap_cat.pl (src/indexdb-cat.c:625,
util/gmap_cat.pl): merge several databases into one whose univcoord space
is the concatenation of the inputs. The k-mer index is merged by rebasing
each input's positions and re-stacking per-oligo position lists — no
re-scan of the genomes. Each input keeps its own sampling phase (when the
preceding total length is not a multiple of the sampling interval the
merged positions differ from a joint rebuild by that phase — harmless:
query oligos are read densely, so seeding is phase-agnostic).

The port's copy of tpumap/cli/cat_cli.py: the same bytes out.
"""
from __future__ import annotations

import argparse
import sys

from tpumap_torch.cli._errors import clean_errors

import numpy as np

from tpumap_torch.index.build import GenomeDB
from tpumap_torch.utils import dna


def cat_dbs(dbs: list[GenomeDB], name: str) -> GenomeDB:
    k = dbs[0].k
    interval = dbs[0].interval
    for d in dbs[1:]:
        if d.k != k or d.interval != interval:
            raise ValueError("all databases must share k and sampling "
                             f"interval (got k={d.k}/q{d.interval} vs "
                             f"k={k}/q{interval})")
    names, circ = [], []
    bases = []
    total = 0
    for d in dbs:
        if set(d.chrom_names) & set(names):
            raise ValueError("duplicate chromosome names across inputs")
        names.extend(d.chrom_names)
        circ.extend(list(d.circularp))
        bases.append(total)
        total += d.genome_length

    # genome: repack codes (inputs may not end on word boundaries)
    codes = np.concatenate([d.get_codes(0, d.genome_length) for d in dbs])
    nmask = np.concatenate(
        [d.get_nmask(0, d.genome_length).astype(bool) for d in dbs])
    chrom_offsets = np.zeros(len(names) + 1, dtype=np.uint64)
    i = 0
    for base, d in zip(bases, dbs):
        for c in range(len(d.chrom_names)):
            chrom_offsets[i] = base + int(d.chrom_offsets[c])
            i += 1
    chrom_offsets[-1] = total

    # k-mer index merge: per-oligo counts add; positions rebased and
    # stacked per oligo in input order (per-oligo lists stay sorted
    # because inputs are disjoint ascending coordinate ranges)
    counts = np.zeros(4 ** k, dtype=np.int64)
    for d in dbs:
        counts += np.diff(d.offsets.astype(np.int64))
    offsets = np.zeros(4 ** k + 1, dtype=np.uint32)
    offsets[1:] = np.cumsum(counts).astype(np.uint32)
    positions = np.zeros(int(counts.sum()), dtype=np.uint32)
    prev = np.zeros(4 ** k, dtype=np.int64)
    for base, d in zip(bases, dbs):
        dcounts = np.diff(d.offsets.astype(np.int64))
        dest_base = offsets[:-1].astype(np.int64) + prev
        excl = np.concatenate([[0], np.cumsum(dcounts)[:-1]])
        n = int(dcounts.sum())
        dest = (np.repeat(dest_base, dcounts)
                + (np.arange(n) - np.repeat(excl, dcounts)))
        positions[dest] = d.positions[:n] + np.uint32(base)
        prev += dcounts

    return GenomeDB(
        name=name, chrom_names=names, chrom_offsets=chrom_offsets,
        circularp=np.asarray(circ, dtype=bool),
        genome_packed=dna.pack_2bit(codes),
        genome_nmask=_pack_nmask(nmask),
        k=k, interval=interval, offsets=offsets, positions=positions)


def _pack_nmask(mask: np.ndarray) -> np.ndarray:
    n = (len(mask) + 31) // 32
    out = np.zeros(n * 32, dtype=np.uint32)
    out[:len(mask)] = mask.astype(np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    return (out.reshape(n, 32) << shifts).sum(axis=1, dtype=np.uint32)


@clean_errors
def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    ap = argparse.ArgumentParser(prog="tpumap_torch-cat")
    ap.add_argument("-d", "--db", required=True, help="output database name")
    ap.add_argument("-D", "--dir", default=".", help="output directory")
    ap.add_argument("inputs", nargs="+", help="input database directories")
    args = ap.parse_args(argv)

    dbs = [GenomeDB.load(p) for p in args.inputs]
    merged = cat_dbs(dbs, args.db)
    import os
    outdir = os.path.join(args.dir, args.db)
    merged.save(outdir)
    sys.stderr.write(
        f"Concatenated {len(dbs)} databases: {len(merged.chrom_names)} "
        f"contigs, {merged.genome_length} bp -> {outdir}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
