"""Learned indel table (Knownindels_T analog, src/knownindels.c +
src/path-learn.c Path_learn_indels).

Pass 1 of --two-pass collects indel sites from aligned CIGARs; pass 2
uses them to (a) run DP refinement on reads overlapping a known site
even when their mismatch count alone would not trigger it and (b) relax
the indel-endlength requirement for an indel placed AT a known site —
the reference's "allow an indel that would otherwise not be considered"
behavior. --indels-dump/--indels-read persist the table
(src/gsnap.c:655-658)."""
from __future__ import annotations

import re

import numpy as np

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")


class KnownIndels:
    def __init__(self, coords: np.ndarray, lengths: np.ndarray,
                 counts: np.ndarray):
        order = np.argsort(coords, kind="stable")
        self.coords = coords[order].astype(np.uint64)   # univcoord of site
        self.lengths = lengths[order].astype(np.int32)  # +ins / -del bases
        self.counts = counts[order].astype(np.int64)

    @property
    def nsites(self) -> int:
        return len(self.coords)

    @classmethod
    def from_sam(cls, db, records, min_support: int = 1) -> "KnownIndels":
        """Collect I/D sites from aligned records (Path_learn_indels)."""
        seen: dict[tuple[int, int], int] = {}
        chrom_index = {nm: i for i, nm in enumerate(db.chrom_names)}
        for rec in records:
            if rec.flag & 4 or rec.rname not in chrom_index:
                continue
            if "I" not in rec.cigar and "D" not in rec.cigar:
                continue
            g = (int(db.chrom_offsets[chrom_index[rec.rname]])
                 + rec.pos - 1)
            for n, op in _CIGAR_RE.findall(rec.cigar):
                n = int(n)
                if op == "I":
                    seen[(g, n)] = seen.get((g, n), 0) + 1
                elif op == "D":
                    seen[(g, -n)] = seen.get((g, -n), 0) + 1
                if op in "MDN=X":
                    g += n
        keys = [(c, ln) for (c, ln), ct in seen.items()
                if ct >= min_support]
        return cls(np.asarray([c for c, _ in keys], dtype=np.uint64),
                   np.asarray([ln for _, ln in keys], dtype=np.int32),
                   np.asarray([seen[k] for k in keys], dtype=np.int64))

    def any_in(self, lo: int, hi: int) -> bool:
        """Is there a known indel site with univcoord in [lo, hi)?"""
        i = int(np.searchsorted(self.coords, np.uint64(max(lo, 0))))
        return i < self.nsites and int(self.coords[i]) < hi

    def near(self, coord: int, slop: int = 3) -> bool:
        """Is `coord` within slop of a known site?"""
        i = int(np.searchsorted(self.coords,
                                np.uint64(max(coord - slop, 0))))
        return (i < self.nsites
                and int(self.coords[i]) <= coord + slop)

    def dump(self, path: str) -> None:
        np.savez(path if path.endswith(".npz") else path + ".npz",
                 coords=self.coords, lengths=self.lengths,
                 counts=self.counts)

    @classmethod
    def load(cls, path: str) -> "KnownIndels":
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        return cls(z["coords"], z["lengths"], z["counts"])
