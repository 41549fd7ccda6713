"""BLAST m8 tabular output (GSNAP -A m8).

Format analog of src/path-print-m8.c (Path_print_m8): 12 tab fields with
Karlin-Altschul E-value/bitscore using the reference's constants
(k=0.1, lambda=1.58, +1/-1 rescoring). The port's copy of
tpumap/io/m8.py.
"""
from __future__ import annotations

import math

from tpumap_torch.index.build import GenomeDB

K = 0.1
LAMBDA = 1.58


def _evalue(alignlength: int, nmismatches: int, genomesize: float) -> float:
    score = (alignlength - nmismatches) - nmismatches
    return K * alignlength * genomesize * math.exp(-LAMBDA * score)


def _bitscore(alignlength: int, nmismatches: int) -> float:
    score = (alignlength - nmismatches) - nmismatches
    return (score * LAMBDA - math.log(K)) / math.log(2.0)


def m8_line(db: GenomeDB, qname: str, diag: int, strand: int, qlen: int,
            nmismatches: int, qstart: int = 0, qend: int | None = None) -> str:
    qend = qend if qend is not None else qlen
    chrname, chrpos = db.chrpos(diag)
    alignlength = qend - qstart
    identity = 100.0 * (alignlength - nmismatches) / alignlength
    if strand == 0:
        s1 = chrpos + qstart + 1
        s2 = chrpos + qend
    else:
        s1 = chrpos + (qlen - qstart)
        s2 = chrpos + (qlen - qend) + 1
    ev = _evalue(alignlength, nmismatches, float(db.genome_length))
    bs = _bitscore(alignlength, nmismatches)
    return "\t".join([
        qname, chrname, f"{identity:.1f}", str(alignlength),
        str(nmismatches), "0", str(qstart + 1), str(qend),
        str(s1), str(s2), f"{ev:.2g}", f"{bs:.1f}"])
