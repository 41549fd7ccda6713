"""The deployment's reference genome, made from the configuration's fixed
generator seed (never from a run's --seed): random bases with a planted
gene set whose introns carry canonical GT..AG motifs.

The gene model is tools/bench_data.py's (exons of 300, 25-40, 300 and
300 bp, introns of 200, 1,000, 5,000 or 20,000 bp), copied and
parameterised by the configuration's "genome" object."""
from __future__ import annotations

import hashlib
import json

import numpy as np

ACGT = bytes.maketrans(b"\x00\x01\x02\x03", b"ACGT")


def spec_key(spec: dict) -> str:
    """A short stable hash of a genome specification."""
    return hashlib.sha256(json.dumps(spec, sort_keys=True).encode()
                          ).hexdigest()[:16]


def gene_table(spec: dict) -> np.ndarray:
    """int64[n_genes, n_exons, 2]: each gene's (exon start, exon length),
    non-overlapping, one gene every `spacing` bases from `first`."""
    g = spec["genes"]
    rng = np.random.default_rng(g["seed"])
    n, spacing = g["count"], g["spacing"]
    exon_lens = g["exon_lens"]
    introns = np.asarray(g["introns"], dtype=np.int64)
    out = np.zeros((n, len(exon_lens), 2), dtype=np.int64)
    for i in range(n):
        pos = i * spacing + g["first"]
        for j, ln in enumerate(exon_lens):
            if isinstance(ln, list):
                ln = int(rng.integers(ln[0], ln[1] + 1))
            out[i, j] = (pos, ln)
            pos += ln + int(introns[int(rng.integers(0, len(introns)))])
    return out


def genome_codes(spec: dict) -> np.ndarray:
    """uint8[genome_bp] base codes (A=0, C=1, G=2, T=3) of the one
    contig, GT..AG at every planted intron's ends."""
    rng = np.random.default_rng(spec["seed"])
    codes = rng.integers(0, 4, spec["genome_bp"], dtype=np.uint8)
    genes = gene_table(spec)
    donor = (genes[:, :-1, 0] + genes[:, :-1, 1]).ravel()
    acc = genes[:, 1:, 0].ravel()
    codes[donor], codes[donor + 1] = 2, 3          # GT
    codes[acc - 2], codes[acc - 1] = 0, 2          # AG
    return codes


def codes_to_text(codes: np.ndarray) -> str:
    return codes.astype(np.uint8, copy=False).tobytes().translate(ACGT
                                                                  ).decode()


def genome_spec(cfg: dict) -> dict:
    """The genome part of a configuration: the contig's name and length,
    its generator seed and the planted genes."""
    return {"contig": cfg["contig"], "genome_bp": cfg["genome_bp"],
            "seed": cfg["genome_seed"], "genes": cfg["genes"]}
