"""Transcriptome-guided alignment (TGGA): the L4c engine.

The reference aligns reads to a transcriptome-as-genome index first
(TR_EXACT1/TR_EXT methods, src/stage1hr-single.c:202-260,
src/transcriptome-search.c) and converts transcript-coordinate paths to
genome coordinates with the known exon structure (src/trpath-convert.c,
src/transcriptome.c Transcriptome_exons). A read solved on the
transcriptome gets its splice junctions for free — including multi-intron
reads — at exact-match cost, which is why "TGGA is many times faster than
regular genomic alignment" (reference README:1354).

TPU re-expression: the transcriptome is simply a second GenomeDB whose
"chromosomes" are transcripts (seed/verify kernels are reused unchanged);
coordinate conversion is a host-side exon-table walk producing multi-exon
SAM records. Built from a genes map IIT (gff3_genes | iit_store format:
header ">transcript chr:start..end", annotation line 1 "gene_name gene_id",
then per-exon "start end" lines, coords reversed for minus-strand genes —
util/gff3_genes.pl.in:407-427), the same input trindex consumes
(src/trindex.c:60-76).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from tpumap_torch.index.build import GenomeDB, build_db_from_seqs
from tpumap_torch.utils import dna


@dataclass
class Transcriptome:
    trdb: GenomeDB               # transcriptome-as-genome (contig = transcript)
    genome_name: str
    labels: list[str]            # transcript accessions (== trdb.chrom_names)
    genes: list[str]             # gene name per transcript
    chrnum: np.ndarray           # int32[T] chromosome index in the genome db
    strand: np.ndarray           # int8[T] gene strand +1/-1
    exon_offsets: np.ndarray     # int64[T+1] into the flat exon arrays
    # per exon, in transcription order:
    exonbounds: np.ndarray       # int64[E] cumulative transcript coord at exon end
    exonstarts: np.ndarray       # uint64[E] genomic univcoord (0-based) of the
    #                              exon base that is FIRST in transcription order
    exonlens: np.ndarray         # int64[E]

    @property
    def ntranscripts(self) -> int:
        return len(self.labels)

    def nexons(self, trnum: int) -> int:
        return int(self.exon_offsets[trnum + 1] - self.exon_offsets[trnum])

    # ------------------------------------------------------------------

    def map_to_genome(self, trnum: int, tstart: int, tlen: int):
        """Map transcript coords [tstart, tstart+tlen) to genome segments.

        Returns (segments, genome_strand_flip) where segments is a list of
        (genome_univcoord_leftmost, query_offset, seg_len) in GENOME order
        (ascending coordinates) and genome_strand_flip is True for
        minus-strand genes (the read maps to the genome as the reverse
        complement of its transcript orientation).

        The trpath-convert equivalent (src/trpath-convert.c): each exon
        crossed contributes one segment; adjacent exons imply the known
        introns.
        """
        lo = int(self.exon_offsets[trnum])
        hi = int(self.exon_offsets[trnum + 1])
        bounds = self.exonbounds[lo:hi]
        starts = self.exonstarts[lo:hi]
        lens = self.exonlens[lo:hi]
        minus = int(self.strand[trnum]) < 0

        segs = []
        t = tstart
        remaining = tlen
        # exon containing t: first bound > t
        e = int(np.searchsorted(bounds, t, side="right"))
        while remaining > 0 and e < len(bounds):
            ebase = int(bounds[e - 1]) if e > 0 else 0
            within = t - ebase                       # offset into exon e
            take = min(remaining, int(bounds[e]) - t)
            if minus:
                # transcription runs right-to-left on the genome: the
                # exon's first transcribed base is its HIGHEST coordinate
                gleft = int(starts[e]) - within - take + 1
            else:
                gleft = int(starts[e]) + within
            qoff = t - tstart
            segs.append((gleft, qoff, take))
            t += take
            remaining -= take
            e += 1
        if minus:
            # genome order = reverse of transcription order; query offsets
            # must be rewritten for the reverse-complemented read
            segs = [(g, tlen - (q + n), n) for (g, q, n) in segs][::-1]
        return segs, minus

    # ------------------------------------------------------------------

    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        self.trdb.save(os.path.join(directory, "trdb"))
        with open(os.path.join(directory, "meta.json"), "w") as f:
            json.dump({"genome_name": self.genome_name,
                       "labels": self.labels, "genes": self.genes}, f)
        np.savez(os.path.join(directory, "exons.npz"),
                 chrnum=self.chrnum, strand=self.strand,
                 exon_offsets=self.exon_offsets,
                 exonbounds=self.exonbounds,
                 exonstarts=self.exonstarts, exonlens=self.exonlens)

    @classmethod
    def load(cls, directory: str) -> "Transcriptome":
        with open(os.path.join(directory, "meta.json")) as f:
            meta = json.load(f)
        z = np.load(os.path.join(directory, "exons.npz"))
        return cls(trdb=GenomeDB.load(os.path.join(directory, "trdb")),
                   genome_name=meta["genome_name"],
                   labels=meta["labels"], genes=meta["genes"],
                   chrnum=z["chrnum"], strand=z["strand"],
                   exon_offsets=z["exon_offsets"],
                   exonbounds=z["exonbounds"],
                   exonstarts=z["exonstarts"], exonlens=z["exonlens"])


def build_transcriptome(db: GenomeDB, genes_iit, name: str = "tr",
                        k: int = 0, interval: int = 1) -> Transcriptome:
    """trindex equivalent: genes map IIT + genome db -> Transcriptome.

    Transcript sequences are extracted from the genome via the exon
    structure (so they match the genome exactly) and indexed as a second
    GenomeDB with one contig per transcript.
    """
    labels, genes, chrnums, strands = [], [], [], []
    exon_offsets = [0]
    exonbounds, exonstarts, exonlens = [], [], []
    seqs = []

    chrom_index = {nm: i for i, nm in enumerate(db.chrom_names)}
    for idx in range(1, genes_iit.total_nintervals + 1):
        divname, _low, _high, _sign, _typ = genes_iit.interval(idx)
        if divname not in chrom_index:
            continue
        chroff = int(db.chrom_offsets[chrom_index[divname]])
        ann_lines = genes_iit.annotations[idx - 1].splitlines()
        if not ann_lines:
            continue
        gene_name = ann_lines[0].split()[0] if ann_lines[0].strip() else ""
        exons = []
        for line in ann_lines[1:]:
            parts = line.split()
            if len(parts) < 2:
                continue
            try:
                s, e = int(parts[0]), int(parts[1])
            except ValueError:
                continue
            exons.append((s, e))
        if not exons:
            continue
        minus = exons[0][0] > exons[0][1]
        tseq_parts = []
        bound = 0
        for s, e in exons:
            if minus:
                # coords listed high..low for minus strand
                gleft0 = chroff + e - 1              # 0-based leftmost
                elen = s - e + 1
                part = db.get_seq(gleft0, elen)
                tseq_parts.append(dna.revcomp(part))
                # first transcribed base = highest coordinate
                exonstarts.append(chroff + s - 1)
            else:
                gleft0 = chroff + s - 1
                elen = e - s + 1
                tseq_parts.append(db.get_seq(gleft0, elen))
                exonstarts.append(gleft0)
            bound += elen
            exonbounds.append(bound)
            exonlens.append(elen)
        labels.append(genes_iit.labels[idx - 1])
        genes.append(gene_name)
        chrnums.append(chrom_index[divname])
        strands.append(-1 if minus else 1)
        exon_offsets.append(len(exonbounds))
        seqs.append("".join(tseq_parts))

    if not labels:
        raise ValueError("no transcripts matched the genome db")
    if k == 0:
        import math
        total = sum(len(s) for s in seqs)
        k = max(8, min(15, math.ceil(math.log(max(total, 2) * 16, 4))))
    trdb = build_db_from_seqs(zip(labels, seqs), name=name, k=k,
                              interval=interval)
    return Transcriptome(
        trdb=trdb, genome_name=db.name, labels=labels, genes=genes,
        chrnum=np.asarray(chrnums, dtype=np.int32),
        strand=np.asarray(strands, dtype=np.int8),
        exon_offsets=np.asarray(exon_offsets, dtype=np.int64),
        exonbounds=np.asarray(exonbounds, dtype=np.int64),
        exonstarts=np.asarray(exonstarts, dtype=np.uint64),
        exonlens=np.asarray(exonlens, dtype=np.int64))
