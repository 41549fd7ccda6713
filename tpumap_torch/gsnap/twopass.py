"""Two-pass alignment: learn splice sites (and insert lengths) in pass 1,
realign with them in pass 2.

Reference: gsnap --two-pass (src/gsnap.c:4259-4430): pass 1 runs the full
aligner with no output, accumulating donor/acceptor tables + indel table +
insert lengths under a mutex (Path_learn_*, src/path-learn.c), builds
Knownsplicing_T/Knownindels_T, fits the insert-length model
(Pathpair_analyze_insertlengths), then reopens the inputs for pass 2.
--splices-dump/--splices-read persist the learned tables
(src/gsnap.c:655-658).

The port's copy (tpumap/gsnap/twopass.py): pass 1 is the fused path,
pass 2 the staged path (it carries the learned KnownIndels), both on the
index's device; "accumulate under a mutex" is a host-side reduction over
the emitted junction records. In a torch.distributed group of more
than one process the learned tables are all-gathered before pass 2
(parallel/distributed.py), so every process realigns with the union.
"""
from __future__ import annotations

import re

import numpy as np

from tpumap_torch.gsnap.knownsplicing import KnownSplicing

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")


def junctions_from_sam(db, records, min_support: int = 1):
    """Extract intron junctions from aligned SAM records.

    Returns (donor_coords, acceptor_coords, senses, counts): per unique
    junction, the 0-based univcoord of the first intron base, the first
    exon base after the intron, the XS sense (+1/-1, 0 if untagged), and
    the supporting read count. The Path_learn_introns analog.
    """
    seen: dict[tuple[int, int], list] = {}
    chrom_index = {nm: i for i, nm in enumerate(db.chrom_names)}
    for rec in records:
        if rec.flag & 4 or "N" not in rec.cigar:
            continue
        if rec.rname not in chrom_index:
            continue
        chroff = int(db.chrom_offsets[chrom_index[rec.rname]])
        sense = 0
        for tag in rec.tags:
            if tag.startswith("XS:A:"):      # '?' (noncanonical) stays 0
                sense = {"+": 1, "-": -1}.get(tag[5], 0)
        g = chroff + rec.pos - 1          # 0-based univcoord
        for n, op in _CIGAR_RE.findall(rec.cigar):
            n = int(n)
            if op == "N":
                key = (g, g + n)
                if key in seen:
                    seen[key][1] += 1
                else:
                    seen[key] = [sense, 1]
            if op in "MDN=X":
                g += n
    donors, acceptors, senses, counts = [], [], [], []
    for (d, a), (sense, count) in sorted(seen.items()):
        if count >= min_support:
            donors.append(d)
            acceptors.append(a)
            senses.append(sense if sense else 1)
            counts.append(count)
    return (np.asarray(donors, dtype=np.uint64),
            np.asarray(acceptors, dtype=np.uint64),
            np.asarray(senses, dtype=np.int32),
            np.asarray(counts, dtype=np.int64))


def learn_knownsplicing(db, records, min_support: int = 1) -> KnownSplicing:
    donors, acceptors, senses, _counts = junctions_from_sam(
        db, records, min_support)
    return KnownSplicing.from_junctions(donors, acceptors, senses)


def analyze_insertlengths(records):
    """Insert-length model from pass-1 pairs (Pathpair_analyze_insertlengths
    analog, src/gsnap.c:4357): returns (mean, sdev, pairmax estimate)."""
    tlens = [abs(r.tlen) for r in records
             if r.tlen != 0 and not (r.flag & 4) and (r.flag & 64)]
    if not tlens:
        return None
    arr = np.asarray(tlens, dtype=np.float64)
    mean, sdev = float(arr.mean()), float(arr.std())
    return {"mean": mean, "sdev": sdev,
            "pairmax": int(mean + 10 * max(sdev, 1.0)), "n": float(len(arr))}


def two_pass_align(db, index, records, config=None, max_intron: int = 200_000,
                   batch_size: int = 1024, min_support: int = 1,
                   splices_dump: str | None = None,
                   indels_dump: str | None = None, tr=None,
                   device_ctx=None):
    """Full two-pass single-end driver. Returns (sam_records, knownsplicing).

    Pass 1 also learns the indel table (Path_learn_indels analog); known
    indels feed pass 2's DP triggering and --indels-dump persists them."""
    from tpumap_torch.gsnap.driver import align_records
    from tpumap_torch.gsnap.engine import AlignConfig
    from tpumap_torch.gsnap.knownindels import KnownIndels

    config = config or AlignConfig()
    pass1 = align_records(db, index, records, config, novelsplicing=True,
                          max_intron=max_intron, batch_size=batch_size,
                          tr=tr, device_ctx=device_ctx)
    ks = learn_knownsplicing(db, pass1, min_support)
    ki = KnownIndels.from_sam(db, pass1, min_support)
    # a multi-process run all-gathers each process's learned tables
    # before pass 2 (identities in one process; parallel/distributed.py)
    from tpumap_torch.parallel import distributed as dist
    ks = dist.allgather_knownsplicing(ks)
    ki = dist.allgather_knownindels(ki)
    if splices_dump:
        ks.dump(splices_dump)
    if indels_dump:
        ki.dump(indels_dump)
    pass2 = align_records(db, index, records, config, novelsplicing=True,
                          max_intron=max_intron, batch_size=batch_size,
                          known=ks if ks.nsites else None,
                          known_indels=ki if ki.nsites else None, tr=tr,
                          device_ctx=device_ctx)
    return pass2, ks
