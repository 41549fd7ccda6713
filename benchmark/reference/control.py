"""The control: the reference's own aligner put in the program's place,
without gaps. It reports each read at the best ungapped clipped
alignment its seeds find, so it breaks the configuration's guarantee
that reads with insertions, deletions and (with novel splicing)
junctions are aligned through them. The comparison has to find it not
correct (worse_share over its limit). harness/control_run.py runs it at
a cell's own size."""
from __future__ import annotations

import numpy as np

from reference import seeds

MIN_SCORE = 20


def _md_nm(seq: np.ndarray, ref: np.ndarray) -> tuple:
    diff = np.nonzero(seq != ref)[0].tolist()
    md, last = [], 0
    for d in diff:
        md.append(b"%d%s" % (d - last, b"ACGT"[ref[d]:ref[d] + 1]))
        last = d + 1
    md.append(b"%d" % (len(seq) - last))
    return b"".join(md), len(diff)


def _line(contig, name, flag, pos, cigar, rnext, pnext, tlen, seq, tags):
    return b"\t".join([name, b"%d" % flag, b"*" if flag & 4 else contig,
                       b"%d" % pos, b"0" if flag & 4 else b"40", cigar,
                       rnext, b"%d" % pnext, b"%d" % tlen, seq, b"*"]
                      + tags)


def control_sam(genome: np.ndarray, genome_t, contig: bytes, blocks: list,
                pairs: bool, k: int, interval: int, pairmax: int) -> bytes:
    """The control's SAM text for every read of `blocks`."""
    ACGT = np.frombuffer(b"ACGT", np.uint8)
    nm = 2 if pairs else 1
    prefix = b"p" if pairs else b"r"
    ids = np.concatenate([b["ids"] for b in blocks])
    al = []
    for m in range(nm):
        reads = np.concatenate([b["reads"][m] for b in blocks])
        score, best = seeds.best_ungapped(
            genome_t, seeds.to_device(reads, genome_t.device), k, interval)
        rows = []
        for j in range(len(ids)):
            sent = reads[j]
            if score[j] < MIN_SCORE:
                rows.append({"flag": 4, "seq": ACGT[sent].tobytes(),
                             "pos": 0})
                continue
            s, left, qs, qe = (int(x) for x in best[j])
            q = 3 - sent[::-1] if s else sent
            R = len(q)
            md, nmm = _md_nm(q[qs:qe], genome[left:left + qe - qs])
            cig = (b"%dS" % qs if qs else b"") + b"%dM" % (qe - qs) + \
                (b"%dS" % (R - qe) if qe < R else b"")
            rows.append({"flag": 16 if s else 0, "seq": ACGT[q].tobytes(),
                         "pos": left + 1, "cigar": cig,
                         "span": (left, left + qe - qs),
                         "tags": [b"NM:i:%d" % nmm, b"MD:Z:" + md]})
        al.append(rows)
    out = []
    for j, i in enumerate(ids.tolist()):
        name = b"%s%010d" % (prefix, i)
        ends = [al[m][j] for m in range(nm)]
        tl = [0] * nm
        proper = False
        if pairs and not (ends[0]["flag"] | ends[1]["flag"]) & 4 and \
                (ends[0]["flag"] & 16) != (ends[1]["flag"] & 16):
            lo = min(e["span"][0] for e in ends)
            hi = max(e["span"][1] for e in ends)
            if hi - lo <= pairmax:
                proper = True
                first = 0 if ends[0]["span"][0] <= ends[1]["span"][0] else 1
                tl[first], tl[1 - first] = hi - lo, lo - hi
        for m, e in enumerate(ends):
            flag = e["flag"]
            rnext, pnext = b"*", 0
            if pairs:
                o = ends[1 - m]
                flag |= 0x1 | (0x40 if m == 0 else 0x80)
                if o["flag"] & 4:
                    flag |= 0x8
                else:
                    flag |= 0x20 if o["flag"] & 16 else 0
                    rnext, pnext = b"=", o["pos"]
                if proper:
                    flag |= 0x2
            out.append(_line(contig, name, flag, e["pos"],
                             e.get("cigar", b"*"),
                             rnext, pnext, tl[m], e["seq"],
                             e.get("tags", [])))
    return b"\n".join(out) + b"\n"

