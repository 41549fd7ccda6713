"""Reading one SAM line against the genome, as the SAM specification
defines its fields: the alignment that POS, CIGAR and SEQ state is
recomputed base by base from the genome, and NM and MD must say what it
says. Also the score of an alignment under the comparison's scoring."""
from __future__ import annotations

import re

import numpy as np

# the comparison's scoring: a matched base +1, a mismatch -MISMATCH, an
# insertion or deletion -(GAP_OPEN + its length), an intron -INTRON; a
# clipped base 0
MISMATCH = 3
GAP_OPEN = 4
INTRON = 2

_CIGAR = re.compile(rb"(\d+)([MIDNSHP=X])")
_LUT = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _LUT[_b] = _i
_ACGT = np.frombuffer(b"ACGT", np.uint8)


def parse(line: bytes) -> dict:
    f = line.split(b"\t")
    tags = {}
    for t in f[11:]:
        tags[t[:2]] = t[5:]
    return {"qname": f[0], "flag": int(f[1]), "rname": f[2],
            "pos": int(f[3]), "mapq": int(f[4]), "cigar": f[5],
            "rnext": f[6], "pnext": int(f[7]), "tlen": int(f[8]),
            "seq": f[9], "tags": tags}


def codes_of(seq: bytes) -> np.ndarray:
    return _LUT[np.frombuffer(seq, np.uint8)]


def truth_score(t: dict, R: int) -> int:
    """The scores of the reads' true alignments (their truth from the
    generator, arrays)."""
    matches = R - t["ins_b"] - t["nmm"]
    return (matches - MISMATCH * t["nmm"]
            - GAP_OPEN * (t["ins_ev"] + t["del_ev"])
            - t["ins_b"] - t["del_b"] - INTRON * t["njunc"])


def check(rec: dict, sent: np.ndarray, genome: np.ndarray,
          contig: bytes) -> tuple:
    """(problem or None, score, span) of one primary line for the read
    `sent` (uint8 codes as the read was sent). The score of an unmapped
    read is 0; span is (leftmost, one past rightmost) genome coordinate
    of a mapped line."""
    rev = bool(rec["flag"] & 16)
    want = 3 - sent[::-1] if rev else sent
    seq = codes_of(rec["seq"])
    if len(seq) != len(want) or not np.array_equal(seq, want):
        return "SEQ is not the read", 0, None
    if rec["flag"] & 4:
        return None, 0, None
    if rec["rname"] != contig or rec["pos"] < 1:
        return "RNAME or POS out of the genome", 0, None
    ops = [(int(n), op) for n, op in _CIGAR.findall(rec["cigar"])]
    if b"".join(b"%d%s" % (n, op) for n, op in ops) != rec["cigar"]:
        return "CIGAR unreadable", 0, None
    g = rec["pos"] - 1
    q = 0
    mm = gaps = gap_b = introns = matched = 0
    md = []
    run = 0
    for n, op in ops:
        if op in b"M=X":
            if g + n > len(genome) or q + n > len(seq):
                return "alignment past the genome or the read", 0, None
            ref = genome[g:g + n]
            diff = np.nonzero(seq[q:q + n] != ref)[0]
            last = 0
            for d in diff.tolist():
                run += d - last
                md.append(b"%d%s" % (run, _ACGT[ref[d]:ref[d] + 1].tobytes()))
                run = 0
                last = d + 1
            run += n - last
            mm += len(diff)
            matched += n
            g += n
            q += n
        elif op == b"I":
            gaps += 1
            gap_b += n
            q += n
        elif op == b"D":
            gaps += 1
            gap_b += n
            md.append(b"%d^%s" % (run, _ACGT[genome[g:g + n]].tobytes()))
            run = 0
            g += n
        elif op == b"N":
            introns += 1
            g += n
        elif op == b"S":
            q += n
        else:
            return "CIGAR op not emitted by an aligner", 0, None
    md.append(b"%d" % run)
    if q != len(seq):
        return "CIGAR length is not the read's", 0, None
    nm = mm + gap_b
    tags = rec["tags"]
    if b"NM" in tags and int(tags[b"NM"]) != nm:
        return f"NM {int(tags[b'NM'])} where the alignment has {nm}", 0, None
    if b"MD" in tags and tags[b"MD"] != b"".join(md):
        return "MD disagrees with the genome", 0, None
    score = (matched - mm - MISMATCH * mm - GAP_OPEN * gaps - gap_b
             - INTRON * introns)
    return None, int(score), (rec["pos"] - 1, g)
