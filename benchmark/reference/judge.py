"""The comparison that decides `correct`: the program's SAM lines for a
sample of the window's reads, judged against the genome and the reads'
truth by the plain reference.

Two numbers:

- bad_records: reads (mates) whose output breaks what a SAM line states
  (absent, twice, another name or bases, a CIGAR, NM or MD that the
  genome does not bear out; for pairs, mate fields that disagree with
  the mate's own line, a TLEN that is not the span of the two mates'
  alignments, a proper-pair bit that is not set exactly where both mates
  map on opposite strands within pairmax, or that is cleared on a pair
  whose mates lie at their true places). Exact: the limit is 0.
- worse_share: the share of the sample's reads (mates) whose reported
  alignment scores more than TOLERANCE below the reference's best: the
  larger of the read's true alignment and the best ungapped alignment
  over the reference's own seeds (reference/seeds.py). An unmapped read
  scores 0.
"""
from __future__ import annotations

import numpy as np

from reference import samcheck, seeds

# how far below the reference's best a reported alignment may score
# before it counts as worse: an indel of up to 8 bases from a read's end
# that is clipped instead costs at most this much
TOLERANCE = 8


def _lines_by_id(chunks, prefix: bytes, wanted: set) -> dict:
    """{read id: [line, ...]} of every line of the kept SAM texts whose
    QNAME is one of `wanted`."""
    out = {}
    p = len(prefix)
    for text in chunks:
        for line in text.split(b"\n"):
            if not line or line[:1] == b"@":
                continue
            tab = line.find(b"\t")
            name = line[:tab]
            if name[:p] != prefix or not name[p:].isdigit():
                continue
            i = int(name[p:])
            if i in wanted:
                out.setdefault(i, []).append(line)
    return out


def ref_scores(genome_t, reads: np.ndarray, truth: dict, k: int,
               interval: int) -> np.ndarray:
    """The reference's best score of each read: its truth's, or a better
    ungapped alignment that its seeds find."""
    R = reads.shape[1]
    t = dict(truth)
    t["njunc"] = (truth["junctions"][:, :, 0] >= 0).sum(1)
    tscore = samcheck.truth_score(t, R)
    sscore, _best = seeds.best_ungapped(
        genome_t, seeds.to_device(reads, genome_t.device), k, interval)
    return np.maximum(tscore, sscore)


def judge(genome: np.ndarray, genome_t, contig: bytes, blocks: list,
          sam_chunks: list, pairs: bool, k: int, interval: int,
          pairmax: int) -> dict:
    """{"bad_records", "worse_share", "sample", "problems": [first
    few], "worse_examples": [first few]} over the reads of `blocks`
    (traffic.make_block outputs with truth)."""
    prefix = b"p" if pairs else b"r"
    ids = np.concatenate([b["ids"] for b in blocks])
    nm = 2 if pairs else 1
    mates = []
    for m in range(nm):
        reads = np.concatenate([b["reads"][m] for b in blocks])
        truth = {key: np.concatenate([b["truth"][m][key] for b in blocks])
                 for key in blocks[0]["truth"][m]}
        mates.append((reads, ref_scores(genome_t, reads, truth, k,
                                        interval), truth))
    lines = _lines_by_id(sam_chunks, prefix, set(ids.tolist()))
    bad = 0
    worse = 0
    problems = []
    examples = []

    def fault(i, why):
        nonlocal bad
        bad += 1
        if len(problems) < 8:
            problems.append(f"{prefix.decode()}{i:010d}: {why}")

    for j, i in enumerate(ids.tolist()):
        got = lines.get(i, [])
        prim = [samcheck.parse(x) for x in got]
        prim = [r for r in prim if not r["flag"] & 0x900]
        recs = []
        for m in range(nm):
            mine = ([r for r in prim if bool(r["flag"] & 0x40) == (m == 0)]
                    if pairs else prim)
            if len(mine) != 1:
                fault(i, f"{len(mine)} primary lines for mate {m + 1}")
                recs.append(None)
                worse += 1
                continue
            r = mine[0]
            reads, best, _t = mates[m]
            why, score, span = samcheck.check(r, reads[j], genome, contig)
            if why:
                fault(i, why)
            if best[j] - score > TOLERANCE:
                worse += 1
                if len(examples) < 8:
                    t = mates[m][2]
                    examples.append(
                        f"{prefix.decode()}{i:010d}/{m + 1}: flag "
                        f"{r['flag']} pos {r['pos']} {r['cigar'].decode()} "
                        f"score {score}; truth strand {t['strand'][j]} pos "
                        f"{t['pos0'][j] + 1} mm {t['nmm'][j]} ins "
                        f"{t['ins_b'][j]} del {t['del_b'][j]} junctions "
                        f"{int((t['junctions'][j, :, 0] >= 0).sum())} "
                        f"best {best[j]}")
            r["span"] = span
            t = mates[m][2]
            r["at_truth"] = (span is not None and bool(r["flag"] & 0x10)
                             == bool(t["strand"][j])
                             and span[0] <= t["end"][j]
                             and t["pos0"][j] < span[1])
            recs.append(r)
        if pairs and None not in recs:
            why = _mate_fields(recs[0], recs[1], pairmax)
            if why:
                fault(i, why)
    n = len(ids) * nm
    return {"bad_records": bad, "worse_share": worse / n, "sample": n,
            "problems": problems, "worse_examples": examples}


def _mate_fields(a: dict, b: dict, pairmax: int):
    """What is wrong with the mate fields of a pair's two lines, or
    None. Each line has its alignment's genome span (samcheck.check)
    and whether it lies at the mate's true place."""
    for r, o in ((a, b), (b, a)):
        f, of = r["flag"], o["flag"]
        if not f & 0x1 or bool(f & 0x40) == bool(f & 0x80):
            return "FLAG lacks the paired and first/last mate bits"
        if bool(f & 0x8) != bool(of & 0x4):
            return "mate-unmapped bit disagrees with the mate"
        if of & 0x4 or f & 0x4:
            continue
        if bool(f & 0x20) != bool(of & 0x10):
            return "mate-reverse bit disagrees with the mate"
        if r["rnext"] not in (b"=", o["rname"]) or r["pnext"] != o["pos"]:
            return "RNEXT/PNEXT is not the mate's position"
    if a["tlen"] != -b["tlen"]:
        return "TLEN of the mates do not cancel"
    proper = bool(a["flag"] & 0x2)
    if proper != bool(b["flag"] & 0x2):
        return "proper-pair bit on one mate only"
    if (a["flag"] | b["flag"]) & 0x4:
        if proper:
            return "proper pair with a mate unmapped"
        if a["tlen"]:
            return "TLEN with a mate unmapped"
        return None
    (s0, e0), (s1, e1) = a["span"], b["span"]
    span = max(e0, e1) - min(s0, s1)
    opposite = bool(a["flag"] & 0x10) != bool(b["flag"] & 0x10)
    if a["at_truth"] and b["at_truth"] and not proper:
        return "proper-pair bit cleared on a pair at its true places"
    if proper != (opposite and span <= pairmax):
        return ("proper-pair bit set on mates that are not on opposite "
                "strands within pairmax" if proper else
                "proper-pair bit cleared on mates on opposite strands "
                "within pairmax")
    if not proper and a["tlen"] == 0:
        return None
    if abs(a["tlen"]) != span:
        return (f"TLEN {a['tlen']} where the mates' alignments span {span} "
                f"({a['pos']} {a['cigar'].decode()}, {b['pos']} "
                f"{b['cigar'].decode()})")
    if s0 != s1 and (a["tlen"] > 0) != (s0 < s1):
        return "TLEN is not plus on the leftmost mate"
    return None
