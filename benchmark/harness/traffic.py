"""The one read generator that every traffic mix drives: a mix is a JSON
file of parameters under traffic/ (read length, the shares of read
sources, pairing, the error model), and this module turns it, the
genome and a run's --seed into FASTA text and each read's truth.

Reads are made in blocks of BLOCK reads (or pairs), each from its own
generator seeded by (seed, block id), so any block can be made again
alone: the producer process makes them for the window and the check
makes the sampled ones again with their truth.

Error model: wgsim's documented defaults (samtools' read simulator,
`-e 0.02 -r 0.001 -R 0.15 -X 0.3`): mutations at `mutation` a base, of
which `indel_frac` are indels (insertion or deletion alike) whose length
grows by one with probability `indel_extend`, the rest substitutions;
then sequencing errors, substitutions at `base_error` a base. Unlike
wgsim, mutations are drawn per read and not once per haplotype.

Sources of single reads ("sources" shares): `genome` (uniform over the
contig), `exonic` (inside an exon of at least the read's length),
`intronic` (inside an intron) and `spliced` (across one or two planted
junctions, drawn as tools/bench_data.rna_read_plan draws them). Pairs
("pairs": {"outer_mean", "outer_sd"}) are FR fragments over the genome.
"""
from __future__ import annotations

import numpy as np

BLOCK = 4096
# template bases beyond the read, for deletions
EXTRA = 32
SOURCES = ("genome", "exonic", "intronic", "spliced")


def block_rng(seed: int, block: int, salt: int = 0):
    return np.random.default_rng([int(seed) % (1 << 64), block, salt])


def _templates(rng, n, R, traffic, genome_bp, genes):
    """int64[n, R + EXTRA] genome coordinates in walk order (each row
    ascending), one template per read, and each row's source index."""
    T = R + EXTRA
    shares = np.array([traffic["sources"].get(s, 0.0) for s in SOURCES])
    src = rng.choice(len(SOURCES), size=n, p=shares / shares.sum())
    col = np.arange(T, dtype=np.int64)[None, :]
    out = np.empty((n, T), dtype=np.int64)
    ng, ne = (genes.shape[0], genes.shape[1]) if genes is not None else (0, 0)
    # genome: uniform starts
    m = src == 0
    st = rng.integers(0, genome_bp - T, int(m.sum()))
    out[m] = st[:, None] + col
    # exonic: an exon at least R long, the read inside it
    m = src == 1
    k = int(m.sum())
    if k:
        long_ex = np.nonzero(genes[0, :, 1] >= R)[0]
        g = rng.integers(0, ng, k)
        e = long_ex[rng.integers(0, len(long_ex), k)]
        es, el = genes[g, e, 0], genes[g, e, 1]
        st = es + (rng.random(k) * (el - R + 1)).astype(np.int64)
        out[m] = st[:, None] + col
    # intronic: inside one intron
    m = src == 2
    k = int(m.sum())
    if k:
        g = rng.integers(0, ng, k)
        i = rng.integers(0, ne - 1, k)
        a = genes[g, i, 0] + genes[g, i, 1]
        b = genes[g, i + 1, 0]
        st = a + (rng.random(k) * (b - a - T + 1)).astype(np.int64)
        out[m] = st[:, None] + col
    # spliced: one junction (exon 0 -> 1 skipped as rna_read_plan does:
    # 0 -> 1 becomes 2 -> 3) or two across the short exon 1
    m = src == 3
    k = int(m.sum())
    if k:
        g = rng.integers(0, ng, k)
        two = rng.random(k) < 0.25
        rows = np.empty((k, T), dtype=np.int64)
        # one junction
        e0 = rng.integers(0, 3, k)
        e0[e0 == 1] = 2
        l0 = rng.integers(20, 80, k)
        a = genes[g, e0, 0] + genes[g, e0, 1] - l0
        b = genes[g, e0 + 1, 0]
        one_rows = np.where(col < l0[:, None], a[:, None] + col,
                            b[:, None] + col - l0[:, None])
        # two junctions: the end of exon 0, all of exon 1, exon 2
        l1 = genes[g, 1, 1]
        l0b = 20 + (rng.random(k) * np.maximum(R - l1 - 40, 1)).astype(
            np.int64)
        a2 = genes[g, 0, 0] + genes[g, 0, 1] - l0b
        s1 = genes[g, 1, 0]
        s2 = genes[g, 2, 0]
        two_rows = np.where(
            col < l0b[:, None], a2[:, None] + col,
            np.where(col < (l0b + l1)[:, None],
                     s1[:, None] + col - l0b[:, None],
                     s2[:, None] + col - (l0b + l1)[:, None]))
        rows[:] = np.where(two[:, None], two_rows, one_rows)
        out[m] = rows
    return out, src


def _indel_events(rng, n, R, err):
    """Per read: the number of substitution mutations, and the indel
    events [(read position, 'I' or 'D', length)] of reads that have
    any (a dict)."""
    nmut = rng.binomial(R, err["mutation"], n)
    nind = rng.binomial(nmut, err["indel_frac"])
    events = {}
    for i in np.nonzero(nind)[0].tolist():
        c = int(nind[i])
        pos = np.sort(rng.integers(1, R - 1, c))
        kind = rng.random(c) < 0.5
        lens = rng.geometric(1.0 - err["indel_extend"], c)
        events[i] = [(int(p), "I" if k else "D", int(ln))
                     for p, k, ln in zip(pos, kind, lens)]
    return nmut - nind, events


def _walk(row, R, evs):
    """Read positions -> template coordinates (-1 = inserted base) for a
    row in walk order with indel events; the deletion and insertion
    events applied, as (kind, length) lists."""
    parts, n, j = [], 0, 0
    applied = []
    budget = EXTRA - 2
    for p, kind, ln in evs:
        if p > n:
            take = min(p, R) - n
            parts.append(row[j:j + take])
            j += take
            n += take
        if n >= R:
            break
        if kind == "I":
            ln = min(ln, R - n - 1)
            if ln > 0:
                parts.append(np.full(ln, -1, dtype=np.int64))
                n += ln
                applied.append(("I", ln))
        else:
            ln = min(ln, budget)
            if ln > 0:
                j += ln
                budget -= ln
                applied.append(("D", ln))
    if n < R:
        parts.append(row[j:j + R - n])
    return np.concatenate(parts), applied


def _reads(rng, codes, tmpl, descending, R, err):
    """Reads in genome orientation from templates: uint8[n, R] bases,
    int64[n, R] aligned coordinates (-1 = inserted) and the indel
    counts (events and bases of each kind)."""
    n = tmpl.shape[0]
    nsub_mut, events = _indel_events(rng, n, R, err)
    walk = tmpl.copy()
    walk[descending] = walk[descending, ::-1]
    aligned = walk[:, :R].copy()
    counts = np.zeros((n, 4), dtype=np.int64)    # I events, I bases, D ...
    for i, evs in events.items():
        a, applied = _walk(walk[i], R, evs)
        aligned[i] = a
        for kind, ln in applied:
            c = 0 if kind == "I" else 2
            counts[i, c] += 1
            counts[i, c + 1] += ln
    aligned[descending] = aligned[descending, ::-1]
    bases = codes[np.maximum(aligned, 0)]
    ins = aligned < 0
    nins = int(ins.sum())
    if nins:
        bases[ins] = rng.integers(0, 4, nins, dtype=np.uint8)
    # substitutions: the mutations' and the sequencing errors'
    nsub = nsub_mut + rng.binomial(R, err["base_error"], n)
    rows = np.repeat(np.arange(n), nsub)
    cols = rng.integers(0, R, len(rows))
    shift = rng.integers(1, 4, len(rows), dtype=np.uint8)
    # unbuffered, so a base hit twice changes twice
    np.add.at(bases, (rows, cols), shift)
    bases %= 4
    return bases, aligned, counts


def _truth(codes, bases, aligned, counts, tmpl, strand):
    """The truth of each read in genome orientation: strand, leftmost
    aligned coordinate, mismatches, indel counts and the junctions the
    read crosses ((donor, acceptor): the first intron base and the
    first exon base after it; -1 where none)."""
    al = aligned >= 0
    nmm = ((bases != codes[np.maximum(aligned, 0)]) & al).sum(1)
    big = np.iinfo(np.int64).max
    pos0 = np.where(al, aligned, big).min(1)
    end = np.where(al, aligned, -1).max(1)
    # template junctions inside [pos0, end]
    d = np.diff(tmpl, axis=1)
    jn = np.full((len(tmpl), 2, 2), -1, dtype=np.int64)
    for i, t in zip(*np.nonzero(d != 1)):
        donor, acc = int(tmpl[i, t] + 1), int(tmpl[i, t + 1])
        if pos0[i] < donor and acc <= end[i]:
            slot = 0 if jn[i, 0, 0] < 0 else 1
            jn[i, slot] = (donor, acc)
    return {"strand": strand.astype(np.int8), "pos0": pos0, "end": end,
            "nmm": nmm, "ins_ev": counts[:, 0], "ins_b": counts[:, 1],
            "del_ev": counts[:, 2], "del_b": counts[:, 3],
            "junctions": jn}


def _fasta(prefix: bytes, ids: np.ndarray, reads: np.ndarray) -> bytes:
    """'>' prefix id (10 digits) '\\n' read '\\n' for every row."""
    n, R = reads.shape
    w = 1 + len(prefix) + 10 + 1 + R + 1
    buf = np.empty((n, w), dtype=np.uint8)
    buf[:, 0] = ord(">")
    p = 1 + len(prefix)
    buf[:, 1:p] = np.frombuffer(prefix, np.uint8)
    pw = 10 ** np.arange(9, -1, -1, dtype=np.int64)
    buf[:, p:p + 10] = (ids[:, None] // pw) % 10 + 48
    buf[:, p + 10] = 10
    buf[:, p + 11:p + 11 + R] = np.frombuffer(b"ACGT", np.uint8)[reads]
    buf[:, -1] = 10
    return buf.tobytes()


def revcomp(reads: np.ndarray) -> np.ndarray:
    return 3 - reads[:, ::-1]


def make_block(codes, genes, traffic: dict, seed: int, block: int,
               truth: bool = True, n: int = BLOCK):
    """One block of n reads or pairs: {"fasta": [bytes] (one text, or
    mate 1's and mate 2's),
    "names": the ids, "reads": [uint8[n, R]] as sent, "truth": [dict]
    one a mate, where truth}. The reads do not depend on `truth`."""
    R = traffic["read_len"]
    err = traffic["errors"]
    rng = block_rng(seed, block)
    ids = np.arange(block * n, (block + 1) * n, dtype=np.int64)
    G = len(codes)
    if "pairs" not in traffic:
        tmpl, _src = _templates(rng, n, R, traffic, G, genes)
        strand = rng.random(n) < 0.5
        bases, aligned, counts = _reads(rng, codes, tmpl,
                                        np.zeros(n, bool), R, err)
        tr = (_truth(codes, bases, aligned, counts, tmpl, strand)
              if truth else None)
        sent = np.where(strand[:, None], revcomp(bases), bases)
        return {"fasta": [_fasta(b"r", ids, sent)], "ids": ids,
                "reads": [sent], "truth": [tr]}
    pp = traffic["pairs"]
    T = R + EXTRA
    frag = np.rint(rng.normal(pp["outer_mean"], pp["outer_sd"], n)
                   ).astype(np.int64)
    frag = np.clip(frag, T, pp["outer_mean"] + 4 * pp["outer_sd"])
    f0 = rng.integers(0, G - frag.max() - 1, n)
    col = np.arange(T, dtype=np.int64)[None, :]
    left = f0[:, None] + col
    right = (f0 + frag)[:, None] - T + col
    one_left = rng.random(n) < 0.5          # mate 1 is the left mate
    tmpl = np.concatenate([left, right])
    desc = np.concatenate([np.zeros(n, bool), np.ones(n, bool)])
    bases, aligned, counts = _reads(rng, codes, tmpl, desc, R, err)
    strand = desc.copy()                    # the right mate is reverse
    tr = (_truth(codes, bases, aligned, counts, tmpl, strand)
          if truth else None)
    sent = np.where(strand[:, None], revcomp(bases), bases)
    order1 = np.where(one_left, np.arange(n), n + np.arange(n))
    order2 = np.where(one_left, n + np.arange(n), np.arange(n))
    mates = []
    for order in (order1, order2):
        t = None
        if tr is not None:
            t = {k: v[order] for k, v in tr.items()}
            t["frag"] = frag
        mates.append((t, sent[order]))
    return {"fasta": [_fasta(b"p", ids, m[1]) for m in mates], "ids": ids,
            "reads": [m[1] for m in mates], "truth": [m[0] for m in mates]}
