"""Read workloads shared by the tpumap_torch tests (no JAX imports, so
the GPU tests can use them on a machine without JAX).

Each workload builds its GenomeDB and Records with tpumap's host modules
(for the JAX side of a parity test), or with port=True with the port's
own copies, from the same generator (for runs where tpumap cannot be
imported)."""
import re
import types

import numpy as np

from tpumap_torch.ops.mode import add_mode_index

# the preamble of a test subprocess in which neither JAX nor tpumap can
# be imported (sys.modules blocks JAX, a meta-path finder tpumap.*)
NO_TPUMAP = """
import sys
sys.modules["jax"] = None


class _RefuseTpumap:
    def find_spec(self, name, path=None, target=None):
        if name == "tpumap" or name.startswith("tpumap."):
            raise ImportError(f"{name} is refused")
        return None


sys.meta_path.insert(0, _RefuseTpumap())
"""


def host(port: bool = False):
    """build_db, Record and dna of tpumap, or of the port with port=True."""
    if port:
        from tpumap_torch.index.build import build_db
        from tpumap_torch.io.fasta import Record
        from tpumap_torch.utils import dna
    else:
        from tpumap.index import build_db
        from tpumap.io.fasta import Record
        from tpumap.utils import dna
    return types.SimpleNamespace(build_db=build_db, Record=Record, dna=dna)


def write_fasta(path, seq):
    path.write_text(">chr1\n" + "\n".join(
        seq[i:i + 60] for i in range(0, len(seq), 60)) + "\n")
    return path


def mixed_workload(root, port=False):
    """tests/test_stream.py's workload from its generator: a 60 kbp genome
    with a GT..AG intron and reads with substitutions, splices (soft
    clipped with splicing off), 4-base deletions, 3-base insertions,
    random unmapped reads with qualities and an N read.
    Returns (db, reads, genome fasta path)."""
    h = host(port)
    Record = h.Record
    rng = np.random.default_rng(11)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 60000))
    don, acc = 30100, 31000
    seq = seq[:don] + "GT" + seq[don + 2:acc - 2] + "AG" + seq[acc:]
    gfa = write_fasta(root / "g.fa", seq)
    reads = []
    for r in range(40):
        p = int(rng.integers(0, len(seq) - 100))
        s = list(seq[p:p + 100])
        for _ in range(int(rng.integers(0, 3))):
            j = int(rng.integers(0, 100))
            s[j] = "ACGT"[int(rng.integers(0, 4))]
        reads.append(Record(f"sub{r}", "", "".join(s)))
    for r in range(12):
        off = int(rng.integers(10, 60))
        reads.append(Record(f"spl{r}", "",
                            seq[don - off:don] + seq[acc:acc + 100 - off]))
    for r in range(6):
        p = 5000 + 700 * r
        reads.append(Record(f"del{r}", "",
                            seq[p:p + 50] + seq[p + 54:p + 104]))
    for r in range(6):
        p = 12000 + 700 * r
        reads.append(Record(f"ins{r}", "",
                            seq[p:p + 50] + "ACG" + seq[p + 50:p + 97]))
    for r in range(5):
        s = "".join("ACGT"[i] for i in rng.integers(0, 4, 100))
        reads.append(Record(f"unm{r}", "", s, "I" * 100))
    reads.append(Record("nn0", "", "ACGTN" * 20))
    return h.build_db(gfa, name="g", k=12, interval=3), reads, gfa


def stream_pairs(db, port=False):
    """tests/test_stream.py's paired workload on mixed_workload's genome:
    25 FR pairs with qualities and one pair whose mate is random."""
    h = host(port)
    Record, dna = h.Record, h.dna
    rng = np.random.default_rng(3)
    g = db.get_seq(0, db.genome_length)
    pairs = []
    for r in range(25):
        p = int(rng.integers(0, len(g) - 700))
        pairs.append((Record(f"pp{r}/1", "", g[p:p + 100], "I" * 100),
                      Record(f"pp{r}/2", "", dna.revcomp(g[p + 400:p + 500]),
                             "I" * 100)))
    pairs.append((Record("dx/1", "", g[5000:5100]),
                  Record("dx/2", "", "".join(
                      "ACGT"[i] for i in rng.integers(0, 4, 100)))))
    return pairs


def sam_text(recs) -> bytes:
    return "".join(r.lines() for r in recs).encode()


def emit_modes(db, index, reads, config, **kw) -> dict:
    """align_records in list mode and in stream mode (sink) on the reads
    and their reverse complements, so that rows map to both strands:
    asserts the same SAM bytes, the same rows_native and driver.METHODS
    counts, and each native row's RawSamRecord.flag equal to its line's
    FLAG, with FLAG 16 among them. Returns the count of native rows of
    each kind: unmapped, ungapped, soft-clipped and path (an N or D in
    the CIGAR)."""
    from tpumap_torch.gsnap import driver
    from tpumap_torch.io.sam_bulk import RawSamRecord
    comp = str.maketrans("ACGTN", "TGCAN")
    reads = list(reads) + [
        type(r)(r.accession + "_rc", "", r.sequence.translate(comp)[::-1],
                r.quality and r.quality[::-1]) for r in reads]
    list_stats, stream_stats, chunks = {}, {}, []
    recs = driver.align_records(db, index, reads, config, stats=list_stats,
                                **kw)
    assert driver.align_records(db, index, reads, config,
                                sink=chunks.append, stats=stream_stats,
                                **kw) == []
    text = b"".join(bytes(c) for c in chunks)
    assert sam_text(recs) == text
    for key in ("rows_native",) + driver.METHODS:
        assert list_stats.get(key, 0) == stream_stats.get(key, 0), key
    lines = text.decode().splitlines()
    assert len(lines) == len(recs)
    kinds, flags = {}, set()
    for rec, line in zip(recs, lines):
        if not isinstance(rec, RawSamRecord):
            continue
        fields = line.split("\t")
        assert rec.flag == int(fields[1]), line
        flags.add(rec.flag)
        cigar = fields[5]
        kind = ("unmapped" if rec.flag & 4 else
                "path" if "N" in cigar or "D" in cigar else
                "soft-clipped" if "S" in cigar else "ungapped")
        kinds[kind] = kinds.get(kind, 0) + 1
    assert sum(kinds.values()) == list_stats["rows_native"] and 16 in flags
    return kinds


_CIGAR = re.compile(r"(\d+)([MIDNSHP=X])")


def aligned_span(fields) -> tuple:
    """(start, end) of a SAM line's aligned bases (fields: the line's
    str fields): POS to POS plus the reference length of its CIGAR (M,
    D, N, = and X), the measure of TLEN in SAM v1.6, 1.4."""
    pos = int(fields[3])
    return pos, pos + sum(int(n) for n, op in _CIGAR.findall(fields[5])
                          if op in "MDN=X")


def mend_tlen(text: bytes, pairmax: int) -> tuple:
    """tpumap's pair SAM with each proper pair's TLEN as the port gives
    it: the span from the leftmost to the rightmost aligned base of the
    two mates' own lines (tpumap ends a gapped, spliced or repaired mate
    at its start plus the read's length), plus on the mate that starts
    first (mate 1 on a tie); a pair whose span then passes pairmax loses
    its proper-pair bit and its TLEN. Every other byte stays. Returns
    (the text, the pairs whose TLEN changed). Mates are found by QNAME
    less a /1 or /2 suffix."""
    lines = text.split(b"\n")
    mates = {}
    for k, ln in enumerate(lines):
        if not ln or ln[:1] == b"@":
            continue
        f = ln.split(b"\t")
        flag = int(f[1])
        if flag & 0x3 == 0x3 and not flag & 0x900:
            name = f[0][:-2] if f[0][-2:] in (b"/1", b"/2") else f[0]
            mates.setdefault(name, {})[bool(flag & 0x80)] = k
    changed = 0
    for ks in mates.values():
        if len(ks) != 2:
            continue
        f1, f2 = (lines[ks[m]].decode().split("\t") for m in (False, True))
        (s1, e1), (s2, e2) = aligned_span(f1), aligned_span(f2)
        span = max(e1, e2) - min(s1, s2)
        t1 = (1 if s1 <= s2 else -1) * span if span <= pairmax else 0
        if t1 == int(f1[8]):
            continue
        changed += 1
        for m, f, t in ((False, f1, t1), (True, f2, -t1)):
            f[8] = str(t)
            if not t:
                f[1] = str(int(f[1]) & ~0x2)
            lines[ks[m]] = "\t".join(f).encode()
    return b"\n".join(lines), changed


def mode_world(root, port=False):
    """tests/test_modes.py's world (30 kbp, k=12) with the tables of all
    four base spaces, and tests/test_snps.py's dense SNP cluster on it
    (an alt allele every 20 bp in [5000, 5240), alt = ref + 1).
    Returns (db, seq, snp coords, alt codes)."""
    rng = np.random.default_rng(33)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 30000))
    db = host(port).build_db(write_fasta(root / "g.fa", seq), name="g", k=12,
                             interval=3)
    for space in ("ct", "ga", "ag", "tc"):
        add_mode_index(db, space)
    coords = np.arange(5000, 5240, 20, dtype=np.int64)
    alts = ((db.get_codes(0, db.genome_length)[coords] + 1) % 4).astype(
        np.uint8)
    db.add_snp_index(coords, alts)
    return db, seq, coords, alts


# the conversion of each stranded library in the read's own text
CONVERSIONS = {"cmet-stranded": ("C", "T"), "atoi-stranded": ("A", "G"),
               "ttoc-stranded": ("T", "C")}


def convert(s: str, mode: str, cpg: bool = False) -> str:
    """A read text as the mode's library reads it; with cpg, a C before a
    G stays (methylated CpG)."""
    a, b = CONVERSIONS[mode]
    if not cpg:
        return s.replace(a, b)
    return "".join(b if c == a and s[i + 1:i + 2] != "G" else c
                   for i, c in enumerate(s))


def mode_reads(seq, mode, n, seed, snps=None, name="m", port=False):
    """n 100-bp reads of seq from a stranded library of `mode` (None: no
    conversion), every other one reverse-complemented before conversion;
    every fourth with two substitutions and the sixth with an N. With
    snps = (coords, alts), reads start inside the SNP cluster and carry
    the alt alleles they cover."""
    h = host(port)
    Record, dna = h.Record, h.dna
    rng = np.random.default_rng(seed)
    g = list(seq)
    if snps is not None:
        for c, a in zip(*snps):
            g[int(c)] = "ACGT"[int(a)]
    reads = []
    for r in range(n):
        p = (int(rng.integers(4900, 5200)) if snps is not None
             else int(rng.integers(0, len(seq) - 100)))
        s = list(g[p:p + 100])
        if r % 4 == 3:
            for j in rng.integers(0, 100, 2):
                s[j] = "ACGT"[("ACGT".index(s[j]) + 1) % 4]
        s = "".join(s)
        if r % 2:
            s = dna.revcomp(s)
        if mode is not None:
            s = convert(s, mode)
        if r == 5:
            s = s[:40] + "N" + s[41:]
        reads.append(Record(f"{name}{r}", "", s))
    return reads


def mode_pairs(seq, mode, n, seed, port=False):
    """n FR pairs, inserts 250-500, each mate converted in its own text
    (tests/test_modes.py's convention)."""
    h = host(port)
    Record, dna = h.Record, h.dna
    rng = np.random.default_rng(seed)
    out = []
    for r in range(n):
        p = int(rng.integers(0, len(seq) - 600))
        ins = int(rng.integers(250, 500))
        m1, m2 = seq[p:p + 100], dna.revcomp(seq[p + ins - 100:p + ins])
        if mode is not None:
            m1, m2 = convert(m1, mode), convert(m2, mode)
        out.append((Record(f"p{r}/1", "", m1), Record(f"p{r}/2", "", m2)))
    return out


# candidate offsets of a tie row (s: the row's phase shift), in lane order
def _tie_offsets(s):
    return [0, s, 4, s + 4, -4, s - 4, 8, s + 400, -8, s + 20_000, 12,
            s + 8, 400, s + 404, 16, s - 8]


def tie_rows(rng, d, K, L):
    """Tie-heavy chain DP rows on a genome that reads ACGT repeated from
    every diagonal d (a multiple of 4): read r follows d to a switch point
    and d + s (s in 1..3) after it, with a mismatch every fourth base
    past the switch. The K candidates are diagonals of both phases, so
    lanes of one phase score alike (equal H, equal jumps), and the row
    maximum recurs every four bases. Returns (codes uint8[R, L], lengths
    int32[R], diags int64[R, K])."""
    R = len(d)
    q = np.arange(L)
    sw = rng.integers(20, 60, R)
    shift = rng.integers(1, 4, R)
    codes = ((q[None, :] + np.where(q[None, :] >= sw[:, None],
                                    shift[:, None], 0)) % 4).astype(np.uint8)
    lengths = rng.integers(L - 28, L + 1, R).astype(np.int32)
    for r in range(R):
        codes[r, sw[r] + 8 + r % 4:lengths[r]:4] ^= 1
    codes[q[None, :] >= lengths[:, None]] = 0
    diags = np.stack([d[r] + np.array(_tie_offsets(int(shift[r]))[:K])
                      for r in range(R)]).astype(np.int64)
    return codes, lengths, diags


def gmap_segments(rng, N, S, n_valid=None, qspan=2000, tie_q=False,
                  tie_w=False, far=0):
    """Random chain-stage segments as anchors_to_segments leaves them
    (int32[N, S] diag, qstart, qend, weight and bool valid; zeros where
    not valid), numpy. A row's first n_valid (default: a random count)
    are valid; tie_q draws qstarts from a few values, tie_w weights
    from two; far > 0 moves half the segments' diagonals up by 0.7 far
    to far bases (genomic gaps of that size between members)."""
    diag = np.zeros((N, S), np.int32)
    qs = np.zeros((N, S), np.int32)
    qe = np.zeros((N, S), np.int32)
    w = np.zeros((N, S), np.int32)
    valid = np.zeros((N, S), bool)
    for i in range(N):
        n = int(rng.integers(0, S + 1)) if n_valid is None else n_valid
        # exon-like runs on increasing diagonals, plus noise segments
        starts = (rng.integers(0, 8, n) * 25 if tie_q
                  else rng.integers(0, qspan, n))
        lens = rng.integers(0, 120, n)
        base = (1 << 20) + rng.integers(0, 4000)
        d = base + np.where(rng.random(n) < 0.7, starts * 3,
                            rng.integers(-500, 60_000, n))
        if far:
            d = d + np.where(rng.random(n) < 0.5,
                             rng.integers(far * 7 // 10, far, n), 0)
        valid[i, :n] = True
        diag[i, :n] = d
        qs[i, :n] = starts
        qe[i, :n] = starts + lens
        w[i, :n] = (rng.integers(1, 3, n) if tie_w
                    else rng.integers(1, 40, n))
    return {"diag": diag, "qstart": qs, "qend": qe, "weight": w,
            "valid": valid}


def gmap_windows(rng, N, R, Q, k, n_frac=0.01, poly_a=False):
    """Window codes and valid flags (uint8/bool[N, R]) and query oligos
    and flags (int64/bool[N, Q]) for the anchor stage, numpy: each query
    copies pieces of its window (so anchors exist), with N bases and a
    tail past each window's length; poly_a makes every window and query
    all A."""
    codes = rng.integers(0, 4, (N, R)).astype(np.uint8)
    valid = rng.random((N, R)) >= n_frac
    lens = rng.integers(R // 2, R + 1, N)
    valid &= np.arange(R)[None, :] < lens[:, None]
    qc = rng.integers(0, 4, (N, Q)).astype(np.uint8)
    for i in range(N):
        for _ in range(4):
            a = int(rng.integers(0, max(1, R - Q // 4)))
            b = int(rng.integers(0, Q - Q // 4))
            qc[i, b:b + Q // 4] = codes[i, a:a + Q // 4]
    if poly_a:
        codes[:] = 0
        qc[:] = 0
    qv = rng.random((N, Q)) >= n_frac
    return (codes, valid) + query_oligos(qc, qv, k)


def query_oligos(qc, qv, k):
    """Rolled k-mer oligos (int64[N, Q]) of query codes and their ok
    flags (bool[N, Q]), as engine._chain_pipeline rolls them."""
    Q = qc.shape[1]
    acc = np.zeros(qc.shape, np.int64)
    ok = np.ones(qc.shape, bool)
    for j in range(k):
        acc = ((acc << 2) & 0xFFFFFFFF) | np.roll(qc, -j, 1)
        ok &= np.roll(qv, -j, 1)
    ok &= np.arange(Q)[None, :] < Q - k + 1
    return acc, ok


def gmap_straddle(rng, R, Q, C, max_occ):
    """One window (N = 1) whose hits of an oligo straddle position C, a
    chunk boundary of the anchor kernel: on a background of C bases,
    8-mer X at max_occ positions before C and 4 after it (its max_occ-th
    and (max_occ + 1)-th hits on either side), 8-mer Y at 5 before and
    max_occ - 5 after (max_occ hits in all); a random query holding X
    and Y at several positions. gmap_windows' four arrays at k = 8."""
    assert C >= 20 * max_occ + 400 and R >= C + 200 + 20 * max_occ
    codes = np.ones((1, R), np.uint8)
    x = np.array([0, 1, 2, 3, 3, 2, 1, 0], np.uint8)
    y = np.array([3, 3, 0, 0, 2, 1, 2, 0], np.uint8)
    at_x = [C - 20 * (max_occ - i) for i in range(max_occ)] + \
        [C + 7 + 20 * i for i in range(4)]
    at_y = [C - 20 * max_occ - 300 + 20 * i for i in range(5)] + \
        [C + 200 + 20 * i for i in range(max_occ - 5)]
    for at, olig in [(a, x) for a in at_x] + [(a, y) for a in at_y]:
        codes[0, at:at + 8] = olig
    qc = rng.integers(0, 4, (1, Q)).astype(np.uint8)
    for at, olig in ((10, x), (50, x), (90, x), (30, y), (70, y)):
        qc[0, at:at + 8] = olig
    return (codes, np.ones((1, R), bool)) + query_oligos(
        qc, np.ones((1, Q), bool), 8)


def gmap_repeat_query(rng, N, R, Q, k, period=6):
    """gmap_windows' windows with a tandem repeat of `period` bases
    (taken from the window, 300 bases long) and a query that is that
    repeat throughout: each of its oligos at ~Q / period positions, with
    ~300 / period hits in the window."""
    codes, valid, _acc, _ok = gmap_windows(rng, N, R, Q, k)
    qc = np.zeros((N, Q), np.uint8)
    for i in range(N):
        unit = codes[i, 100:100 + period]
        b = int(rng.integers(200, R // 2 - 300))
        codes[i, b:b + 300] = np.tile(unit, 300 // period + 1)[:300]
        valid[i, b:b + 300] = True
        qc[i] = np.tile(unit, Q // period + 1)[:Q]
    return (codes, valid) + query_oligos(qc, np.ones((N, Q), bool), k)


def gmap_world(root, port=False, seed=5, n=24):
    """A 120 kb genome of two chromosomes, saved as a db (k = 12), and n
    cDNAs of 2-5 exons (100-399 bp, introns 200-4,999 bp, GT..AG), every
    third reverse-complemented and one pure tandem-repeat query.
    Returns (db, records, fasta path of the queries)."""
    h = host(port)
    rng = np.random.default_rng(seed)
    g = list("ACGT"[i] for i in rng.integers(0, 4, 120_000))
    unit = "".join("ACGT"[i] for i in rng.integers(0, 4, 31))
    g[100_000:106_200] = list(unit * 200)
    recs = []
    for i in range(n):
        ne = int(rng.integers(2, 6))
        pos = int(rng.integers(1000, 80_000))
        parts = []
        for e in range(ne):
            el = int(rng.integers(100, 400))
            parts.append("".join(g[pos:pos + el]))
            nxt = pos + el + int(rng.integers(200, 5000))
            if e < ne - 1:
                g[pos + el:pos + el + 2] = list("GT")
                g[nxt - 2:nxt] = list("AG")
                parts[-1] = "".join(g[pos:pos + el])
            pos = nxt
        q = "".join(parts)
        recs.append(h.dna.revcomp(q) if i % 3 == 2 else q)
    recs.append(unit * 8)
    genome = "".join(g)
    fa = root / "g.fa"
    fa.write_text(f">chr1\n{genome[:70_000]}\n>chr2\n{genome[70_000:]}\n")
    db = h.build_db(fa, name="gw", k=12, interval=3)
    qfa = root / "q.fa"
    qfa.write_text("".join(f">c{i} cdna\n{s}\n" for i, s in enumerate(recs)))
    return db, [h.Record(f"c{i}", "cdna", s)
                for i, s in enumerate(recs)], qfa


def _fq(name, desc, seq, qual):
    return f"@{name}{' ' + desc if desc else ''}\n{seq}\n+\n{qual}\n"


def gsnap_cli_world(root, port=False):
    """The inputs of the gsnap CLI tests, every file made by one package's
    own tools (build_cli, the converters, iit_cli store, trindex_cli,
    snpindex_cli and modeindex_cli of tpumap, or of the port with
    port=True).

    A 42 kbp genome of two chromosomes: chr1 with a three-exon gene on
    the plus strand (GT..AG introns) and a two-exon gene on the minus
    strand (CT..AC), and a 2 kbp segment copied 8 kbp away (reads from it
    have two co-optimal loci); chr2 for the distant halves of fusion
    reads. Reads are 110 bp FASTQ with an Illumina chastity field
    (every seventh filtered): substitutions on both strands, the
    duplicated segment, junctions of both genes, 3-base deletions,
    2-base insertions, fusions, soft-clipped ends, random reads and an N
    run. Pairs (FR, inserts 300, two overlapping, one adapter
    read-through, one random mate), the same interleaved, a read-2 file
    whose names disagree, 10x barcode reads with a whitelist, the genes
    as GFF3 with their splice-site map (.iit and a KnownSplicing .npz)
    and transcriptome "tr", a learned-indel table, and two more dbs:
    SNP-tolerant (from a VCF) and cmet.
    Returns a dict of paths (str)."""
    import io
    import shutil
    from contextlib import redirect_stdout
    if port:
        from tpumap_torch.cli import (build_cli, converters, iit_cli,
                                      modeindex_cli, snpindex_cli,
                                      trindex_cli)
        from tpumap_torch.gsnap.knownindels import KnownIndels
        from tpumap_torch.gsnap.knownsplicing import KnownSplicing
        from tpumap_torch.index.build import GenomeDB
        from tpumap_torch.io.iit import IIT
        from tpumap_torch.utils import dna
    else:
        from tpumap.cli import (build_cli, converters, iit_cli,
                                modeindex_cli, snpindex_cli, trindex_cli)
        from tpumap.gsnap.knownindels import KnownIndels
        from tpumap.gsnap.knownsplicing import KnownSplicing
        from tpumap.index.build import GenomeDB
        from tpumap.io.iit import IIT
        from tpumap.utils import dna
    rng = np.random.default_rng(23)
    c1 = list("ACGT"[i] for i in rng.integers(0, 4, 30_000))
    c2 = "".join("ACGT"[i] for i in rng.integers(0, 4, 12_000))
    for a, b in ((2200, 3000), (3150, 4000)):       # gene A introns
        c1[a:a + 2], c1[b - 2:b] = list("GT"), list("AG")
    c1[8200:8202], c1[8998:9000] = list("CT"), list("AC")   # gene B
    c1[20_000:22_000] = c1[12_000:14_000]
    c1 = "".join(c1)
    (root / "g.fa").write_text(f">chr1\n{c1}\n>chr2\n{c2}\n")
    out = {k: str(root / v) for k, v in (
        ("FA", "g.fa"), ("R", "r.fq"), ("R1", "r1.fq"), ("R2", "r2.fq"),
        ("RI", "ri.fq"), ("R2BAD", "r2bad.fq"), ("RGZ", "r.fq.gz"),
        ("WL", "wl.txt"), ("SC1", "sc1.fq"), ("SC2", "sc2.fq"),
        ("GFF", "genes.gff3"), ("SS", "ss.iit"), ("SSNPZ", "ss.npz"),
        ("GENES", "genes.iit"), ("INDELS", "indels.npz"),
        ("VCF", "snps.vcf"))}
    with redirect_stdout(io.StringIO()):
        build_cli.main(["-D", str(root), "-d", "g", "-k", "12", "-q", "3",
                        str(root / "g.fa")])
    out["D"] = str(root / "g")

    def qual(n, r):
        return "".join("#" if (j * 7 + r) % 23 == 0 else "I"
                       for j in range(n))

    def mut(s, js):
        s = list(s)
        for j in js:
            s[j] = "ACGT"[("ACGT".index(s[j]) + 1) % 4]
        return "".join(s)

    reads = []
    for r in range(22):
        chrom, seq = (("chr1", c1) if r % 3 else ("chr2", c2))
        p = int(rng.integers(0, len(seq) - 110))
        if chrom == "chr1" and 11_900 < p < 22_100:
            p -= 10_000
        s = mut(seq[p:p + 110], rng.integers(0, 110, r % 3))
        reads.append(dna.revcomp(s) if r % 2 else s)
    reads += [c1[12_100 + 250 * r:12_210 + 250 * r] for r in range(6)]
    for off in (20, 45, 70, 90):
        reads.append(c1[2200 - off:2200] + c1[3000:3110 - off])
        reads.append(dna.revcomp(c1[3150 - off:3150] + c1[4000:4110 - off]))
    for off in (30, 75):
        reads.append(c1[8200 - off:8200] + c1[9000:9110 - off])
    for p in (5000, 6000):
        reads.append(c1[p:p + 50] + c1[p + 53:p + 113])
        reads.append(c1[p + 300:p + 350] + "TG" + c1[p + 350:p + 408])
    for p, q in ((5500, 3000), (16_000, 7000), (24_000, 9500)):
        reads.append(c1[p:p + 55] + c2[q:q + 55])
    reads.append(mut(c1[17_000:17_110], range(102, 110)))
    reads.append(dna.revcomp(mut(c2[4000:4110], range(0, 7))))
    reads += ["".join("ACGT"[i] for i in rng.integers(0, 4, 110))
              for _ in range(2)]
    reads.append(c1[18_000:18_040] + "N" * 12 + c1[18_052:18_110])
    (root / "r.fq").write_text("".join(
        _fq(f"r{i}", f"1:{'Y' if i % 7 == 6 else 'N'}:0:ACGT", s,
            qual(len(s), i)) for i, s in enumerate(reads)))
    (root / "r.fq.gz").write_bytes(
        __import__("gzip").compress((root / "r.fq").read_bytes()))

    pairs = []
    for r in range(14):
        p = int(rng.integers(0, 30_000 - 400))
        if 11_900 < p < 22_100:
            p -= 10_000
        ins = 300 if r != 13 else 160           # the last one overlaps
        pairs.append((c1[p:p + 110], dna.revcomp(c1[p + ins - 110:p + ins])))
    pairs.append((c1[7000:7110], dna.revcomp(c1[7050:7160])))
    frag = c1[26_000:26_070]
    adapter = "AGATCGGAAGAGCACACGTCTGAACTCCAGTCAC"
    pairs.append((frag + adapter[:40], dna.revcomp(frag) + adapter[:40]))
    pairs.append((c2[2000:2110],
                  "".join("ACGT"[i] for i in rng.integers(0, 4, 110))))
    pairs.append((c1[2150:2200] + c1[3000:3060],
                  dna.revcomp(c1[3100:3150] + c1[4000:4060])))
    m1 = [_fq(f"p{i}/1", f"1:{'Y' if i == 5 else 'N'}:0:AC", a,
              qual(len(a), i)) for i, (a, _b) in enumerate(pairs)]
    m2 = [_fq(f"p{i}/2", f"2:{'Y' if i in (5, 9) else 'N'}:0:AC", b,
              qual(len(b), i + 1)) for i, (_a, b) in enumerate(pairs)]
    (root / "r1.fq").write_text("".join(m1))
    (root / "r2.fq").write_text("".join(m2))
    (root / "ri.fq").write_text("".join(a + b for a, b in zip(m1, m2)))
    (root / "r2bad.fq").write_text("".join(
        m.replace(f"@p{i}/2", f"@x{i}/2") for i, m in enumerate(m2)))

    wl = ["AAAACCCCGGGGTTTT", "ACGTACGTACGTACGT", "TTTTGGGGCCCCAAAA"]
    (root / "wl.txt").write_text("".join(b + "-1\n" for b in wl))
    bcs = [wl[1], wl[0], "TAAACCCCGGGGTTTT", "CCAACCCCGGGGTTTT"]
    (root / "sc1.fq").write_text("".join(
        _fq(f"c{i}:1:2:3:{i + 4}", "", bc + "GATTACAGATTA", "I" * 28)
        for i, bc in enumerate(bcs)))
    (root / "sc2.fq").write_text("".join(
        _fq(f"c{i}:1:2:3:{i + 4}", "", c1[9500 + 400 * i:9610 + 400 * i],
            qual(110, i)) for i in range(4)))

    (root / "genes.gff3").write_text(
        "##gff-version 3\n"
        "chr1\tt\tgene\t2001\t4300\t.\t+\t.\tID=gA;Name=GENEA\n"
        "chr1\tt\tmRNA\t2001\t4300\t.\t+\t.\tID=tA;Parent=gA\n"
        "chr1\tt\texon\t2001\t2200\t.\t+\t.\tParent=tA\n"
        "chr1\tt\texon\t3001\t3150\t.\t+\t.\tParent=tA\n"
        "chr1\tt\texon\t4001\t4300\t.\t+\t.\tParent=tA\n"
        "chr1\tt\tgene\t8001\t9200\t.\t-\t.\tID=gB;Name=GENEB\n"
        "chr1\tt\tmRNA\t8001\t9200\t.\t-\t.\tID=tB;Parent=gB\n"
        "chr1\tt\texon\t9001\t9200\t.\t-\t.\tParent=tB\n"
        "chr1\tt\texon\t8001\t8200\t.\t-\t.\tParent=tB\n")
    for conv, name in ((converters.gff3_splicesites_main, "ss"),
                       (converters.gff3_genes_main, "genes")):
        buf = io.StringIO()
        with redirect_stdout(buf):
            conv([str(root / "genes.gff3")])
        (root / f"{name}.txt").write_text(buf.getvalue())
        iit_cli.store_main(["-o", str(root / name), str(root / f"{name}.txt")])
    db = GenomeDB.load(out["D"])
    KnownSplicing.from_splicing_iit(IIT.read(out["SS"]), db).dump(
        out["SSNPZ"])
    KnownIndels(np.array([5050, 6350], np.uint64),
                np.array([-3, 2], np.int32),
                np.array([4, 3], np.int64)).dump(out["INDELS"])
    with redirect_stdout(io.StringIO()):
        trindex_cli.main(["-D", out["D"], "-c", "tr", out["GENES"]])

    snps = [(p, c1[p - 1]) for p in range(1001, 30_000, 997)]
    (root / "snps.vcf").write_text("##fileformat=VCFv4.2\n" + "".join(
        f"chr1\t{p}\trs{p}\t{b}\t{'ACGT'[('ACGT'.index(b) + 1) % 4]}\t.\t.\t.\n"
        for p, b in snps))
    buf = io.StringIO()
    with redirect_stdout(buf):
        converters.vcf_iit_main([str(root / "snps.vcf")])
    (root / "snps.txt").write_text(buf.getvalue())
    iit_cli.store_main(["-o", str(root / "snps"), str(root / "snps.txt")])
    for name in ("gsnp", "gcmet"):
        shutil.copytree(out["D"], root / name)
        out[name.upper()[1:] + "D"] = str(root / name)
    snpindex_cli.main(["-D", out["SNPD"], str(root / "snps.iit")])
    modeindex_cli.main_cmet(["-D", out["CMETD"]])
    return out


def sharded_diags(db, reads, config) -> bytes:
    """The index-sharded aligner's diagonals over the first 32 reads on a
    2 x 2 grid of `cpu` devices (test_torch_parallel holds the aligner
    to tpumap's)."""
    import torch

    from tpumap_torch.gsnap import driver
    from tpumap_torch.parallel import mesh, sharded
    m = mesh.make_mesh(4, index_shards=2, devices=[torch.device("cpu")] * 4)
    arrays, align = sharded.make_sharded_aligner(m, db, config)
    L = max(len(r.sequence) for r in reads[:32])
    res = align(arrays, driver.make_batch(reads[:32], 32, L))
    return repr(res["diag"].tolist()).encode()


# ------------------------------------------ the ends rung and trimming

ENDS_K = 10             # k of ends_world's index


def ends_world(root, interval, port=False):
    """A 50.8-kbp genome for the ends rung and end trimming at every
    setting: 30 kbp random; a 40-bp unit 150 times and a 20-bp unit 400
    times (k-mers occurring ~150 and ~400 times, more than any max_occ
    below 300 keeps); a 150-bp segment 20 times and another 4 times,
    each copy followed by 50 random bases (reads with up to 20 and 4
    distinct diagonals); 2 kbp random; k = ENDS_K at `interval`, the
    four base spaces' tables and a SNP every 25 bp in [2000, 2600).
    Returns (db, seq, snp coords, alt codes)."""
    rng = np.random.default_rng(77)

    def rand(n):
        return "".join("ACGT"[i] for i in rng.integers(0, 4, n))
    seq = rand(30000) + rand(40) * 150 + rand(20) * 400
    for copies in (20, 4):
        seg = rand(150)
        seq += "".join(seg + rand(50) for _ in range(copies))
    seq += rand(2000)
    db = host(port).build_db(write_fasta(root / "g.fa", seq), name="g",
                             k=ENDS_K, interval=interval)
    for space in ("ct", "ga", "ag", "tc"):
        add_mode_index(db, space)
    coords = np.arange(2000, 2600, 25, dtype=np.int64)
    alts = ((db.get_codes(0, db.genome_length)[coords] + 1) % 4).astype(
        np.uint8)
    db.add_snp_index(coords, alts)
    return db, seq, coords, alts


def ends_reads(seq, L, seed, mode=None, snps=None, port=False):
    """Reads of ends_world for the ends rung (at most L <= 150 bases):
    genome reads with 0-3 substitutions, every other one reverse-
    complemented, of L and of 20-64 bases; reads of each repeat and of
    each copied segment (many distinct diagonals, overabundant k-mers);
    reads of 4-9 bases (shorter than
    k), of k and k + 3; random reads; reads with an N; with snps, reads
    of the SNP cluster carrying the alt alleles. With mode, each read as
    the mode's library reads it."""
    h = host(port)
    Record, dna = h.Record, h.dna
    rng = np.random.default_rng(seed)
    g = list(seq)
    if snps is not None:
        for c, a in zip(*snps):
            g[int(c)] = "ACGT"[int(a)]
    g = "".join(g)
    spans = ([(0, 29000, L)] * 10 + [(30000, 35900, L)] * 6
             + [(36000, 43900, L)] * 6 + [(44000, 44150, L)] * 4
             + [(48000, 48150, L)] * 4
             + [(0, 29000, n) for n in (4, 7, 9, 9, ENDS_K, ENDS_K + 3,
                                        20, 33, 50, 64)]
             + ([(1950, 2500, L)] * 4 if snps is not None else []))
    reads = []
    for r, (lo, hi, n) in enumerate(spans):
        p = int(rng.integers(lo, hi - n))
        s = list(g[p:p + n])
        for j in rng.integers(0, n, r % 4):
            s[j] = "ACGT"[("ACGT".index(s[j]) + 1) % 4]
        s = "".join(s)
        if r % 2:
            s = dna.revcomp(s)
        if r % 7 == 3 and n > 20:
            s = s[:12] + "N" + s[13:]
        reads.append(s)
    reads += ["".join("ACGT"[i] for i in rng.integers(0, 4, L))
              for _ in range(4)]
    if mode is not None:
        reads = [convert(s, mode) for s in reads]
    return [Record(f"e{i}", "", s) for i, s in enumerate(reads)]


def trim_rows(rng, gcodes, B, L, n_frac=0.02):
    """Rows for end trimming against genome codes gcodes: per row a
    diagonal (random, near the genome's start or past its end, or
    INVALID) and a strand; the read is the genome there with
    substitutions at 0-30% (some clustered at either end, so trimming
    cuts), complemented backwards on strand 1 (so the rc orientation
    aligns); lengths L, shorter than L, below 16 and 0; N flags at
    n_frac; quals 0-40. Returns (codes uint8[B, L], nmask bool[B, L],
    lengths int32[B], strand int32[B], diag int64[B], quals uint8[B, L])."""
    glen = len(gcodes)
    padded = np.concatenate([gcodes, np.zeros(L, np.uint8)])
    diag = rng.integers(0, glen - L, B).astype(np.int64)
    diag[1::9] = rng.integers(0, 8, len(diag[1::9]))
    diag[2::9] = glen - L // 2
    diag[3::9] = 0xFFFFFFFF
    strand = rng.integers(0, 2, B).astype(np.int32)
    lengths = np.full(B, L, np.int32)
    lengths[4::9] = rng.integers(16, L + 1, len(lengths[4::9]))
    lengths[5::9] = rng.integers(1, 16, len(lengths[5::9]))
    lengths[6::11] = 0
    codes = np.zeros((B, L), np.uint8)
    for r in range(B):
        n = int(lengths[r])
        d = int(diag[r]) if diag[r] != 0xFFFFFFFF else 0
        s = padded[d:d + n].copy()
        rate = (0.0, 0.01, 0.1, 0.3)[r % 4]
        sub = rng.random(n) < rate
        if r % 5 == 1:
            sub[:min(n, 6)] = True
        if r % 5 == 2:
            sub[max(n - 9, 0):] = True
        s[sub] = (s[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        codes[r, :n] = (3 - s[::-1]) if strand[r] else s
    nmask = (rng.random((B, L)) < n_frac) & (np.arange(L) < lengths[:, None])
    codes[nmask] = 0
    quals = rng.integers(0, 41, (B, L)).astype(np.uint8)
    return codes, nmask, lengths, strand, diag, quals
