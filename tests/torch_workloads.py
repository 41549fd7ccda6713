"""Read workloads shared by the tpumap_torch tests (no JAX imports, so
the GPU tests can use them on a machine without JAX).

Each workload builds its GenomeDB and Records with tpumap's host modules
(for the JAX side of a parity test), or with port=True with the port's
own copies, from the same generator (for runs where tpumap cannot be
imported)."""
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
                  tie_w=False):
    """Random chain-stage segments as anchors_to_segments leaves them
    (int32[N, S] diag, qstart, qend, weight and bool valid; zeros where
    not valid), numpy. A row's first n_valid (default: a random count)
    are valid; tie_q draws qstarts from a few values, tie_w weights
    from two."""
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
