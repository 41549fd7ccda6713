"""Read workloads shared by the tpumap_torch tests (no JAX imports, so
the GPU tests can use them on a machine without JAX)."""
import numpy as np

from tpumap.index import build_db
from tpumap.io.fasta import Record
from tpumap.utils import dna


def write_fasta(path, seq):
    path.write_text(">chr1\n" + "\n".join(
        seq[i:i + 60] for i in range(0, len(seq), 60)) + "\n")
    return path


def mixed_workload(root):
    """tests/test_stream.py's workload from its generator: a 60 kbp genome
    with a GT..AG intron and reads with substitutions, splices (soft
    clipped with splicing off), 4-base deletions, 3-base insertions,
    random unmapped reads with qualities and an N read.
    Returns (db, reads, genome fasta path)."""
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
    return build_db(gfa, name="g", k=12, interval=3), reads, gfa


def stream_pairs(db):
    """tests/test_stream.py's paired workload on mixed_workload's genome:
    25 FR pairs with qualities and one pair whose mate is random."""
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
