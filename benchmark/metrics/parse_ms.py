"""parse_ms (ms a batch): the port's reader (tpumap_torch.io.fasta
read_seqs) over the chunk's FASTA text, a span of the benchmark's own
around its call (harness/window.py Aligner)."""
SPANS = []


def read(t):
    return t.span_ms_per_batch("parse_ms")
