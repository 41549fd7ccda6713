"""path_rows_ms (ms a batch): the spliced rows that the C emitter leaves
to Python, io/sam.path_record (a chain path with an insertion junction,
or a row the splice-end review changed: its CIGAR, NM, MD and XS from
the genome), wrapped by name in the traced run; its self time.
row_emit_ms's self time leaves these rows out where both are read."""
from harness.port_spans import where_present

SPANS = where_present([("tpumap_torch.io.sam", "path_record")])


def read(t):
    return t.span_ms_per_batch("path_rows_ms")
