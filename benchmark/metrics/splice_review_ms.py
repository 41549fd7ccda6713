"""splice_review_ms (ms a batch): the splice layer's host review, stage
3b, driver._splice_ends_review (the short terminal residues placed by
the exact-site scan: trimmed rows extended with a junction, tied
placements kept as soft clips with XA:Z: alternatives, short terminal
exons demoted), wrapped by name in the traced run; its self time.
refine_ms's self time leaves it out where both are read."""
from harness.port_spans import where_present

SPANS = where_present([("tpumap_torch.gsnap.driver", "_splice_ends_review")])


def read(t):
    return t.span_ms_per_batch("splice_review_ms")
