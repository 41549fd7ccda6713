"""row_emit_ms (ms a batch): the SAM rows the C emitter leaves to the
port's Python records (indel, splice, fusion, transcriptome and
ambiguous rows; io/sam's *_record) and their splicing into the stream:
driver._emit_rows, paired._emit_pair_rows and paired._stream_pairs,
wrapped by name in the traced run; their self time."""
from harness.port_spans import where_present

SPANS = where_present([("tpumap_torch.gsnap.driver", "_emit_rows"),
                       ("tpumap_torch.gsnap.paired", "_emit_pair_rows"),
                       ("tpumap_torch.gsnap.paired", "_stream_pairs")])


def read(t):
    return t.span_ms_per_batch("row_emit_ms")
