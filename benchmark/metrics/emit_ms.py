"""emit_ms (ms a batch): SAM emission, driver._bulk_emit_chunk,
driver._mixed_emit_chunk and paired._emit_plain_pairs_bulk (the C
emitter, native/sam_emit.cc, and its Python set-up), wrapped by name in
the traced run; their self time."""
SPANS = [("tpumap_torch.gsnap.driver", "_bulk_emit_chunk"),
         ("tpumap_torch.gsnap.driver", "_mixed_emit_chunk"),
         ("tpumap_torch.gsnap.paired", "_emit_plain_pairs_bulk")]


def read(t):
    return t.span_ms_per_batch("emit_ms")
