"""pair_ms (ms a batch of pairs): the paired-end host layer,
paired._pair_chunk (rescue, repair, concordance, the pair's records),
wrapped by name in the traced run; its self time, the refine and
emission spans inside it left out."""
SPANS = [("tpumap_torch.gsnap.paired", "_pair_chunk")]


def read(t):
    return t.span_ms_per_batch("pair_ms")
