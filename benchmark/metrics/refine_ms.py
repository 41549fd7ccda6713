"""refine_ms (ms a batch): host refine, driver.refine_unsolved (the
acceptance of indel, chain and splice-end solutions; MAPQ inputs),
wrapped by name in the traced run; its self time."""
SPANS = [("tpumap_torch.gsnap.driver", "refine_unsolved"),
         ("tpumap_torch.gsnap.paired", "refine_unsolved")]


def read(t):
    return t.span_ms_per_batch("refine_ms")
