"""encode_ms (ms a batch): host encode, driver.make_batch (the C pass that
packs a batch), wrapped by name in the traced run; its self time."""
SPANS = [("tpumap_torch.gsnap.driver", "make_batch"),
         ("tpumap_torch.gsnap.paired", "make_batch")]


def read(t):
    return t.span_ms_per_batch("encode_ms")
