"""enqueue_ms (ms a batch): the host's enqueue of a batch's device work,
ladder.align_batch_full and ladder.align_pair_full, wrapped by name in
the traced run; its self time."""
SPANS = [("tpumap_torch.gsnap.ladder", "align_batch_full"),
         ("tpumap_torch.gsnap.ladder", "align_pair_full")]


def read(t):
    return t.span_ms_per_batch("enqueue_ms")
