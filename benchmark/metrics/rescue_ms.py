"""rescue_ms (ms a batch of pairs): mate rescue, paired._rescue (the
insert windows of the pairs with one end unplaced, or with both ends
placed and no concordant combination, its K1 launch over [R, pairmax]
diagonals and the blocking copies of its result), wrapped by name in
the traced run; its self time. pair_ms's self time leaves it out."""
from harness.port_spans import where_present

SPANS = where_present([("tpumap_torch.gsnap.paired", "_rescue")])


def read(t):
    return t.span_ms_per_batch("rescue_ms")
