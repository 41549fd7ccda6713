"""result_wait_ms (ms a batch): the host blocked on the card, waiting for
a batch's device work and result copies (ladder._wait_event, the
event's synchronize), wrapped by name in the traced run; its self
time."""
from harness.port_spans import where_present

SPANS = where_present([("tpumap_torch.gsnap.ladder", "_wait_event")])


def read(t):
    return t.span_ms_per_batch("result_wait_ms")
