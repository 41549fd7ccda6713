"""transfer_ms (ms a batch): the host's side of a batch's transfers: the
upload of its packed reads (driver._to_device: pinned copies queued), the
queueing of its result copies (ladder.start_fetch) and the host view of
the copied result dict (ladder._host_view: numpy views, the widening),
wrapped by name in the traced run; their self time. The host's wait for
the card between the last two is result_wait_ms."""
from harness.port_spans import where_present

SPANS = where_present([("tpumap_torch.gsnap.driver", "_to_device"),
                       ("tpumap_torch.gsnap.paired", "_to_device"),
                       ("tpumap_torch.gsnap.ladder", "start_fetch"),
                       ("tpumap_torch.gsnap.ladder", "_host_view")])


def read(t):
    return t.span_ms_per_batch("transfer_ms")
