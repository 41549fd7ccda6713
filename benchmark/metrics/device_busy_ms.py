"""device_busy_ms (ms a batch): the union of the card's kernel, copy and
memset intervals inside the traced window (torch.profiler), over the
window's batches."""
SPANS = []


def read(t):
    if t.device is None or not t.device_batches or t.device["busy_s"] <= 0:
        return None
    return 1e3 * t.device["busy_s"] / t.device_batches
