"""device_ops_per_batch (ops a batch): the device ops that lie inside the
traced device window (torch.profiler, the card's activity: kernels,
copies, memsets) over the window's batches; the marker and any op past
the window's edges left out. It counts the card's work items, not the
host's runtime calls that enqueue them: a captured graph replays many
ops from one call and leaves this count as it was."""
SPANS = []


def read(t):
    if t.device is None or not t.device_batches:
        return None
    inside = t.device["n_device_events"] - t.device["n_outside"]
    return inside / t.device_batches if inside > 0 else None
