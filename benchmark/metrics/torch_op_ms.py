"""torch_op_ms (ms a batch): the device time of everything but the hand
kernels (torch's kernels, copies, memsets) inside the traced window, the
sum of their durations over the window's batches."""
SPANS = []


def read(t):
    if t.device is None or not t.device_batches or t.device["device_s"] <= 0:
        return None
    return 1e3 * (t.device["device_s"] - t.device["hand_s"]) / t.device_batches
