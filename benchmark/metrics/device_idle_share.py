"""device_idle_share (%): 100 less the device's busy percent of the host
window, the traced run's window that no profiler slows: the card's busy
time a batch in the device window (the union of its kernel, copy and
memset intervals, torch.profiler) times the host window's batches, over
the host window's seconds. (The device window's own idle share, slowed
by the profiler, is the result's device busy_s over window_s.)"""
SPANS = []


def read(t):
    if t.device is None or t.device["busy_s"] <= 0 or not t.device_batches \
            or not t.batches or not t.seconds:
        return None
    busy = t.device["busy_s"] / t.device_batches * t.batches
    return 100.0 * (1.0 - busy / t.seconds)
