"""hand_kernels_roofline (%): the hand kernels' bound over their device
time in the traced window: the sum over their launches of the larger of
bytes over HBM bandwidth and operations over their pipe
(kernels/<launch name>.py, harness/peaks.py), over the sum of the hand
kernels' device time. Nothing where no hand kernel ran."""
SPANS = []


def read(t):
    if t.device is None or t.device["hand_s"] <= 0 or not t.kernel_bound_s:
        return None
    return 100.0 * t.kernel_bound_s / t.device["hand_s"]
