"""The traced run's device readings: the device's busy time from
torch.profiler, recording the card's activity alone (the union of its
kernel, copy and memset intervals inside the window), the time by device
op, the hand kernels' part, the longest idle gaps labelled by the host
span open at the time, and the hand kernels' launches with their work
(kernels/<launch name>.py) for the roofline share.

The profile holds no host events, so the window's edges and the host
spans are taken on the host's clock (time.perf_counter_ns) and placed on
the trace's by a marker: the first device op of the profile, launched
at a host time that is recorded."""
from __future__ import annotations

import re

from harness import manifest, peaks


def hand_kernel_symbols(root) -> list:
    """The __global__ function names of the port's CUDA sources."""
    syms = set()
    for cu in sorted((root / "tpumap_torch" / "csrc").glob("*.cu*")):
        syms.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                               r"\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(",
                               cu.read_text()))
    return sorted(syms)


class Launches:
    """Wraps tpumap_torch.kernels.launch: each hand kernel's launch
    keeps its work's inputs (kernels/<name>.py capture: ints and
    references to the launch's tensors, no device op), counted after
    the window (bound_s)."""

    def __init__(self):
        self.calls = []
        self.mods = {}

    def wrap(self, launch):
        def wrapped(name, device, *args):
            launch(name, device, *args)
            if name not in self.mods:
                self.mods[name] = manifest.kernel_work(name)
            mod = self.mods[name]
            self.calls.append((name, mod.capture(args)
                               if mod is not None else None))
        return wrapped

    def bound_s(self) -> float:
        """The least time the card could take for the kept launches'
        work; drops the references."""
        total = 0.0
        for name, cap in self.calls:
            if cap is not None:
                total += peaks.bound_s(*self.mods[name].work(cap))
        self.calls = [(name, None) for name, _ in self.calls]
        return total


def _union(iv):
    """Merged, sorted [(start, end)] of intervals."""
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def analyse(prof, symbols, mark_ns: int, w0_ns: int, w1_ns: int,
            spans: list) -> dict:
    """Readings of a profile of the card's activity. mark_ns: the host
    time (perf_counter_ns) just before the marker, the profile's first
    device op, was launched; w0_ns, w1_ns: the window's edges and spans
    [(start, end, name)] on the same clock."""
    from torch.autograd import DeviceType
    dev = sorted((e.start_ns(), e.end_ns(), e.name())
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA)
    if not dev:
        raise RuntimeError("the profile holds no device op")
    off = dev[0][0] - mark_ns
    w0, w1 = w0_ns + off, w1_ns + off
    pat = re.compile(r"\b(" + "|".join(map(re.escape, symbols)) + r")\b")
    by_op, hand_ns, total_ns = {}, 0, 0
    iv = []
    outside = 0
    for s, e, name in dev[1:]:
        if s < w0 or e > w1:
            outside += 1
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        iv.append((s, e))
        d = e - s
        total_ns += d
        by_op[name] = by_op.get(name, 0) + d
        if symbols and pat.search(name):
            hand_ns += d
    busy = _union(iv)
    busy_ns = sum(e - s for s, e in busy)
    gaps = []
    prev = w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((s - prev, prev, s))
        prev = max(prev, e)
    gaps.sort(reverse=True)
    placed = [(s + off, e + off, n) for s, e, n in spans]
    labelled = []
    for d, s, e in gaps[:10]:
        mid = (s + e) // 2
        inside = [sp for sp in placed if sp[0] <= mid < sp[1]]
        label = max(inside)[2] if inside else "outside any span"
        labelled.append([label, d / 1e9])
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_ns / 1e9,
            "device_s": total_ns / 1e9, "hand_s": hand_ns / 1e9,
            "device_ops": [[n[:160], v / 1e9] for n, v in ops],
            "idle_gaps": labelled, "n_device_events": len(dev) - 1,
            "n_outside": outside, "marker": dev[0][2][:80]}


class Readings:
    """What the metric readers read (metrics/*.py)."""

    def __init__(self, spans, batches: float, device: dict | None,
                 kernel_bound_s: float | None, device_batches: float = 0,
                 seconds: float = 0.0):
        """spans, batches and seconds: the host window's; device
        (analyse's), kernel_bound_s and device_batches: the device
        window's."""
        self.spans = spans
        self.batches = batches
        self.seconds = seconds
        self.device = device
        self.kernel_bound_s = kernel_bound_s
        self.device_batches = device_batches

    def span_ms_per_batch(self, name: str):
        if not self.spans.calls.get(name) or not self.batches:
            return None
        return 1e3 * self.spans.self_s[name] / self.batches
