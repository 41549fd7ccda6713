"""Segmented CUDA-graph replay of a function whose device work is a fixed
chain of launches (no host synchronisation, no shape that depends on a
value): the fused GSNAP ladder (gsnap/ladder.align_batch_full).

    g = SegmentedGraph(fn, inputs)      # capture: fn(static inputs)
    out = g(inputs)                     # copy inputs in, replay, out

The capture runs fn once under stream capture, cut at each hand-kernel
launch (kernels.launch): the torch ops between two launches are one graph
segment, all segments sharing one memory pool, and each launch is kept as
(name, device, args) and not run, since its inputs are not computed yet.
The args are the pool's tensors (kept alive here), so their addresses hold
on every replay. A replay copies the inputs into the static buffers, then
replays segment 0, makes launch 0 through `kernels.launch` looked up at
call time, replays segment 1, and so on, all on the current stream: every
hand kernel still goes through `kernels.launch` on every call, so its
LAUNCHES count and any wrapper installed on it see each real launch, and
a launch that did not run counts nothing.

The result is the pool's tensors, which the next replay of the same graph
overwrites: a caller copies it out on the same stream before the next
call, and stream order then keeps the copy ahead of the overwrite.
"""
from __future__ import annotations

import threading
import warnings

import torch

from tpumap_torch import kernels


class SegmentedGraph:
    """One captured call of fn(inputs: dict of tensors) -> result."""

    def __init__(self, fn, inputs: dict):
        self.inputs = {k: torch.empty_like(v) for k, v in inputs.items()}
        self.segments = []
        self.launches = []
        self.result = None
        device = next(iter(inputs.values())).device
        pool = torch.cuda.graph_pool_handle()
        real = kernels.launch
        owner = threading.get_ident()
        seg = torch.cuda.CUDAGraph()

        def cut(name, dev, *args):
            """Close the open segment, keep the launch, open the next."""
            nonlocal seg
            if threading.get_ident() != owner:
                return real(name, dev, *args)
            _end(seg)
            self.segments.append(seg)
            self.launches.append((name, dev, args))
            seg = torch.cuda.CUDAGraph()
            seg.capture_begin(pool=pool)

        torch.cuda.synchronize(device)
        stream = torch.cuda.Stream(device)
        kernels.launch = cut
        try:
            with torch.cuda.device(device), torch.cuda.stream(stream):
                seg.capture_begin(pool=pool)
                try:
                    self.result = fn(self.inputs)
                finally:
                    _end(seg)
            self.segments.append(seg)
        finally:
            kernels.launch = real

    def __call__(self, inputs: dict):
        """Replay on the current stream with inputs (the capture's keys,
        shapes and dtypes); returns the static result."""
        # stream order: the copies of the previous replay's result
        # (ladder.start_fetch) were queued on this stream before these
        # writes and the replay that overwrites it
        for k, buf in self.inputs.items():
            buf.copy_(inputs[k])
        for seg, (name, dev, args) in zip(self.segments, self.launches):
            seg.replay()
            kernels.launch(name, dev, *args)
        self.segments[-1].replay()
        return self.result


def _end(seg) -> None:
    """End a segment's capture. Two launches with no torch op between
    them leave an empty segment, which replays as a no-op: torch's
    warning on it is dropped."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The CUDA Graph is empty")
        seg.capture_end()
