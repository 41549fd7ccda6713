"""Shared by the three window scans (K6a, K6b, K6c; csrc/localscan.cu):
their launch arguments are genome, its words, win_starts [R], frag [R,
F], frag_lens [R] or 0, R, F, window, top_k, extra, pos, val or 0,
count or 0. Bytes: each row's start, fragment and length (the genome
words of the windows are left out: a lower bound); the active rows are
those with a fragment (all where there are no lengths)."""


def capture_scan(a):
    return {"R": a[5], "F": a[6], "window": a[7], "top_k": a[8],
            "flen": a[4]}


def counts(c):
    """(active rows, their sum of 2 f + 2 over fragment lengths f or
    None where the launch has no lengths)."""
    flen, F = c["flen"], c["F"]
    if isinstance(flen, int):
        return c["R"], None
    import torch
    f = torch.clamp(flen, 0, F).to(torch.int64)
    return int((flen > 0).sum()), int((2 * f + 2)[flen > 0].sum())


def scan_bytes(c):
    R, F = c["R"], c["F"]
    lens = not isinstance(c["flen"], int)
    return 8 * R + R * F + (4 * R if lens else 0) + 12 * R * c["top_k"]
