"""K3 (csrc/traceback.cu), one launch (chip_smoke.py's K3 rows): R x S
direction bytes and the lengths read once, ~6 integer operations a step
of S = Lq + 2 band. Launch arguments: dirs [B, Lq, W], qlens, end_k, B,
Lq, W, band, maxruns, ops [B, S], ..."""


def capture(a):
    return {"B": a[3], "Lq": a[4], "band": a[6]}


def work(c):
    S = c["Lq"] + 2 * c["band"]
    return c["B"] * S + 8 * c["B"], 6 * c["B"] * S, 0
