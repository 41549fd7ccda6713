"""K2 (csrc/dp.cu), one launch (chip_smoke.py's K2 rows): bytes of the
query and genome codes and their lengths read once, the outputs written
once; ~12 integer operations a cell of the band (the affine-gap
recurrences, the cell maximum, the direction bits) over each problem's
query length. Launch arguments: qcodes [B, Lq], qlens, gcodes [B, Lg],
glens, B, Lq, Lg, band, ..., dirs [B, Lq, W], score, end_k, H_last."""


def capture(a):
    return {"B": a[4], "Lq": a[5], "Lg": a[6], "band": a[7], "qlens": a[1]}


def work(c):
    B, Lq, Lg, band = c["B"], c["Lq"], c["Lg"], c["band"]
    W = 2 * band + 1
    nbytes = B * Lq + 4 * B + B * Lg + 4 * B + B * Lq * W + 4 * B * (3 + W)
    return nbytes, 12 * W * int(c["qlens"].sum()), 0
