"""K4 (csrc/trim.cu), one launch (chip_smoke.py trim_work): each row's
codes and N flags below its length, its length, strand and diagonal, the
W + 1 genome words and W / 2 + 2 N-mask words of a valid row's window
(twice the genome words with the alternate genome), the kept qualities;
~60 integer operations a row word, ~20 a mismatch, 3 a kept quality, 6
popcounts a row word. Launch arguments: genome, its words, N mask, its
words, alt genome, its words, codes [B, L], nm, lengths, strand, diag,
quals or None, B, L, W, has_n, ..., scratch, out [4 or 6, B]."""
INVALID = 0xFFFFFFFF


def capture(a):
    return {"B": a[12], "W": a[14], "has_n": a[15], "alt": a[4] is not None,
            "quals": a[11] is not None, "lengths": a[8], "diag": a[10],
            "out": a[-1]}


def work(c):
    lengths, out = c["lengths"], c["out"]
    valid = int((c["diag"] != INVALID).sum())
    words = int(((lengths + 15) // 16).sum())
    kept = int((out[1] - out[0]).sum())
    nbytes = 2 * int(lengths.sum()) + 16 * c["B"] + valid * 4 * (
        (c["W"] + 1) * (2 if c["alt"] else 1)
        + ((c["W"] // 2 + 2) if c["has_n"] else 0))
    if c["quals"]:
        nbytes += kept
    nops = 60 * words + 20 * int(out[3].sum()) + (3 * kept if c["quals"]
                                                  else 0)
    return nbytes, nops, 6 * words
