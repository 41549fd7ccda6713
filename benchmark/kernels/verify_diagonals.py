"""K1 (csrc/verify.cu), one launch: the work these inputs need, each input
word read once (chip_smoke.py verify_work): the reads' packed words and N
masks, their lengths and diagonals, and each valid lane's W + 1 genome
words (and N-mask words where the genome has Ns; twice the genome words
with the alternate genome); 4 integer operations and one popcount a lane
word. Launch arguments: genome, its words, N mask, its words, alt
genome, its words, read words [B, W], read N words [B, W], lengths [B],
diagonals [B, C], B, W, C, genome_has_n, ..., out [B, C]."""
INVALID = 0xFFFFFFFF


def capture(a):
    return {"B": a[10], "W": a[11], "C": a[12], "has_n": a[13],
            "alt": a[4] is not None, "diags": a[9]}


def work(c):
    B, W, C = c["B"], c["W"], c["C"]
    lanes = int((c["diags"] != INVALID).sum())
    win = lanes * (W + 1) * 4 * (2 if c["alt"] else 1)
    if c["has_n"]:
        win += lanes * (W // 2 + 1) * 4
    nbytes = 2 * B * W * 4 + 4 * B + 8 * B * C + win + 4 * B * C
    return nbytes, 4 * lanes * W, lanes * W
