"""K5 (csrc/chain.cu), one launch (chip_smoke.py chain_work): its inputs
read once (diagonals, the score, donor, acceptor and mismatch tables,
known marks, lengths) and the operations these rows need: per active
step ~6 per transition between valid lanes and ~6 per valid lane.
Launch arguments: diags [R, K], s [R, K, L] int32, don, acc int32, mm
bool, known uint8 or 0, lengths [R], R, K, L, ..."""
INVALID = 0xFFFFFFFF


def capture(a):
    return {"R": a[7], "K": a[8], "L": a[9],
            "known": not isinstance(a[5], int), "diags": a[0],
            "lengths": a[6]}


def work(c):
    import torch
    R, K, L = c["R"], c["K"], c["L"]
    valid = (c["diags"] != INVALID).sum(1).to(torch.int64)
    steps = torch.clamp(c["lengths"], 0, L).to(torch.int64)
    nbytes = 8 * R * K + R * K * L * (4 * 3 + 1 + (1 if c["known"] else 0)) \
        + 4 * R
    return nbytes, 6 * int((steps * valid * (valid + 1)).sum()), 0
