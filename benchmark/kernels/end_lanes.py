"""K8 (csrc/ends.cu), one launch: a lower bound of chip_smoke.py
ends_work: each read's end bases (up to 2 (k + iv - 1) of them) and its
length, each end k-mer's two offsets, the output lanes; 4 integer
operations a k-mer base (the positions' bytes and the selection's
operations, which depend on the table, are left out). Launch arguments:
codes [B, L], lengths, offsets/positions and their lengths x 4, genome,
its words, packed2, W, B, L, k, NE // 2, occ, K, ..., out."""


def capture(a):
    out = a[-1]
    return {"B": a[14], "k": a[16], "half": a[17], "lengths": a[1],
            "out_bytes": out.numel() * out.element_size()}


def work(c):
    import torch
    B, k, half = c["B"], c["k"], c["half"]
    NE = 2 * half
    lengths = c["lengths"]
    span = 2 * (k + half - 1)
    code_bytes = int(torch.clamp(lengths, 0, span).sum())
    n_ok = int((lengths >= k).sum())
    nbytes = code_bytes + 4 * B + 8 * 2 * NE * n_ok + c["out_bytes"]
    return nbytes, 2 * NE * n_ok * k * 4, 0
