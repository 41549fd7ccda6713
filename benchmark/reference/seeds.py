"""The reference's own seeding: the genome's k-mers at every `interval`-th
position (GSNAP's sampling), from the genome's bases and not from the
program's index, matched against every k-mer of each read on both
strands; each diagonal they give is scored without gaps, with the best
clipping. Plain PyTorch, on whatever device it is given."""
from __future__ import annotations

import numpy as np
import torch

from reference.samcheck import MISMATCH


def kmer_codes(codes: torch.Tensor, k: int) -> torch.Tensor:
    """int64[n - k + 1] 2-bit codes of every k-mer of uint8 codes[n]."""
    n = codes.shape[-1] - k + 1
    out = torch.zeros(codes.shape[:-1] + (n,), dtype=torch.int64,
                      device=codes.device)
    for j in range(k):
        out = out * 4 + codes[..., j:j + n].to(torch.int64)
    return out


def best_ungapped(genome: torch.Tensor, reads: torch.Tensor, k: int,
                  interval: int, block: int = 1 << 26):
    """For each read (uint8[n, R] in genome orientation on the plus
    strand; the minus strand is its reverse complement) the best
    ungapped clipped alignment over the diagonals its k-mers hit:
    (score, strand, leftmost genome coordinate, first and one past the
    last aligned read base of the strand-oriented read), -1 where no
    k-mer hits."""
    dev = genome.device
    n, R = reads.shape
    strands = torch.stack([reads, 3 - reads.flip(1)], 1)      # [n, 2, R]
    qk = kmer_codes(strands, k).reshape(-1)                   # [n*2*(R-k+1)]
    nq = R - k + 1
    order = torch.argsort(qk)
    qs = qk[order]
    hits = []
    G = genome.shape[0]
    for lo in range(0, G - k + 1, block):
        lo -= lo % interval
        hi = min(lo + block + k - 1, G)
        gk = kmer_codes(genome[lo:hi], k)[::interval].contiguous()
        pos = lo + interval * torch.arange(gk.shape[0], device=dev)
        a = torch.searchsorted(qs, gk)
        b = torch.searchsorted(qs, gk, right=True)
        m = b > a
        if not bool(m.any()):
            continue
        a, b, pos = a[m], b[m], pos[m]
        cnt = b - a
        rep = torch.repeat_interleave(torch.arange(a.shape[0], device=dev),
                                      cnt)
        first = torch.cumsum(cnt, 0) - cnt
        idx = a[rep] + torch.arange(rep.shape[0], device=dev) - first[rep]
        q = order[idx]
        hits.append((q // nq, pos[rep] - q % nq))
    score = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best = torch.full((n, 4), -1, dtype=torch.int64, device=dev)
    if not hits:
        return score.cpu().numpy(), best.cpu().numpy()
    rs = torch.cat([h[0] for h in hits])          # read * 2 + strand
    diag = torch.cat([h[1] for h in hits])
    ok = (diag >= 0) & (diag + R <= G)
    key = torch.unique(rs[ok] * (1 << 32) + diag[ok])
    rs, diag = key >> 32, key & ((1 << 32) - 1)
    col = torch.arange(R, device=dev)
    win = genome[diag[:, None] + col[None, :]]
    q = strands.reshape(-1, R)[rs]
    val = torch.where(win == q, 1, -MISMATCH).to(torch.int64)
    P = torch.cat([torch.zeros_like(val[:, :1]), torch.cumsum(val, 1)], 1)
    low, arg = torch.cummin(P, 1)
    gain = P - low
    end = torch.argmax(gain, 1)
    sc = gain.gather(1, end[:, None])[:, 0]
    start = arg.gather(1, end[:, None])[:, 0]
    read = rs // 2
    # the best candidate of each read: sort by (read, score) and take the
    # last of each read's run
    o = torch.argsort(read * (4 * R + 8) + sc + 2 * R)
    last = torch.ones_like(o, dtype=torch.bool)
    last[:-1] = read[o][1:] != read[o][:-1]
    sel = o[last]
    r = read[sel]
    score[r] = sc[sel]
    best[r] = torch.stack([rs[sel] % 2, diag[sel] + start[sel], start[sel],
                           end[sel]], 1)
    return score.cpu().numpy(), best.cpu().numpy()


def to_device(codes: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(codes).to(device)
