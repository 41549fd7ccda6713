"""Anchor chaining for cDNA -> genomic-region alignment (port of
tpumap/ops/chain.py, GMAP's stage-2 analog).

Per problem (a query against a genome window): the window's k-mer index,
the query oligos' hits in it as (q, diag) anchors, the anchors collapsed
into diagonal runs ("segments"), and a max-plus DP over the top-S
segments for the best collinear chain. Every function takes a leading
problem dimension N (tpumap vmaps them).

Two hand kernels (csrc/gmapchain.cu) do the sequential and gather-heavy
parts for CUDA tensors; their plain versions beside them run for CPU
tensors:
- `region_anchors` (K7b): region_oligos + region_index +
  anchors_from_query at k <= 12 (the direct-address table branch);
- `chain_compact` (K7a): chain_segments + compact_chain.
`anchors_to_segments` stays torch ops.

Dtypes: oligos int64 (INVALID = 0xFFFFFFFF), anchor diagonals int32:
window positions and query positions stay below 2^20 (DIAG_BIAS), so
pos - q + DIAG_BIAS and ANCHOR_INVALID (0x7FFFFFFF) fit, with the values
of tpumap's uint32 diagonals.
"""
from __future__ import annotations

import torch

from tpumap_torch import kernels
from tpumap_torch.ops.u32 import INVALID, MASK32, stable_topk

NEG = -(2 ** 30)
DIAG_BIAS = 1 << 20  # keeps a leading query overhang's diagonal positive
ANCHOR_INVALID = 0x7FFFFFFF
QKEY_INVALID = 2 ** 30   # chain_segments' sort key of an invalid segment
KERNEL_MAX_K = 12        # K7b serves the direct-table branch
# K7b's slot table: 16-bit entries in shared memory up to 4^8 oligos and
# 65,535 query positions, else 32-bit entries in each persistent block's
# scratch, at most this many bytes of them
ANCHOR_TABLE_SCRATCH = 1 << 30
ANCHOR_CHUNK = (1024, 16384)  # K7b's chunks of window positions
# the most anchor lanes (N x Q x max_occ) a call may ask for: 16 GiB of
# diagonals and 4 GiB of flags, a quarter of an 80 GB card
ANCHOR_MAX_LANES = 1 << 32
# K7a looks up the cost of every gap below min(max_intron, this) in a
# table it fills once a device (2 MB at the default 500,000); it computes
# the cost of a larger gap in the step
GAP_TABLE_MAX = 1 << 26
_gap_tables = {}


def check_anchor_lanes(N: int, Q: int, max_occ: int) -> None:
    """Raise where the [N, Q, max_occ] anchors cannot be held (both
    region_anchors paths, so the CPU and the card refuse alike)."""
    if not 1 <= max_occ < 2 ** 31 or N * Q * max_occ > ANCHOR_MAX_LANES:
        raise ValueError(
            f"region_anchors: [N, Q, max_occ] = [{N}, {Q}, {max_occ}] "
            f"anchors exceed {ANCHOR_MAX_LANES} lanes or max_occ is "
            f"outside [1, 2^31)")


def rolled_oligos(codes: torch.Tensor, valid: torch.Tensor, k: int):
    """(int64[N, L] oligos, bool ok): the oligo starting at every
    position as tpumap rolls it (engine.py:136-141, chain.py:31-47),
    leftmost base in the high bits; ok where its k bases are valid and
    the window does not wrap past the end."""
    L = codes.shape[-1]
    acc = torch.zeros(codes.shape, dtype=torch.int64, device=codes.device)
    ok = torch.ones(codes.shape, dtype=torch.bool, device=codes.device)
    for j in range(k):
        acc = ((acc << 2) & MASK32) | torch.roll(codes, -j, -1).to(
            torch.int64)
        ok = ok & torch.roll(valid, -j, -1)
    return acc, ok & (torch.arange(L, device=codes.device) < L - k + 1)


def region_oligos(codes: torch.Tensor, valid: torch.Tensor,
                  k: int) -> torch.Tensor:
    """[N, R] uint8 codes -> int64[N, R] oligos, INVALID where the
    k-window leaves the valid region or wraps past the end."""
    acc, ok = rolled_oligos(codes, valid, k)
    return torch.where(ok, acc, INVALID)


def region_index(codes: torch.Tensor, valid: torch.Tensor, k: int):
    """The window's k-mer index: (oligos, positions) int64[N, R] sorted
    by oligo, positions increasing within an oligo (tpumap's lax.sort
    keeps that order on the CPU; a stable sort here)."""
    return torch.sort(region_oligos(codes, valid, k), dim=-1, stable=True)


def anchors_from_query(sorted_oligos, sorted_pos, q_oligos, q_valid,
                       max_occ: int, keep_overabundant: bool = False,
                       k: int | None = None):
    """For each query oligo, up to max_occ window positions as anchors:
    (diag int32[N, Q, max_occ] = pos - q + DIAG_BIAS, ANCHOR_INVALID where
    not ok; q int32[N, Q, max_occ]; ok bool). An oligo with more than
    max_occ hits is dropped, or with keep_overabundant keeps its first
    max_occ hits. k <= 12 finds each oligo's hits through a 4^k start
    and count table, larger k by binary search (tpumap chain.py:63-116)."""
    N, R = sorted_oligos.shape
    Q = q_oligos.shape[-1]
    dev = sorted_oligos.device
    if k is not None and k <= 12:
        T = 1 << (2 * k)
        i = torch.arange(R, device=dev).expand(N, R)
        so_i = torch.clamp(sorted_oligos, max=T)
        prev = torch.cat([torch.full((N, 1), -1, dtype=so_i.dtype,
                                     device=dev), so_i[:, :-1]], dim=1)
        # non-first entries go to the dump row T (its count is zeroed)
        starts = torch.zeros((N, T + 1), dtype=torch.int64, device=dev)
        starts.scatter_(1, torch.where(so_i != prev, so_i, T), i)
        counts = torch.zeros((N, T + 1), dtype=torch.int64, device=dev)
        counts.scatter_add_(1, so_i, torch.ones_like(so_i))
        counts[:, T] = 0
        qo = torch.clamp(q_oligos, max=T)
        start = torch.gather(starts, 1, qo)
        count = torch.gather(counts, 1, qo)
    else:
        start = torch.searchsorted(sorted_oligos, q_oligos, side="left")
        count = torch.searchsorted(sorted_oligos, q_oligos,
                                   side="right") - start
    lane = torch.arange(max_occ, device=dev)
    idx = torch.clamp(start[..., None] + lane, 0, R - 1)
    pos = torch.gather(sorted_pos, 1, idx.reshape(N, -1)).reshape(idx.shape)
    in_count = lane < count[..., None]
    if keep_overabundant:
        ok = q_valid[..., None] & in_count
    else:
        ok = (q_valid & (count <= max_occ))[..., None] & in_count
    q = torch.arange(Q, dtype=torch.int32, device=dev)
    diag = torch.where(ok, pos - q[:, None] + DIAG_BIAS, ANCHOR_INVALID)
    return (diag.to(torch.int32), q[:, None].expand(N, Q, max_occ), ok)


def region_anchors_plain(r_codes, r_valid, q_oligos, q_valid, k: int,
                         max_occ: int, keep_overabundant: bool = False):
    """The window's index and the query's anchors in it, tpumap's three
    functions in turn: (diag, q, ok) as anchors_from_query."""
    check_anchor_lanes(r_codes.shape[0], q_oligos.shape[-1], max_occ)
    so, sp = region_index(r_codes, r_valid, k)
    return anchors_from_query(so, sp, q_oligos, q_valid, max_occ,
                              keep_overabundant, k)


def anchor_chunks(N: int, R: int, n_sms: int):
    """K7b's chunk of window positions and chunks a window: the largest
    power of two in ANCHOR_CHUNK whose N x chunks still gives every SM
    two work items, so a long window spreads over the card and many
    short ones go one to a chunk."""
    C, top = ANCHOR_CHUNK
    while C < min(R, top) and N * -(-R // (2 * C)) >= 2 * n_sms:
        C *= 2
    return C, max(1, -(-R // C))


def region_anchors(r_codes, r_valid, q_oligos, q_valid, k: int,
                   max_occ: int, keep_overabundant: bool = False):
    """region_anchors_plain for CPU tensors; for CUDA kernel K7b where
    k <= 12, and the torch version of tpumap's searchsorted branch on
    the card for larger k (a setting no entry point uses). r_codes
    uint8[N, R], r_valid bool[N, R], q_oligos int64[N, Q], q_valid
    bool[N, Q]. K7b is four kernels a call (count, scan, place, fill;
    csrc/gmapchain.cu) over chunks of C window positions, with their
    scratch from here, in one allocation: each chunk's count a slot
    pair (two 16-bit counts a word; a 32-bit word a slot for max_occ >
    254), its hits (slot, position), their number, each query position's
    slot and each slot's total, and with the 32-bit slot table each
    persistent block's table."""
    dev = r_codes.device
    if dev.type == "cpu" or k > KERNEL_MAX_K:
        return region_anchors_plain(r_codes, r_valid, q_oligos, q_valid, k,
                                    max_occ, keep_overabundant)
    N, R = r_codes.shape
    Q = q_oligos.shape[-1]
    qo = q_oligos.to(torch.int32)
    kernels.check_args("region_anchors", dev, (r_codes, torch.uint8, None),
                       (r_valid, torch.bool, (N, R)),
                       (qo, torch.int32, (N, Q)),
                       (q_valid, torch.bool, (N, Q)))
    check_anchor_lanes(N, Q, max_occ)
    if k < 1:
        raise ValueError(f"region_anchors: needs k >= 1 (k = {k})")
    diag = torch.empty((N, Q, max_occ), dtype=torch.int32, device=dev)
    ok = torch.empty((N, Q, max_occ), dtype=torch.bool, device=dev)
    q = torch.arange(Q, dtype=torch.int32, device=dev)[:, None].expand(
        N, Q, max_occ)
    if N == 0 or Q == 0:
        return diag, q, ok
    n_sms = kernels.n_sms(dev)
    C, nch = anchor_chunks(N, R, n_sms)
    T = 1 << (2 * k)
    gt = k > 8 or Q > 0xFFFF
    # the count pass's persistent blocks: one an SM (its shared table)
    G = min(N * nch, n_sms)
    if gt:
        G = max(1, min(G, ANCHOR_TABLE_SCRATCH // (4 * T)))
    # the scratch in one allocation, the int2 hits first (aligned)
    Qw = Q if max_occ > 254 else (Q + 1) // 2   # count words a chunk
    sizes = (N * max(R, 1) * 2, N * nch * Qw, N * nch, N * Q,
             N * Q, G * T if gt else 1)
    hits, cnt, nhit, rep, tot, table = torch.empty(
        sum(sizes), dtype=torch.int32, device=dev).split(sizes)
    kernels.launch("region_anchors", dev, r_codes, r_valid, qo, q_valid,
                   N, R, Q, k, max_occ, int(keep_overabundant), C, G,
                   int(gt), cnt, hits, nhit, rep, tot, table, diag, ok)
    return diag, q, ok


def anchors_to_segments(diag, q, ok, n_segments: int, k: int,
                        max_qgap: int = 24) -> dict:
    """Collapse anchors into diagonal runs and keep the top n_segments by
    anchor count (tpumap chain.py:119-163). A segment is a maximal set
    of anchors on one diagonal with successive q gaps <= max_qgap.
    Returns int32[N, S] diag (biased), qstart, qend (inclusive anchor
    starts), weight (anchor count) and bool valid."""
    N = diag.shape[0]
    d = diag.reshape(N, -1).to(torch.int64)
    qq = q.reshape(N, -1).to(torch.int64)
    o = ok.reshape(N, -1)
    dev = d.device
    F = d.shape[1]
    # tpumap's two-key (diag, q) co-sort, invalid anchors last, as one
    # int64 key: diag < 2^32 and q < 2^31; (diag, q) pairs of valid
    # anchors are unique, invalid ones carry no payload
    key = (torch.where(o, d, INVALID) << 31) | qq
    perm = torch.sort(key, dim=1).indices
    d = torch.gather(d, 1, perm)
    qq = torch.gather(qq, 1, perm)
    o = torch.gather(o, 1, perm)
    d = torch.where(o, d, ANCHOR_INVALID)
    prev_d = torch.cat([torch.full((N, 1), ANCHOR_INVALID, dtype=d.dtype,
                                   device=dev), d[:, :-1]], dim=1)
    prev_q = torch.cat([torch.full((N, 1), -10 ** 6, dtype=qq.dtype,
                                   device=dev), qq[:, :-1]], dim=1)
    is_start = ((d != prev_d) | (qq - prev_q > max_qgap)) & o
    i = torch.arange(F, device=dev).expand(N, F)
    run_start = torch.cummax(torch.where(is_start, i, 0), dim=1).values
    nxt_start = torch.cat([is_start[:, 1:] | ~o[:, 1:],
                           torch.ones_like(o[:, :1])], dim=1)
    is_last = o & nxt_start
    weight = torch.where(is_last, i - run_start + 1, 0).to(torch.int32)
    qstart = torch.gather(qq, 1, run_start)
    seg_w, seg_idx = stable_topk(weight, n_segments)
    valid = seg_w > 0

    def pick(x):
        return torch.where(valid, torch.gather(x, 1, seg_idx),
                           0).to(torch.int32)
    return {"diag": pick(d), "qstart": pick(qstart), "qend": pick(qq),
            "weight": seg_w.contiguous(), "valid": valid}


def gap_cost(x: torch.Tensor) -> torch.Tensor:
    """float32 log1p(x) * 0.01 of non-negative int x, log1p correctly
    rounded to float32 (through float64) so the CPU, the card and
    K7a give the same value (tpumap's float32 log1p on XLA's CPU differs
    from it by one ulp at about 0.8% of integers)."""
    return torch.log1p(x.to(torch.float64)).to(torch.float32) * 0.01


def chain_segments(segs: dict, max_intron: int = 500_000,
                   max_qoverlap_frac: float = 0.5):
    """The best collinear chain of segments (tpumap chain.py:166-232):
    segments ordered by qstart (stable), then a max-plus DP over j where
    j may follow i iff qstart_j > qstart_i, the genomic order holds with
    a gap under max_intron and the query overlap is small; score = the
    segment weights less a log1p gap cost; a backtrack from the first
    best end. Returns (order int64[N, S] by qstart, in_chain bool[N, S]
    over that order)."""
    valid0 = segs["valid"]
    N, S = valid0.shape
    dev = valid0.device
    qkey = torch.where(valid0, segs["qstart"], QKEY_INVALID)
    order = torch.sort(qkey, dim=1, stable=True).indices

    def by_q(x):
        return torch.gather(x, 1, order)
    diag, qs, qe = by_q(segs["diag"]), by_q(segs["qstart"]), by_q(segs["qend"])
    w, valid = by_q(segs["weight"]), by_q(valid0)
    gs, ge = diag + qs, diag + qe
    span = torch.clamp(qe - qs + 1, min=1)
    scores = torch.full((N, S), float(NEG), dtype=torch.float32, device=dev)
    prevs = torch.full((N, S), -1, dtype=torch.int64, device=dev)
    for j in range(S):
        cj = slice(j, j + 1)
        overlap = torch.clamp(qe - qs[:, cj] + 1, min=0)
        lim = (torch.minimum(span, span[:, cj]).to(torch.float32)
               * max_qoverlap_frac).to(torch.int32)
        allowed = ((qs[:, cj] > qs) & (gs[:, cj] > ge)
                   & (gs[:, cj] - ge < max_intron) & (overlap < lim)
                   & valid & valid[:, cj])
        cand = torch.where(allowed, scores - gap_cost(
            torch.abs(gs[:, cj] - ge)), float(NEG))
        best = cand.max(dim=1).values
        bestp = torch.argmax(cand, dim=1)       # the first maximum
        scores[:, j] = torch.where(
            valid[:, j], w[:, j].to(torch.float32) + torch.clamp(best,
                                                                 min=0.0),
            float(NEG))
        prevs[:, j] = torch.where(best > 0, bestp, -1)
    cur = torch.argmax(scores, dim=1)
    in_chain = torch.zeros((N, S), dtype=torch.bool, device=dev)
    rows = torch.arange(N, device=dev)
    for _ in range(S):
        live = cur >= 0
        if not bool(live.any()):
            break
        c = torch.clamp(cur, min=0)
        in_chain[rows[live], c[live]] = True
        cur = torch.where(live, prevs[rows, c], -1)
    return order, in_chain


def compact_chain(segs: dict, order, in_chain, m: int):
    """The chain's valid members in q order, the first m of them:
    (diag, qstart, qend int32[N, min(S, m)], ok bool) with zeros past
    the members (tpumap engine.py:165-184 at CHAIN_M = m)."""
    N, S = order.shape
    ar = torch.arange(S, device=order.device)
    key = torch.where(in_chain, ar, S + ar)
    perm = torch.argsort(key, dim=1)[:, :m]
    sel = torch.gather(order, 1, perm)
    ok = torch.gather(in_chain, 1, perm) & torch.gather(segs["valid"], 1, sel)

    def pick(x):
        return torch.where(ok, torch.gather(x, 1, sel), 0).to(torch.int32)
    return pick(segs["diag"]), pick(segs["qstart"]), pick(segs["qend"]), ok


def chain_compact_plain(segs: dict, m: int, max_intron: int = 500_000,
                        max_qoverlap_frac: float = 0.5):
    """chain_segments, then compact_chain."""
    order, in_chain = chain_segments(segs, max_intron, max_qoverlap_frac)
    return compact_chain(segs, order, in_chain, m)


def chain_wide_bytes(S: int) -> int:
    """Scratch bytes a problem of K7a's wide kernel (S > 1,024), as
    csrc/gmapchain.cu: chain_wide_bytes computes them: sort keys for
    S rounded up to a power of two, the sorted segments (two int4 each),
    scores, links and member bits, rounded up to 16."""
    L = 32
    while L < S:
        L *= 2
    b = 8 * L + 32 * S + 8 * S + 4 * (-(-S // 32))
    return -(-b // 16) * 16


def chain_compact(segs: dict, m: int, max_intron: int = 500_000,
                  max_qoverlap_frac: float = 0.5):
    """chain_compact_plain for CPU tensors; kernel K7a for CUDA: one
    warp a problem, the DP's S steps each a one-warp first-maximum
    reduction, the backtrack and the compaction in the same warp (past
    1,024 segments its arrays in a global scratch). Its table of gap
    costs (gap_cost of 0 .. min(max_intron, GAP_TABLE_MAX) - 1) is
    filled by the first call on a device for that size and kept; larger
    gaps are costed in the kernel."""
    valid = segs["valid"]
    dev = valid.device
    if dev.type == "cpu":
        return chain_compact_plain(segs, m, max_intron, max_qoverlap_frac)
    N, S = valid.shape
    kernels.check_args("chain_segments", dev,
                       *((segs[f], torch.int32, (N, S))
                         for f in ("diag", "qstart", "qend", "weight")),
                       (valid, torch.bool, (N, S)))
    if S < 1 or m < 1 or not -2 ** 31 <= max_intron < 2 ** 31:
        raise ValueError(f"chain_compact: needs S >= 1 segments, m >= 1 "
                         f"and an int32 max_intron (S = {S}, m = {m}, "
                         f"max_intron = {max_intron})")
    M = min(S, m)
    out = [torch.empty((N, M), dtype=torch.int32, device=dev)
           for _ in range(3)]
    ok = torch.empty((N, M), dtype=torch.bool, device=dev)
    if N:
        TG = min(max(0, max_intron), GAP_TABLE_MAX)
        tab = _gap_tables.get((dev, TG))
        fill = tab is None
        if fill:
            tab = torch.empty(max(TG, 1), dtype=torch.float32, device=dev)
        stride = chain_wide_bytes(S) if S > 1024 else 0
        scratch = (torch.empty(N * stride, dtype=torch.uint8, device=dev)
                   if stride else tab)
        kernels.launch("chain_segments", dev, segs["diag"], segs["qstart"],
                       segs["qend"], segs["weight"], valid, N, S, M,
                       max_intron, float(max_qoverlap_frac), tab, TG,
                       int(fill), scratch, stride, *out, ok)
        _gap_tables[(dev, TG)] = tab
    return (*out, ok)
