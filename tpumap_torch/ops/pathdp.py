"""Chain DP path solver and end trimming (port of tpumap/ops/pathdp.py).

`chain_solve` solves each read against its candidate diagonals with one
local-alignment DP over query positions (extend, open, or jump from a
genomically earlier diagonal through a deletion or a scored intron, or
from a later one through an insertion), then walks the choices back to
the segments. It runs in two parts:

- `chain_inputs`, plain torch: sorted diagonals, the per-base score s,
  the donor and acceptor dinucleotides, the mismatch mask and the
  known-site bits (known splicing, -s), each [R, K, L];
- the DP and its traceback: `chain_dp` launches kernel K5
  (csrc/chain.cu) for CUDA tensors; `chain_dp_plain` beside it, which
  runs for CPU tensors, is tpumap's two lax.scans as Python loops over
  [R, K, K] tensors with the same int32 arithmetic and tie rules.

`trim_ends` and `_trim_scan` re-express the reference's
Spliceends_trim_qstart/qend scoring with prefix scans over the
per-base mismatch mask.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from tpumap_torch import kernels
from tpumap_torch.gsnap.knownsplicing import coords_in_set
from tpumap_torch.ops import verify
from tpumap_torch.ops.u32 import INT32_MIN, INVALID, MASK32, take_along

NEG = -(2 ** 20)
MAX_SEGMENTS = 8        # segments kept per read (tpumap's S)

# dinucleotide codes (2-bit base codes a=0 c=1 g=2 t=3, hi*4+lo)
_GT, _AG, _GC, _AT, _CT, _AC = 11, 2, 9, 3, 7, 1
# known-site bits of chain_inputs()["known"]
KNOWN_DONOR, KNOWN_ACCEPTOR, KNOWN_ANTIDONOR, KNOWN_ANTIACCEPTOR = 1, 2, 4, 8


@dataclass(frozen=True)
class PathScoring:
    """Integer scores, scaled so one match = +8 (a JAX-free copy of
    tpumap.ops.pathdp.PathScoring, field for field)."""
    match: int = 8
    mismatch: int = -24
    del_open: int = -24          # 1-base deletion
    del_extend: int = -8         # per additional deleted base
    splice_base: int = -90       # noncanonical junction
    bonus_gtag: int = 50
    bonus_gcag: int = 40
    bonus_atac: int = 30
    bonus_known: int = 74        # net -16: known junctions open readily
    min_intron: int = 9
    max_intron: int = 200_000
    ins_open: int = -24          # insertion jump to an earlier diagonal
    ins_extend: int = -8
    max_insert: int = 6
    allow_noncanon: bool = True


def quality_mismatch_cost(quals: torch.Tensor) -> torch.Tensor:
    """Per-base mismatch cost from phred qualities (uint8[..., L]): Q30
    -> -24, low-quality bases nearly free."""
    q = torch.clamp(quals.to(torch.int32), max=40)
    return -(8 + torch.div(q * 8, 15, rounding_mode="floor"))


def chain_inputs(index, codes, nmask, lengths, diags,
                 scoring: PathScoring = PathScoring(), quals=None,
                 known=None) -> dict:
    """The DP's inputs (pathdp.py:137-215): diags int64[R, K] sorted
    (INVALID last); s int32[R, K, L] per-base score (0 past the read or
    on an INVALID lane); don and acc int32[R, K, L] dinucleotides (the
    pair at q, and the pair ending before q, 16 for q < 2); mm
    bool[R, K, L] mismatches; known uint8[R, K, L] site bits (KNOWN_*)
    of the genome position d + q, or None without known sites (a dict
    of knownsplicing.known_to_device)."""
    R, L = codes.shape
    dev = codes.device
    ds = torch.sort(diags, dim=1).values
    valid_k = ds != INVALID
    d0 = torch.where(valid_k, ds, 0)
    gwin = verify.extract_codes_window(index.genome_packed, d0, L + 1)
    mm = codes[:, None, :] != gwin[..., :L]
    if getattr(index, "genome_has_n", True):
        gn2 = verify.extract_bit_window(index.genome_nmask, d0,
                                        (L + 15) // 16)
        mm = mm | verify.mismatch_base_mask(gn2, L)
    mm = mm | nmask[:, None, :]
    inlen = torch.arange(L, device=dev)[None, :] < lengths[:, None]
    miscost = (quality_mismatch_cost(quals)[:, None, :] if quals is not None
               else scoring.mismatch)
    s = torch.where(mm, miscost, scoring.match).to(torch.int32)
    s = torch.where(inlen[:, None, :] & valid_k[..., None], s, 0)
    g = gwin.to(torch.int32)
    don = g[..., :L] * 4 + g[..., 1:L + 1]
    acc = torch.cat([torch.full((R, ds.shape[1], 2), 16, dtype=torch.int32,
                                device=dev), don[..., :L - 2]], dim=-1)
    kbits = None
    if known is not None:
        site = (d0[..., None] + torch.arange(L, device=dev)) & MASK32
        kbits = torch.zeros(site.shape, dtype=torch.uint8, device=dev)
        for name, bit in (("donor", KNOWN_DONOR),
                          ("acceptor", KNOWN_ACCEPTOR),
                          ("antidonor", KNOWN_ANTIDONOR),
                          ("antiacceptor", KNOWN_ANTIACCEPTOR)):
            kbits |= torch.where(coords_in_set(known[name], site), bit,
                                 0).to(torch.uint8)
    return {"diags": ds, "s": s, "don": don, "acc": acc, "mm": mm,
            "known": kbits}


def _pair_tables(ds: torch.Tensor, sc: PathScoring):
    """Per-row junction geometry [R, K', K] for a jump k' -> k, with
    gap = diag[k] - diag[k'] in uint32 wrap arithmetic."""
    gap = (ds[:, None, :] - ds[:, :, None]) & MASK32
    neg_gap = (-gap) & MASK32
    gap_small = torch.clamp(gap, max=sc.min_intron).to(torch.int32)
    nins = torch.clamp(neg_gap, max=sc.max_insert).to(torch.int32)
    valid_k = ds != INVALID
    return {
        "is_del": (gap >= 1) & (gap < sc.min_intron),
        "is_intron": (gap >= sc.min_intron) & (gap <= sc.max_intron),
        "del_cost": sc.del_open + sc.del_extend * torch.clamp(gap_small - 1,
                                                              min=0),
        "is_ins": (neg_gap >= 1) & (neg_gap <= sc.max_insert),
        "nins": nins,
        "ins_cost": sc.ins_open + sc.ins_extend * torch.clamp(nins - 1,
                                                              min=0),
        "pair_ok": valid_k[:, :, None] & valid_k[:, None, :],
    }


def _intron_bonus(dj, aj, kn_src, kn_dst, sc: PathScoring):
    """Splice bonus of donor dinucleotides dj [R, K', 1] against acceptor
    dinucleotides aj [R, 1, K]: the best canonical pair, or the known-site
    bonus."""
    sense_b = torch.where((dj == _GT) & (aj == _AG), sc.bonus_gtag,
                          torch.where((dj == _GC) & (aj == _AG), sc.bonus_gcag,
                                      torch.where((dj == _AT) & (aj == _AC),
                                                  sc.bonus_atac, 0)))
    anti_b = torch.where((dj == _CT) & (aj == _AC), sc.bonus_gtag,
                         torch.where((dj == _CT) & (aj == _GC), sc.bonus_gcag,
                                     torch.where((dj == _GT) & (aj == _AT),
                                                 sc.bonus_atac, 0)))
    bonus = torch.maximum(sense_b, anti_b)
    if kn_src is not None:
        pair = (((kn_src & KNOWN_DONOR) != 0) & ((kn_dst & KNOWN_ACCEPTOR) != 0)
                | ((kn_src & KNOWN_ANTIACCEPTOR) != 0)
                & ((kn_dst & KNOWN_ANTIDONOR) != 0))
        bonus = torch.maximum(bonus, torch.where(pair, sc.bonus_known, 0))
    return bonus


def chain_dp_plain(inp: dict, lengths: torch.Tensor,
                   scoring: PathScoring = PathScoring()) -> dict:
    """The chain DP and its traceback on chain_inputs(): tpumap's forward
    and reverse lax.scans (pathdp.py:217-411) step by step. Returns score,
    q_start, q_end, nsegs, nmm int32[R], seg_q int32[R, 8] and seg_diag
    int64[R, 8] (INVALID past nsegs)."""
    sc = scoring
    ds, s, don, acc, mmask = (inp["diags"], inp["s"], inp["don"], inp["acc"],
                              inp["mm"])
    known = inp["known"]
    R, K, L = s.shape
    S = MAX_SEGMENTS
    NI = sc.max_insert
    dev = s.device
    i32 = torch.int32
    t = _pair_tables(ds, sc)
    valid_k = ds != INVALID
    start_val = torch.where(valid_k, 0, NEG).to(i32)
    lengths = lengths.to(i32)

    H = torch.full((R, K), NEG, dtype=i32, device=dev)
    best_score = torch.full((R,), NEG, dtype=i32, device=dev)
    best_q = torch.zeros(R, dtype=i32, device=dev)
    best_k = torch.zeros(R, dtype=torch.int64, device=dev)
    recent = torch.zeros((R, K, NI), dtype=i32, device=dev)
    choices = torch.empty((L, R, K), dtype=torch.uint8, device=dev)
    for q in range(L):
        s_q = s[:, :, q]
        kn = known[:, :, q] if known is not None else None
        bonus = _intron_bonus(don[:, :, q][:, :, None],
                              acc[:, :, q][:, None, :],
                              None if kn is None else kn[:, :, None],
                              None if kn is None else kn[:, None, :], sc)
        intron_cost = sc.splice_base + bonus
        if not sc.allow_noncanon:
            intron_cost = torch.where(bonus > 0, intron_cost, NEG)
        # exact insertion correction: the scores H gathered on the old
        # diagonal for the n inserted bases [q-n, q)
        run = torch.cumsum(recent, dim=-1, dtype=i32)
        corr = torch.zeros_like(t["ins_cost"])
        for n in range(1, NI + 1):
            corr = torch.where(t["nins"] == n, run[..., n - 1][:, :, None],
                               corr)
        trans = torch.where(t["is_intron"], intron_cost,
                            torch.where(t["is_del"], t["del_cost"],
                                        torch.where(t["is_ins"],
                                                    t["ins_cost"] - corr,
                                                    NEG)))
        trans = torch.where(t["is_ins"] & (q < t["nins"] + 1), NEG, trans)
        trans = torch.where(t["pair_ok"] & (q >= 1), trans, NEG)
        jump = H[:, :, None] + trans.to(i32)
        switch_best, switch_arg = torch.max(jump, dim=1)
        best3 = torch.maximum(H, torch.maximum(start_val, switch_best))
        choice = torch.where(best3 == H, 0,
                             torch.where(best3 == start_val, 1,
                                         2 + switch_arg))
        active = (q < lengths)[:, None]
        H = torch.where(active, best3 + s_q, H)
        choices[q] = torch.where(active, choice, 0).to(torch.uint8)
        if NI:
            recent = torch.where(
                active[..., None],
                torch.cat([s_q[..., None], recent[..., :-1]], dim=-1),
                recent)
        row_best, row_k = torch.max(H, dim=1)
        # ties keep the latest co-optimal end
        upd = (row_best >= best_score) & (q < lengths)
        best_score = torch.where(upd, row_best, best_score)
        best_q = torch.where(upd, q, best_q)
        best_k = torch.where(upd, row_k, best_k)

    k_cur = best_k
    done = torch.zeros(R, dtype=torch.bool, device=dev)
    nsegs = torch.zeros(R, dtype=i32, device=dev)
    seg_q_rev = torch.zeros((R, S), dtype=i32, device=dev)
    seg_k_rev = torch.zeros((R, S), dtype=i32, device=dev)
    skip = torch.zeros(R, dtype=i32, device=dev)
    nmm = torch.zeros(R, dtype=i32, device=dev)
    ar_s = torch.arange(S, device=dev)
    for q in range(L - 1, -1, -1):
        inside = (q <= best_q) & ~done
        c = torch.gather(choices[q], 1, k_cur[:, None])[:, 0].to(torch.int64)
        is_start = inside & (c == 1)
        is_switch = inside & (c >= 2)
        event = is_start | is_switch
        slot = (ar_s[None, :] == nsegs[:, None]) & event[:, None]
        seg_q_rev = torch.where(slot, q, seg_q_rev)
        seg_k_rev = torch.where(slot, k_cur[:, None].to(i32), seg_k_rev)
        nsegs = nsegs + event.to(i32)
        # inserted query bases (the skip window below an insertion jump)
        # are not on the path's diagonal: they stay out of nmm
        on_path = inside & (skip == 0)
        mm_q = torch.gather(mmask[:, :, q], 1, k_cur[:, None])[:, 0]
        nmm = nmm + (on_path & mm_q).to(i32)
        skip = torch.where(inside, torch.clamp(skip - 1, min=0), skip)
        d_cur = torch.gather(ds, 1, k_cur[:, None])[:, 0]
        d_prev = torch.gather(ds, 1, torch.clamp(c - 2, 0, K - 1)[:, None])[:, 0]
        n_ij = (d_prev - d_cur) & MASK32
        ins_j = is_switch & (n_ij >= 1) & (n_ij <= sc.max_insert)
        skip = torch.where(ins_j, n_ij.to(i32), skip)
        k_cur = torch.where(is_switch, c - 2, k_cur)
        done = done | is_start

    # segments were recorded last-first; flip to ascending query order
    # (JAX's out-of-range take fills INT32_MIN / INVALID past slot S)
    flip = torch.clamp(nsegs[:, None] - 1 - ar_s[None, :], min=0)
    in_seg = ar_s[None, :] < nsegs[:, None]
    seg_q = torch.where(in_seg, take_along(seg_q_rev, flip, INT32_MIN), 0)
    seg_k = take_along(seg_k_rev, flip, INT32_MIN)
    seg_diag = torch.where(in_seg, take_along(ds, seg_k, INVALID), INVALID)
    return {"score": best_score, "q_start": seg_q[:, 0].contiguous(),
            "q_end": best_q + 1, "nsegs": nsegs, "seg_q": seg_q,
            "seg_diag": seg_diag, "nmm": nmm}


def chain_max_len(K: int) -> int:
    """The longest rows whose choice table K5 keeps in shared memory at
    K lanes: 28,984 steps up to 8 lanes, 7,194 up to 16. A block
    (csrc/chain.cu) holds one row a warp at 8 lanes and two at 16, each
    with its [L, lanes] choice bytes (padded to 16), a 16-deep ring of
    int32 sums per lane and its diagonals and segments in shared memory,
    within the H100's 227 KiB a block. Longer rows put the table in a
    global [R, L, lanes] scratch (chain_dp); this is only the threshold
    between the two placements."""
    G, rows = (8, 1) if K <= 8 else (16, 2)
    fixed = 16 * G * 4 + G * 4 + MAX_SEGMENTS * 4
    return (227 * 1024 // rows - fixed) // 16 * 16 // G


def chain_dp(inp: dict, lengths: torch.Tensor,
             scoring: PathScoring = PathScoring()) -> dict:
    """chain_dp_plain for CPU tensors; kernel K5 for CUDA. The kernel
    reads chain_inputs' [R, K, L] tensors as they are, with 32 threads
    per row up to 8 lanes (4 per candidate) and 16 up to 16 lanes; K is
    8 lanes, or 14 with known splicing's partner diagonals. It takes any
    L >= 2: rows longer than chain_max_len(K) keep their choice table in
    a global scratch of R * L * lanes bytes allocated here."""
    s = inp["s"]
    if s.device.type == "cpu":
        return chain_dp_plain(inp, lengths, scoring)
    sc = scoring
    R, K, L = s.shape
    dev = s.device
    S = MAX_SEGMENTS
    known = inp["known"]
    kernels.check_args("chain_dp", dev,
                       (inp["diags"], torch.int64, (R, K)),
                       (s, torch.int32, (R, K, L)),
                       (inp["don"], torch.int32, (R, K, L)),
                       (inp["acc"], torch.int32, (R, K, L)),
                       (inp["mm"], torch.bool, (R, K, L)),
                       *(() if known is None
                         else ((known, torch.uint8, (R, K, L)),)),
                       (lengths, torch.int32, (R,)))
    if not 1 <= K <= 16 or not 0 <= sc.max_insert <= 8 or L < 2:
        raise ValueError(f"chain_dp: needs 1 <= K <= 16 candidates, "
                         f"max_insert <= 8 and L >= 2 (K = {K}, L = {L})")
    out = {"score": torch.empty(R, dtype=torch.int32, device=dev),
           "q_start": torch.empty(R, dtype=torch.int32, device=dev),
           "q_end": torch.empty(R, dtype=torch.int32, device=dev),
           "nsegs": torch.empty(R, dtype=torch.int32, device=dev),
           "seg_q": torch.empty((R, S), dtype=torch.int32, device=dev),
           "seg_diag": torch.empty((R, S), dtype=torch.int64, device=dev),
           "nmm": torch.empty(R, dtype=torch.int32, device=dev)}
    if R == 0:
        return out
    gtab = (torch.empty((R, L, 8 if K <= 8 else 16), dtype=torch.uint8,
                        device=dev) if L > chain_max_len(K) else 0)
    kernels.launch(
        "chain_dp", dev, inp["diags"], s, inp["don"], inp["acc"], inp["mm"],
        known if known is not None else 0, lengths, R, K, L,
        sc.del_open, sc.del_extend, sc.splice_base, sc.bonus_gtag,
        sc.bonus_gcag, sc.bonus_atac, sc.bonus_known, sc.min_intron,
        sc.max_intron, sc.ins_open, sc.ins_extend, sc.max_insert,
        int(sc.allow_noncanon), gtab, out["score"], out["q_start"],
        out["q_end"], out["nsegs"], out["seg_q"], out["seg_diag"],
        out["nmm"])
    return out


def chain_solve(index, codes, nmask, lengths, diags,
                scoring: PathScoring = PathScoring(),
                with_quals: bool = False, quals=None, known=None) -> dict:
    """Solve each read (codes uint8[R, L] in the aligned orientation,
    nmask bool[R, L], lengths int32[R]) against its candidate diagonals
    int64[R, K] (INVALID-padded, any order), with the known-site bonus
    where known (a dict of knownsplicing.known_to_device) is given.
    Returns the dict of chain_dp_plain."""
    inp = chain_inputs(index, codes, nmask, lengths, diags, scoring,
                       quals if with_quals else None, known)
    return chain_dp(inp, lengths, scoring)


def _cat_last(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.cat([a, b], dim=-1)


def _trim_scan(scores, mask, redemption, interval_len, idx, descending):
    """One direction of the end-trim scan over mismatch positions: track
    the running max (>= updates), stop at the first mismatch with
    score < max and score + redemption < 0, keep the full interval when
    the best trim is the last-scanned mismatch or the whole interval
    scores at least as well. Returns (best_pos int32, keep_full)."""
    L = scores.shape[-1]
    sc = torch.where(mask, scores, NEG)
    negcol = torch.full((*sc.shape[:-1], 1), NEG, dtype=sc.dtype,
                        device=sc.device)
    if descending:
        runmax_incl = torch.cummax(sc.flip(-1), dim=-1).values.flip(-1)
        runmax_excl = _cat_last(runmax_incl[..., 1:], negcol)
    else:
        runmax_incl = torch.cummax(sc, dim=-1).values
        runmax_excl = _cat_last(negcol, runmax_incl[..., :-1])
    term = mask & (scores < runmax_excl) & (scores + redemption < 0)
    any_term = term.any(dim=-1)
    if descending:
        first_term = torch.where(term, idx, -1).max(dim=-1).values
        allowed = mask & (idx >= first_term[..., None])
    else:
        first_term = torch.where(term, idx, L).min(dim=-1).values
        allowed = mask & (idx <= first_term[..., None])
    best_sc = torch.where(allowed, scores, NEG).max(dim=-1).values
    is_best = allowed & (scores == best_sc[..., None])
    if descending:
        best_pos = torch.where(is_best, idx, L).min(dim=-1).values
        j_star = (mask & (idx > best_pos[..., None])).sum(dim=-1)
    else:
        best_pos = torch.where(is_best, idx, -1).max(dim=-1).values
        j_star = (mask & (idx < best_pos[..., None])).sum(dim=-1)
    m = mask.sum(dim=-1)
    keep1 = ~any_term & (j_star == m - 1)
    keep2 = ~any_term & (interval_len - 4 * m >= best_sc)
    return best_pos.to(torch.int32), (m == 0) | keep1 | keep2


def trim_ends(mm: torch.Tensor, lengths: torch.Tensor,
              match: int = 8, mismatch: int = -24):
    """mm bool[B, L] per-base mismatch flags (aligned orientation) ->
    (q_start, q_end, score, nmm_inside) int32[B]: qstart is trimmed over
    [0, len) first, then qend over [qstart, len)."""
    L = mm.shape[-1]
    i32 = torch.int32
    idx = torch.arange(L, dtype=i32, device=mm.device)
    li = lengths.to(i32)
    mask = mm & (idx < li[..., None])
    maski = mask.to(i32)
    cnt_incl = torch.cumsum(maski, dim=-1, dtype=i32)
    cnt_excl = cnt_incl - maski
    m_tot = mask.sum(dim=-1, dtype=i32)

    # qstart: scan mismatches from the 3' end leftward
    right_excl = m_tot[..., None] - cnt_incl
    sc_start = (li[..., None] - idx - 1) - 4 * right_excl
    best_p, keep_full = _trim_scan(sc_start, mask, idx + 1, li, idx,
                                   descending=True)
    q_start = torch.minimum(torch.where(keep_full, 0, best_p + 1), li)

    # qend: scan mismatches in [q_start, len) rightward
    mask2 = mask & (idx >= q_start[..., None])
    zero = torch.zeros((*mask.shape[:-1], 1), dtype=i32, device=mm.device)
    pref = _cat_last(zero, cnt_incl)
    cnt_at_qs = torch.gather(pref, -1, q_start[..., None].to(torch.int64))
    sc_end = (idx - q_start[..., None]) - 4 * (cnt_excl - cnt_at_qs)
    best_p2, keep_full2 = _trim_scan(sc_end, mask2, li[..., None] - idx,
                                     li - q_start, idx, descending=False)
    q_end = torch.maximum(torch.where(keep_full2, li, best_p2), q_start)

    nmm_in = (torch.gather(pref, -1, q_end[..., None].to(torch.int64))
              - torch.gather(pref, -1, q_start[..., None].to(torch.int64))
              )[..., 0]
    alen = q_end - q_start
    score = match * (alen - nmm_in) + mismatch * nmm_in
    return (q_start.to(i32), q_end.to(i32), score.to(i32), nmm_in.to(i32))
