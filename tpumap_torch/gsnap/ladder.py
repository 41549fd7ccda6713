"""Fused device ladder (port of tpumap/gsnap/ladder.py): cascade ->
chain stage (compaction, candidate lists, with known splicing the
partner diagonals of the known junction table, chain DP pass 1, kernel
K5) -> salvage (residual-clip compaction, the
read-end run scans K6c and middle-exon fragment scans K6a, dinucleotide
anchors, chain DP pass 2) -> acceptance -> indel stage gated on splice
failure (banded DP K2, traceback K3) -> ambiguous splice-end review
(task construction, exact-site scan K6b) -> secondary-candidate
compaction -> one result dict. `align_pair_full` is the paired
program: the same ladder over interleaved mates, keeping the candidate
lists for the concordance reduction (gsnap/paired.py).

All compaction sizes are fixed (top-k), so a batch is one asynchronous
chain of launches. With `rows` (parallel/pipeline.RowSplit, the
data-parallel MeshContext) every row-independent stage runs over row
chunks on the data devices while each compaction ranks the whole batch
once on the lead device, so the result equals the single-device one. `start_fetch`/`fetch_result` bring the dict to the
host with the key set and numpy dtypes that tpumap's host half reads
after widen_ints(device_fetch(...)).

Diagonals and genome coordinates are int64 values in [0, 2^32);
tpumap's uint32 wrap arithmetic is `(a - b) & MASK32` here.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from tpumap_torch.gsnap.engine import (AlignConfig,
                                       align_batch_cascaded_packed,
                                       indel_forward, indel_traceback,
                                       row_map)
from tpumap_torch.gsnap.params import (CLIP_INDEL_TRIGGER,
                                       CLIP_SPLICE_TRIGGER, INDEL_BAND,
                                       INDEL_MARGIN, INDEL_NMM_TRIGGER,
                                       SPLICE_NMM_TRIGGER)
from tpumap_torch.gsnap.spliceends import (AMB_MAX, BOUNDARY_SHIFTS, SCAN_W,
                                           TOP_ALTS)
from tpumap_torch.gsnap.spliceends import MIN_INTRON as AMB_MIN_INTRON
from tpumap_torch.ops import localscan, pack, pathdp, verify
from tpumap_torch.ops.dp import MAXRUNS
from tpumap_torch.ops.u32 import (INT32_MIN, INVALID, MASK32, stable_topk,
                                  take_along)
from tpumap_torch.utils.fetch import _WIRE_DTYPES, widen_ints
from tpumap_torch.utils.graphs import SegmentedGraph
from tpumap_torch.utils.trace import count, span, traced

SALVAGE_W = 65536         # localdb region scale (src/localdb-write.c)
SALVAGE_F = 16
MIN_FRAG = 6
N_PARTNER = 3             # known-junction partner diagonals per side

# wire dtypes (tpumap_torch/utils/fetch.py): uint16 fields travel as int16 bit
# patterns and are reinterpreted on the host
_TORCH_WIRE = {"uint8": torch.uint8, "int16": torch.int16,
               "uint16": torch.int16, "int8": torch.int8,
               "int32": torch.int32}


def _oriented_rows_dev(packed, pnmask, lengths, idx, strands, L):
    """Compacted rows as per-base codes and N flags in the aligned
    orientation (strand-1 rows reverse-complemented on the packed
    words); N-free batches send a (1, 1) pnmask stub."""
    p = packed[idx]
    li = lengths[idx]
    is_rc = (strands == 1)[:, None]
    codes = pack.unpack_reads(
        torch.where(is_rc, pack.revcomp_packed(p, li), p), L)
    if pnmask.shape == packed.shape:
        nm = pnmask[idx]
        nm = torch.where(is_rc, pack.revcomp_packed(nm, li, complement=False),
                         nm)
        nmask = pack.unpack_reads(nm, L).to(torch.bool)
    else:
        nmask = torch.zeros(codes.shape, dtype=torch.bool,
                            device=codes.device)
    return codes, nmask, li


def _dedup_keep_first(cands):
    """INVALID-out duplicate lanes, keeping lane positions."""
    n = cands.shape[1]
    ar = torch.arange(n, device=cands.device)
    dup = ((cands[:, None, :] == cands[:, :, None])
           & (ar[None, :] < ar[:, None])[None])
    return torch.where(dup.any(dim=2), INVALID, cands)


def _take_window(codes, starts, n: int, L: int):
    """codes[r, starts[r] : starts[r] + n] with clipping, uint8[R, n]."""
    idx = torch.clamp(starts.to(torch.int64)[:, None]
                      + torch.arange(n, device=codes.device)[None, :],
                      0, L - 1)
    return torch.gather(codes, 1, idx)


def _last(arr, nsegs, back: int, fill):
    """arr[r, max(nsegs - back, 0)] with JAX's out-of-range fill."""
    ix = torch.clamp(nsegs - back, min=0).to(torch.int64)[:, None]
    return take_along(arr, ix, fill)[:, 0]


def _ranked(need, k: int, signal=None):
    """Top-k compaction of the rows where `need`, as tpumap's lax.top_k
    priorities rank them: by signal (clipped to [0, 255]) if given, then
    in row order."""
    R = need.shape[0]
    ar = torch.arange(R, dtype=torch.int32, device=need.device)
    prio = (2 * R - ar if signal is None
            else torch.clamp(signal, 0, 255) * (2 * R) + (R - ar))
    return stable_topk(torch.where(need, prio, 0), k)[1]


def _on(known, device):
    """The known-splicing tables (a dict of tensors, or None) on device."""
    if known is None:
        return None
    return {k: v.to(device) for k, v in known.items()}


# BOUNDARY_SHIFTS int32[1, NS5] a device, built once: a CUDA graph
# cannot hold a copy from host memory
_SHIFTS: dict = {}


def _boundary_shifts(dev) -> torch.Tensor:
    t = _SHIFTS.get(dev)
    if t is None:
        t = _SHIFTS[dev] = torch.tensor(BOUNDARY_SHIFTS, dtype=torch.int32,
                                        device=dev)[None, :]
    return t


# the result dict's overflow scalars: rows a fixed-size compaction left out
OVERFLOWS = ("stage2_overflow", "indel_tb_overflow", "amb_row_overflow",
             "amb_task_overflow", "sec_overflow")


@traced("narrow")
def narrow_result(d: dict) -> dict:
    """Cast result fields to their wire dtypes (device side)."""
    return {k: (v.to(_TORCH_WIRE[_WIRE_DTYPES[k]]) if k in _WIRE_DTYPES
                else v) for k, v in d.items()}


def align_batch_full(index, pbatch, config: AlignConfig, L: int,
                     scoring: pathdp.PathScoring, splicing: bool,
                     salvage: bool, r_chain: int, r_salv: int,
                     r_indel: int, known=None, rows=None):
    """One batch through the fused ladder; a flat dict of device
    tensors: cascade fields, ch_* chain solutions of the r_chain
    compacted rows (splicing), in_* indel solutions, amb_* splice-end
    review hits (splicing), sec_* secondary candidates and the overflow
    counters. Compaction sizes as tpumap's driver passes them. With
    known (a dict of knownsplicing.known_to_device) this is tpumap's
    align_batch_full_known.

    Where graph_engages, the batch is a replay of the CUDA graph
    segments captured for its graph_key on the index (the first batch of
    a key captures them): the same kernels in the same order, and a
    result dict that the next batch of the key overwrites once its
    copies (start_fetch, on the same stream) are done."""
    args = (config, L, scoring, splicing, salvage, r_chain, r_salv, r_indel)
    if graph_engages(index, pbatch, config, known, rows):
        graph = _ladder_graph(index, pbatch, args)
        if graph is not None:
            count("ladder_graph_replays")
            return dict(graph(pbatch))
    count("ladder_eager")
    return _ladder_full(index, pbatch, *args, known=known, rows=rows)


def _ladder_full(index, pbatch, config, L, scoring, splicing, salvage,
                 r_chain, r_salv, r_indel, known=None, rows=None):
    """The ladder's launches, eagerly or under capture."""
    res = align_batch_cascaded_packed(index, pbatch, config, L, rows=rows)
    return narrow_result(refine_full(index, pbatch, res, config, L, scoring,
                                     splicing, salvage, r_chain, r_salv,
                                     r_indel, known=known, rows=rows))


# captured ladders kept a device index; a batch of a key past them runs
# eagerly
GRAPH_KEYS = 8


def graph_engages(index, pbatch, config: AlignConfig, known, rows) -> bool:
    """Whether a batch of align_batch_full replays CUDA graphs: one card
    (no rows), no known tables, standard mode without SNP tolerance, and
    the index and every input on the card. The others run eagerly: the
    modes copy host constants inside the ladder (ops/mode.py), and none
    of them has a cell that would show a gain."""
    return (rows is None and known is None and config.mode == "standard"
            and not config.snp_tolerant and index.device.type == "cuda"
            and all(t.device == index.device for t in pbatch.values()))


def graph_key(pbatch, args) -> tuple:
    """A captured ladder's key, by value: each input's name, dtype and
    shape (B, W, the pnmask stub or full mask, quals), and the run's
    config, L, scoring, splicing, salvage and compaction sizes, so that
    configs built anew by each align_records call share the key."""
    return (tuple((k, v.dtype, tuple(v.shape))
                  for k, v in sorted(pbatch.items())),) + tuple(args)


def _ladder_graph(index, pbatch, args):
    """The index's captured ladder of this batch's key, captured now if
    new; None where the key's capture failed (a warning, then eager for
    the rest of the run) or the index holds GRAPH_KEYS others. The
    graphs hold the index's pointers, so they live on the index."""
    cache = vars(index).setdefault("_ladder_graphs", {})
    key = graph_key(pbatch, args)
    if key in cache:
        return cache[key]
    if len(cache) >= GRAPH_KEYS:
        return None
    _config, _L, _scoring, splicing, *_ = args
    if splicing:
        _boundary_shifts(index.device)      # built outside the capture
    try:
        graph = SegmentedGraph(
            lambda pb: _ladder_full(index, pb, *args), pbatch)
        count("ladder_graph_captures")
    except RuntimeError as exc:
        warnings.warn(f"align_batch_full: CUDA graph capture failed, the "
                      f"ladder runs eagerly for this key ({exc})")
        count("ladder_graph_fallbacks")
        graph = None
    cache[key] = graph
    return graph


def _partners(known, adiag, li, max_intron: int):
    """Partner diagonals int64[R, 2 * N_PARTNER] implied by the known
    junction-pair table (ladder.py:211-239): a junction whose left
    boundary lies inside the read anchored at adiag gives adiag + intron,
    one whose right boundary lies inside gives adiag - intron; uint32
    wrap arithmetic throughout."""
    offs = torch.arange(N_PARTNER, device=adiag.device)[None, :]
    a = adiag[:, None]
    hi = (a + li.to(torch.int64)[:, None]) & MASK32

    def side(coords, introns, sign):
        pos = torch.searchsorted(coords, (adiag + 1) & MASK32)
        ji = torch.clamp(pos[:, None] + offs, 0, coords.shape[0] - 1)
        c = coords[ji]
        n = introns[ji]
        ok = (c > a) & (c < hi) & (n > 0) & (n <= max_intron)
        nu = n.to(torch.int64) & MASK32
        if sign > 0:
            part = (a + nu) & MASK32
        else:
            part = (a - nu) & MASK32
            ok &= a >= nu
        return torch.where(ok, part, INVALID)

    return torch.cat([side(known["jleft"], known["jleft_intron"], 1),
                      side(known["jright"], known["jright_intron"], -1)],
                     dim=1)


@traced("chain")
def _chain_stage(index, pbatch, res, L, sc, r_chain, r_salv, salvage,
                 trim_nmm, clip, known, rows=None):
    """Chain compaction, pass 1, optional salvage and pass 2. Returns
    (idx, sel, c1) for the compacted rows."""
    lengths = pbatch["lengths"]
    B = lengths.shape[0]
    diag = res["diag"]
    strand = res["strand"]
    rc = min(r_chain, B)
    chain_m = (diag != INVALID) & ((trim_nmm >= SPLICE_NMM_TRIGGER)
                                   | (clip >= CLIP_SPLICE_TRIGGER))
    # ranked by signal (clip + excess mismatches), batch order on ties
    idx = _ranked(chain_m, rc, clip + trim_nmm)
    sel = chain_m[idx]
    st = strand[idx]
    codes, nmask, li = _oriented_rows_dev(pbatch["packed"], pbatch["pnmask"],
                                          lengths, idx, st, L)
    adiag = diag[idx]
    # candidates: the cascade's ranked lists, same strand, deduplicated
    cands = torch.where(res["cand_strands"][idx] == st[:, None],
                        res["cand_diags"][idx], INVALID)
    if known is not None:
        cands = torch.cat([cands, _partners(known, adiag, li,
                                            sc.max_intron)], dim=1)
    cands = _dedup_keep_first(cands)
    quals = None
    if "quals" in pbatch:
        q = pbatch["quals"][idx]
        rev = torch.clamp(li.to(torch.int64)[:, None] - 1
                          - torch.arange(L, device=q.device)[None, :],
                          0, L - 1)
        quals = torch.where((st == 1)[:, None], torch.gather(q, 1, rev), q)
    c1 = row_map(rows, lambda ix, c, m, ln, d, q: pathdp.chain_solve(
        ix, c, m, ln, d, scoring=sc, with_quals=q is not None, quals=q,
        known=_on(known, ix.device)), index, codes, nmask, li, cands, quals)
    if salvage:
        _salvage(index, codes, nmask, li, quals, cands, adiag, sel, c1, sc,
                 min(r_salv, rc), L, known, rows)
    return idx, sel, c1


@traced("salvage")
def _salvage(index, codes, nmask, li, quals, cands, adiag, sel, c1, sc,
             rs: int, L: int, known, rows=None):
    """Pass 2 on rows whose pass-1 path leaves a residual clip: window
    scans for the missing exon, 8 rebuilt candidate lanes, and the
    better solution scattered into c1 (in place)."""
    g = index.genome_packed
    W, F, MI = SALVAGE_W, SALVAGE_F, sc.max_intron
    resid_pre = c1["q_start"]
    resid_suf = li - c1["q_end"]
    # the run statistic, not the clip, discriminates: the need gate is
    # looser than MIN_FRAG
    need = sel & ((resid_pre >= MIN_FRAG - 2) | (resid_suf >= MIN_FRAG - 2))
    sidx = _ranked(need, rs, torch.maximum(resid_pre, resid_suf))
    s_sel = need[sidx]
    s_codes, s_li = codes[sidx], li[sidx]
    s_qs, s_qe = c1["q_start"][sidx], c1["q_end"][sidx]
    s_segd = c1["seg_diag"][sidx]
    nsegs = c1["nsegs"][sidx]
    has_sol = nsegs >= 1
    s_adiag = adiag[sidx]
    first_d = torch.where(has_sol, s_segd[:, 0], s_adiag)
    last_d = torch.where(has_sol, _last(s_segd, nsegs, 1, INVALID), s_adiag)
    s_qs64, s_qe64 = s_qs.to(torch.int64), s_qe.to(torch.int64)

    # read-end anchored clean-run scans (K6c)
    frag16_s = _take_window(s_codes, s_li - F, F, L)
    ws_s = (last_d + s_qe64 + sc.min_intron) & MASK32
    base_p = (first_d + s_qs64) & MASK32
    ws_p = torch.where(base_p > W + sc.min_intron,
                       base_p - (W + sc.min_intron), 0)
    frag16_p = _take_window(s_codes, torch.zeros_like(s_qs), F, L)
    def runs(ws, frag, suffix):
        return row_map(rows, lambda ix, w, f: localscan.scan_fragment_runs(
            ix.genome_packed, w, f, W, 8, suffix), index, ws, frag)

    def frags(ws, frag, flen):
        return row_map(rows, lambda ix, w, f, n: localscan.scan_fragment(
            ix.genome_packed, w, f, n, W, F, 4), index, ws, frag, flen)

    pos_s, run_s = runs(ws_s, frag16_s, True)
    pos_p, run_p = runs(ws_p, frag16_p, False)
    fl_s = torch.clamp(s_li - s_qe, 0, F)
    fl_p = torch.clamp(s_qs, 0, F)
    long_read = (s_li >= F)[:, None]
    ok_s = (run_s >= MIN_FRAG) & (fl_s >= MIN_FRAG - 2)[:, None] & long_read
    ok_p = (run_p >= MIN_FRAG) & (fl_p >= MIN_FRAG - 2)[:, None] & long_read
    # splice-site anchors at the run boundary: an acceptor (AG/AC) before
    # the suffix exon, a donor (GT/CT) after the prefix exon, up to 3
    # bases inside the run; runs >= 9 skip the anchor
    exon_start = (pos_s + F - run_s) & MASK32
    din_s = verify.extract_codes_window(
        g, torch.where(exon_start >= 2, exon_start - 2, 0), 6)
    acc_ok = torch.zeros_like(ok_s)
    for d in range(4):
        acc_ok |= ((din_s[..., d] == 0)
                   & ((din_s[..., d + 1] == 2) | (din_s[..., d + 1] == 1))
                   & (run_s - d >= MIN_FRAG))
    ok_s &= acc_ok | (run_s >= 9)
    dp_start = (pos_p + run_p) & MASK32
    din_p = verify.extract_codes_window(
        g, torch.where(dp_start >= 3, dp_start - 3, 0), 6)
    don_ok = torch.zeros_like(ok_p)
    for d in range(4):
        don_ok |= (((din_p[..., d] == 2) | (din_p[..., d] == 1))
                   & (din_p[..., d + 1] == 3)
                   & (run_p - (3 - d) >= MIN_FRAG))
    ok_p &= don_ok | (run_p >= 9)
    dB = (pos_s - (s_li - F).to(torch.int64)[:, None]) & MASK32
    ok_s &= ((dB - last_d[:, None]) & MASK32) <= MI
    dA = pos_p
    ok_p &= ((first_d[:, None] - dA) & MASK32) <= MI
    # middle-exon fragments (two junctions): q_end-anchored forward and
    # q_start-anchored backward mismatch scans (K6a)
    frag_m = _take_window(s_codes, s_qe, F, L)
    pos_m, mm_m = frags(ws_s, frag_m, torch.where(fl_s >= MIN_FRAG, fl_s, 0))
    ok_m = (mm_m <= 1) & (fl_s >= MIN_FRAG)[:, None]
    dM = (pos_m - s_qe64[:, None]) & MASK32
    ok_m &= ((dM - last_d[:, None]) & MASK32) <= MI
    frag_mp = _take_window(s_codes, s_qs - fl_p, F, L)
    pos_mp, mm_mp = frags(ws_p, frag_mp,
                          torch.where(fl_p >= MIN_FRAG, fl_p, 0))
    ok_mp = (mm_mp <= 1) & (fl_p >= MIN_FRAG)[:, None]
    dMp = (pos_mp - (s_qs - fl_p).to(torch.int64)[:, None]) & MASK32
    ok_mp &= ((first_d[:, None] - dMp) & MASK32) <= MI
    new_cands = torch.cat([cands[sidx],
                           torch.where(ok_m, dM, INVALID),
                           torch.where(ok_mp, dMp, INVALID),
                           torch.where(ok_s, dB, INVALID),
                           torch.where(ok_p, dA, INVALID)], dim=1)
    # the 8 lanes: original candidates first, then hits, in lane order
    new_cands = _dedup_keep_first(new_cands)
    order = torch.argsort((new_cands == INVALID).to(torch.int8), dim=1,
                          stable=True)
    new_cands = torch.gather(new_cands, 1, order)[:, :cands.shape[1]]
    s_quals = quals[sidx] if quals is not None else None
    c2 = row_map(rows, lambda ix, c, m, ln, d, q: pathdp.chain_solve(
        ix, c, m, ln, d, scoring=sc, with_quals=q is not None, quals=q,
        known=_on(known, ix.device)), index, s_codes, nmask[sidx], s_li,
        new_cands, s_quals)
    c1_sc, c1_ns = c1["score"][sidx], c1["nsegs"][sidx]
    # ties prefer the solution with more segments (more of the read
    # explained at equal score)
    better = s_sel & ((c2["score"] > c1_sc)
                      | ((c2["score"] == c1_sc) & (c2["nsegs"] > c1_ns)))
    for key in ("score", "q_start", "q_end", "nsegs", "nmm", "seg_q",
                "seg_diag"):
        b = better if c2[key].ndim == 1 else better[:, None]
        c1[key] = c1[key].clone()
        c1[key][sidx] = torch.where(b, c2[key], c1[key][sidx])


def refine_full(index, pbatch, res, config: AlignConfig, L: int,
                scoring: pathdp.PathScoring, splicing: bool, salvage: bool,
                r_chain: int, r_salv: int, r_indel: int,
                keep_cands: bool = False, known=None, rows=None):
    """The post-cascade half: chain stage (splicing), the indel stage on
    rows the splices did not solve, the ambiguous splice-end review
    (splicing) and the secondary-candidate compaction; keep_cands (the
    paired program) skips that compaction and keeps the cand_* lists."""
    lengths = pbatch["lengths"]
    B = lengths.shape[0]
    dev = lengths.device
    i32 = torch.int32
    sc = scoring
    diag = res["diag"]
    strand = res["strand"]
    valid = diag != INVALID
    out = dict(res)
    nmm = res["nmismatch"]
    trim_nmm = res.get("trim_nmm", nmm)
    if "trim_qstart" in res:
        tqs = res["trim_qstart"]
        tqe = torch.minimum(res["trim_qend"], lengths)
        clip = tqs + (lengths - tqe)
    else:                       # soft_clips=False skips the trim stage
        clip = torch.zeros_like(nmm)

    splice_accept_b = torch.zeros(B, dtype=torch.bool, device=dev)
    if splicing:
        idx, sel, c1 = _chain_stage(index, pbatch, res, L, sc, r_chain,
                                    r_salv, salvage, trim_nmm, clip, known,
                                    rows)
        # acceptance: strictly better than the trimmed/full substitution
        # alternative, all segments on one chromosome
        if "trim_score" in res:
            best_other = res["trim_score"][idx]
        else:
            best_other = 8 * lengths[idx] - 32 * nmm[idx]
        ns = c1["nsegs"]
        accept = sel & (ns >= 1) & ((c1["score"] > best_other)
                                    | ((c1["score"] == best_other)
                                       & (ns >= 2)))
        co = index.chrom_offsets
        seg_start = (c1["seg_diag"] + c1["seg_q"].to(torch.int64)) & MASK32
        in_seg = torch.arange(c1["seg_q"].shape[1], device=dev)[None, :] \
            < ns[:, None]
        chr_of = torch.searchsorted(co, seg_start, right=True)
        last_end = (_last(c1["seg_diag"], ns, 1, INVALID)
                    + c1["q_end"].to(torch.int64) - 1) & MASK32
        chr_last = torch.searchsorted(co, last_end, right=True)
        chr0 = chr_of[:, 0]
        same = (torch.where(in_seg, chr_of == chr0[:, None], True).all(dim=1)
                & (chr_last == chr0))
        accept = accept & same
        out["ch_idx"] = idx.to(i32)
        out["ch_sel"] = accept
        out["ch_score"] = c1["score"].to(torch.int16)
        out["ch_qstart"] = c1["q_start"].to(torch.int16)
        out["ch_qend"] = c1["q_end"].to(torch.int16)
        out["ch_nsegs"] = c1["nsegs"].to(torch.uint8)
        out["ch_segq"] = c1["seg_q"].to(torch.int16)
        out["ch_segd"] = c1["seg_diag"]
        out["ch_nmm"] = c1["nmm"].to(torch.int16)
        splice_accept_b[idx] = accept & sel

    # indel stage after splices: only rows splices did not solve; clipped
    # ends trigger too (an end indel's tail mismatches can stay under the
    # nmm trigger while the trim clips them)
    with span("indel"):
        ri = min(r_indel, B)
        need_i = valid & ((nmm >= INDEL_NMM_TRIGGER)
                          | (clip >= CLIP_INDEL_TRIGGER)) & ~splice_accept_b
        iidx = _ranked(need_i, ri)
        isel = need_i[iidx]
        icodes, _inm, ili = _oriented_rows_dev(
            pbatch["packed"], pbatch["pnmask"], lengths, iidx, strand[iidx],
            L)
        idg = torch.where(valid[iidx], diag[iidx], 0)
        fwd = row_map(rows, lambda ix, c, ln, d: indel_forward(
            ix, c, ln, d, INDEL_BAND, INDEL_MARGIN), index, icodes, ili, idg)
        # second compaction before the traceback: only rows whose DP
        # score beats their substitution score can be accepted by the host
        r_tb = min(max(r_indel // 8, 32), ri)
        sub_score = 3 * ili - 6 * nmm[iidx]
        improves = isel & (fwd["score"] > sub_score)
        gain = torch.clamp(fwd["score"] - sub_score, 0, 2 ** 20)
        ar_i = torch.arange(ri, dtype=i32, device=dev)
        _, tbx = stable_topk(
            torch.where(improves, gain * (2 * ri) + (ri - ar_i), 0), r_tb)
        out["indel_tb_overflow"] = torch.clamp(
            improves.sum(dtype=i32) - r_tb, min=0)
        isel = improves[tbx]
        iidx = iidx[tbx]
        fwd = {"score": fwd["score"][tbx], "end_k": fwd["end_k"][tbx],
               "dirs": fwd["dirs"][tbx],
               "gstart_off": fwd["gstart_off"][tbx]}
        ref = row_map(rows, lambda _ix, f, ln: indel_traceback(
            f, ln, INDEL_BAND), index, fwd, ili[tbx])
        out["in_idx"] = iidx.to(i32)
        out["in_sel"] = isel & (ref["nruns"] <= MAXRUNS)
        out["in_score"] = ref["score"].to(torch.int16)
        out["in_runop"] = ref["run_op"]
        out["in_runlen"] = ref["run_len"]
        out["in_startoff"] = ref["start_off"]

    if splicing and "trim_qstart" in res:
        indel_b = torch.zeros(B, dtype=torch.bool, device=dev)
        indel_b[iidx] = isel
        out.update(_amb_review(index, pbatch, res, config, L, sc, tqs, tqe,
                               trim_nmm, splice_accept_b, indel_b, idx,
                               accept & sel, c1, rows))

    if keep_cands:
        return out
    # multimapping rows keep their ranked lists through a small
    # compaction (-n/--npaths > 1); the full [B, K] lists stay on device
    with span("secondary"):
        r_sec = min(max(256, B // 64), B)
        sec_need = valid & (res["n_best"] > 1)
        sidx = _ranked(sec_need, r_sec)
        out["sec_idx"] = sidx.to(i32)
        out["sec_sel"] = sec_need[sidx]
        out["sec_overflow"] = torch.clamp(sec_need.sum(dtype=i32) - r_sec,
                                          min=0)
        out["sec_diags"] = res["cand_diags"][sidx]
        out["sec_strands"] = res["cand_strands"][sidx].to(torch.uint8)
        out["sec_nmm"] = res["cand_nmm"][sidx].to(torch.int16)
    for key in ("cand_diags", "cand_strands", "cand_nmm"):
        out.pop(key)
    return out


@traced("amb")
def _amb_review(index, pbatch, res, config, L, sc, tqs, tqe, trim_nmm,
                splice_accept_b, indel_b, idx, multi_ok, c1, rows=None):
    """The in-program ambiguous splice-end review (ladder.py:539-738):
    review tasks over BOUNDARY_SHIFTS on both read ends, gated by the
    proximal dinucleotide's sense, fragments of dinucleotide + residue,
    and one exact-site scan (K6b). Returns the amb_* keys."""
    lengths = pbatch["lengths"]
    B = lengths.shape[0]
    dev = lengths.device
    i32 = torch.int32
    diag = res["diag"]
    valid = diag != INVALID
    F = AMB_MAX + 2
    NS5 = len(BOUNDARY_SHIFTS)
    W_amb = min(SCAN_W, max(1024, sc.max_intron))
    r_amb = min(max(512, B // 32), B)
    r_task = min(max(1536, B // 16), r_amb * 2 * NS5)

    u_v = tqs
    v_v = lengths - tqe
    alen_t = tqe - tqs
    maxmm = torch.clamp((alen_t.to(torch.float32)
                         * config.max_mismatch_frac).to(i32), min=1)
    trim_amb = (valid & (trim_nmm <= maxmm) & ~splice_accept_b & ~indel_b)
    e_trim = trim_amb & (v_v >= 1) & (v_v <= AMB_MAX)
    s_trim = trim_amb & (u_v >= 1) & (u_v <= AMB_MAX)

    # review sides: chain-accepted rows whose terminal exon is short
    # (a = the proximal segment's diagonal, qb0 = the junction's query
    # boundary)
    ns_c = c1["nsegs"]
    last_q = _last(c1["seg_q"], ns_c, 1, INT32_MIN)
    prev_d = _last(c1["seg_diag"], ns_c, 2, INVALID)
    last_d = _last(c1["seg_diag"], ns_c, 1, INVALID)
    seg1_q, seg1_d = c1["seg_q"][:, 1], c1["seg_diag"][:, 1]
    first_d = c1["seg_diag"][:, 0]
    multi = multi_ok & (ns_c >= 2)

    def signed_gap(a, b):
        """int32 bit cast of the uint32 difference a - b."""
        return ((a - b) & MASK32).to(i32)

    short_e = ((c1["q_end"] - last_q) >= 1) & ((c1["q_end"] - last_q)
                                                <= AMB_MAX)
    short_s = ((seg1_q - c1["q_start"]) >= 1) & ((seg1_q - c1["q_start"])
                                                  <= AMB_MAX)
    rv_e = multi & (signed_gap(last_d, prev_d) >= sc.min_intron) & short_e
    rv_s = multi & (signed_gap(seg1_d, first_d) >= sc.min_intron) & short_s
    rev_e = torch.zeros(B, dtype=torch.bool, device=dev)
    rev_s = torch.zeros(B, dtype=torch.bool, device=dev)
    rev_e[idx] = rv_e
    rev_s[idx] = rv_s
    a_e_b, a_s_b = diag.clone(), diag.clone()
    qb_e_b, qb_s_b = tqe.to(i32).clone(), tqs.to(i32).clone()
    a_e_b[idx] = torch.where(rv_e, prev_d, a_e_b[idx])
    qb_e_b[idx] = torch.where(rv_e, last_q, qb_e_b[idx])
    a_s_b[idx] = torch.where(rv_s, seg1_d, a_s_b[idx])
    qb_s_b[idx] = torch.where(rv_s, seg1_q, qb_s_b[idx])
    e_ok_b = rev_e | e_trim
    s_ok_b = rev_s | s_trim

    row_need = e_ok_b | s_ok_b
    ridx = _ranked(row_need, r_amb)
    rneed = row_need[ridx]
    out = {"amb_row_overflow": torch.clamp(
        row_need.sum(dtype=i32) - rneed.sum(dtype=i32), min=0)}
    codes_a, _nm, li_a = _oriented_rows_dev(pbatch["packed"],
                                            pbatch["pnmask"], lengths, ridx,
                                            res["strand"][ridx], L)
    shifts = _boundary_shifts(dev)
    glen = int(index.genome_length) & MASK32
    ar_f = torch.arange(F, dtype=i32, device=dev)[None, None, :]
    u8 = torch.uint8

    def side_tasks(is_end):
        if is_end:
            ok0, a_r, qb0 = e_ok_b[ridx] & rneed, a_e_b[ridx], qb_e_b[ridx]
        else:
            ok0, a_r, qb0 = s_ok_b[ridx] & rneed, a_s_b[ridx], qb_s_b[ridx]
        qb = qb0[:, None] + shifts                         # [r, 5]
        g = (a_r[:, None] + qb.to(torch.int64)) & MASK32
        if is_end:
            v = li_a[:, None] - qb
            ok = ok0[:, None] & (v >= 1) & (v <= AMB_MAX) & (qb >= 1)
            ok &= ((g + 2) & MASK32) <= glen
            din = verify.extract_codes_window(index.genome_packed, g, 2)
            d0, d1 = din[..., 0], din[..., 1]
            sense = torch.where((d0 == 2) & ((d1 == 3) | (d1 == 1)), 1,
                                torch.where((d0 == 1) & (d1 == 3), -1, 0))
            ok &= sense != 0
            # frag = [acceptor dinucleotide, residue c[qb:li]]
            src = torch.clamp(qb[..., None] + (ar_f - 2), 0, L - 1)
            resid = torch.gather(codes_a[:, None, :].expand(-1, NS5, -1), 2,
                                 src.to(torch.int64))
            acc1 = torch.where(sense > 0, 2, 1).to(u8)
            frag = torch.where(ar_f == 0, 0,
                               torch.where(ar_f == 1, acc1[..., None],
                                           resid)).to(u8)
            inres = (ar_f - 2) < v[..., None]
            frag = torch.where((ar_f < 2) | inres, frag, 0).to(u8)
            flen = torch.clamp(v, 0, AMB_MAX) + 2
            ws = (g + (AMB_MIN_INTRON - 2)) & MASK32
        else:
            u = qb
            ok = (ok0[:, None] & (u >= 1) & (u <= AMB_MAX)
                  & (qb <= li_a[:, None] - 1))
            ok &= g >= 2
            din = verify.extract_codes_window(
                index.genome_packed, torch.where(g >= 2, g - 2, 0), 2)
            d0, d1 = din[..., 0], din[..., 1]
            sense = torch.where((d0 == 0) & (d1 == 2), 1,
                                torch.where((d0 == 0) & (d1 == 1), -1, 0))
            ok &= sense != 0
            # frag = [c[0:u], donor dinucleotide]
            head = codes_a[:, None, :F].expand(-1, NS5, -1)
            don0 = torch.where(sense > 0, 2, 1).to(u8)
            uu = u[..., None]
            frag = torch.where(
                ar_f < uu, head,
                torch.where(ar_f == uu, don0[..., None],
                            torch.where(ar_f == uu + 1, 3, 0).to(u8))
            ).to(u8)
            flen = torch.clamp(u, 0, AMB_MAX) + 2
            # ws = max(g - W - u, 0) without signed underflow
            back = (W_amb + u.to(torch.int64)) & MASK32
            ws = torch.where(g > back, g - back, 0)
        return ok, frag, flen.to(i32), ws, g, qb, sense

    e = side_tasks(True)
    s = side_tasks(False)
    NT = 2 * r_amb * NS5

    def flat(k):
        a, b = e[k], s[k]
        return torch.cat([a.reshape(r_amb * NS5, *a.shape[2:]),
                          b.reshape(r_amb * NS5, *b.shape[2:])])

    ok_t, frag_t, flen_t, ws_t, g_t, qb_t, sn_t = (flat(k) for k in range(7))
    side_t = torch.cat([torch.ones(r_amb * NS5, dtype=u8, device=dev),
                        torch.zeros(r_amb * NS5, dtype=u8, device=dev)])
    rows_t = ridx.repeat_interleave(NS5).repeat(2)
    tix = _ranked(ok_t, r_task)
    t_ok = ok_t[tix]
    out["amb_task_overflow"] = torch.clamp(
        ok_t.sum(dtype=i32) - t_ok.sum(dtype=i32), min=0)
    pos_a, count_a = row_map(
        rows, lambda ix, w, f, n: localscan.scan_exact_sites(
            ix.genome_packed, w, f, n, W_amb, F, TOP_ALTS),
        index, ws_t[tix], frag_t[tix], torch.where(t_ok, flen_t[tix], 0))
    out["amb_valid"] = t_ok
    out["amb_idx"] = rows_t[tix].to(i32)
    out["amb_side"] = side_t[tix]
    out["amb_qb"] = qb_t[tix].to(torch.int16)
    out["amb_sense"] = sn_t[tix].to(torch.int8)
    out["amb_g"] = g_t[tix]
    out["amb_pos"] = pos_a
    out["amb_count"] = count_a.to(torch.int16)
    return out


def align_pair_full(index, pbatch, config: AlignConfig, L: int,
                    scoring: pathdp.PathScoring, splicing: bool,
                    salvage: bool, r_chain: int, r_salv: int, r_indel: int,
                    pairmax: int, orientation: str, pairexpect: int,
                    pairdev: int, known=None, rows=None):
    """The fused paired program (ladder.py:767-814): the ladder over the
    interleaved batch (read 1 of pair p at row 2p, read 2 at 2p + 1),
    then the concordance reduction over the mates' candidate lists.
    Extra keys: pe_ci, pe_cj (chosen candidate per end), pe_valid,
    pe_insert and the chosen candidates' pe_cd*, pe_cs*, pe_cn*; no
    cand_* or sec_* keys."""
    from tpumap_torch.gsnap.paired import concordance_device
    res = align_batch_cascaded_packed(index, pbatch, config, L, rows=rows)
    out = refine_full(index, pbatch, res, config, L, scoring, splicing,
                      salvage, r_chain, r_salv, r_indel, keep_cands=True,
                      known=known, rows=rows)
    with span("concordance"):
        lengths = pbatch["lengths"]
        cd, cs, cn = (out.pop("cand_diags"), out.pop("cand_strands"),
                      out.pop("cand_nmm"))
        d1, d2 = cd[0::2], cd[1::2]
        s1, s2 = cs[0::2], cs[1::2]
        n1, n2 = cn[0::2], cn[1::2]
        ci, cj, valid, insert = concordance_device(
            d1, s1, n1, lengths[0::2], d2, s2, n2, lengths[1::2], pairmax,
            orientation, pairexpect, pairdev)
        out["pe_ci"] = ci
        out["pe_cj"] = cj
        out["pe_valid"] = valid
        out["pe_insert"] = insert
        for key, arr, i in (("pe_cd1", d1, ci), ("pe_cs1", s1, ci),
                            ("pe_cn1", n1, ci), ("pe_cd2", d2, cj),
                            ("pe_cs2", s2, cj), ("pe_cn2", n2, cj)):
            out[key] = torch.gather(arr, 1, i[:, None])[:, 0]
    return narrow_result(out)


# result fields held as int16 bit patterns of uint16 values
_UINT16_KEYS = frozenset(k for k, v in _WIRE_DTYPES.items()
                         if v == "uint16") | {
    "in_runlen", "sec_nmm", "ch_qstart", "ch_qend", "ch_segq", "ch_nmm",
    "amb_count"}


def start_fetch(dev: dict):
    """Enqueue the copies of a result dict to host memory (pinned, on
    the current stream) and return a function that waits for them and
    returns the dict widened as tpumap's host half sees it: bool stays
    bool, int64 coordinates become uint32, narrower integers int32."""
    with span("fetch"):
        event = None
        host = dev
        if any(v.device.type == "cuda" for v in dev.values()):
            host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    .copy_(v, non_blocking=True) for k, v in dev.items()}
            event = torch.cuda.Event()
            event.record()

    def wait() -> dict:
        if event is not None:
            _wait_event(event)
        return _host_view(host)

    return wait


def _wait_event(event) -> None:
    """Block the host until the card has run up to event: the batch's
    device work and its result copies."""
    with span("wait"):
        event.synchronize()


def _host_view(host: dict) -> dict:
    """The copied result dict as numpy, widened as tpumap's host half
    sees it."""
    with span("widen"):
        out = {}
        for k, v in host.items():
            a = v.numpy()
            if k in _UINT16_KEYS:
                a = a.view(np.uint16)
            elif a.dtype == np.int64:
                a = a.astype(np.uint32)
            out[k] = a
        return widen_ints(out)


def count_batch(res: dict, reads: int) -> None:
    """Count one batch (host values of its fetched result dict): the
    batch, its reads and each overflow scalar the dict holds."""
    count("batches")
    count("reads", reads)
    for k in OVERFLOWS:
        if k in res:
            count(k, int(res[k]))


def fetch_result(dev: dict) -> dict:
    """start_fetch and wait: the host view of a result dict."""
    return start_fetch(dev)()
