"""Paired-end alignment of the port: concordance, mate rescue, mate
repair and pair emission (port of tpumap/gsnap/paired.py).

Both mates run through the fused paired program
(ladder.align_pair_full): the single-end ladder over the interleaved
batch plus `ladder.concordance_device`, a [P, K, K] validity and score
reduction over the mates' candidate lists in plain torch ops. With a
transcriptome (tr) or learned indels (known_indels) they take the
staged path instead: the cascade, the same reduction over its
candidates, and the driver's refine_unsolved stages. The host
half is a JAX-free copy of tpumap's: it applies the chosen concordant
pair, rescues a mate inside its partner's insert window with
`rescue_mate` (kernel K1 over [R, pairmax] diagonals), falls back to
rescuing both ways where both mates map with no concordant combination,
repairs an unplaced spliced mate (three K6a window scans and one K5
chain solve), lets the mate arbitrate ambiguous splice ends, and emits
the pairs: plain pairs through one native bulk call with every mate
field computed vectorised, the rest through the Python records.

The alignment modes and SNP tolerance change the cascade only; as in
tpumap, the rescue verifies in standard space and the pair emitters
count NM/MD without the mode's space (a cmet conversion counts as a
mismatch there, unlike single-end). With device_ctx (a
parallel/pipeline.MeshContext) the device calls run data-parallel over a
device grid and give the single-device records.
"""
from __future__ import annotations

import numpy as np
import torch

from tpumap_torch.gsnap import ladder
from tpumap_torch.gsnap import spliceends as se
from tpumap_torch.gsnap.driver import (_enqueue, _mend_overrun, _to_device,
                                       make_batch, pad_to_bucket,
                                       refine_unsolved)
from tpumap_torch.gsnap import remap as remap_mod
from tpumap_torch.gsnap.engine import AlignConfig, mapq_from_scores
from tpumap_torch.gsnap.knownsplicing import known_to_device
from tpumap_torch.index.build import GenomeDB
from tpumap_torch.index.device import DeviceIndex
from tpumap_torch.io import sam, sam_bulk
from tpumap_torch.io.fasta import Record
from tpumap_torch.ops import localscan, pack, pathdp, verify
from tpumap_torch.ops.u32 import MASK32
from tpumap_torch.utils import dna
from tpumap_torch.utils.trace import count, counting, counting_on, traced

def rescue_mate(index, codes: torch.Tensor, lengths: torch.Tensor,
                window: int, base_diags: torch.Tensor):
    """Scan every diagonal in [base, base + window) (uint32 wrap) for the
    best fit of each row's mate, already oriented as the expected strand
    (codes uint8[R, L], lengths int32[R], base_diags int64[R]). Returns
    (best diagonal int64[R], its mismatches int32[R]); ties go to the
    first offset."""
    packed = pack.pack_reads(codes)
    offs = torch.arange(window, dtype=torch.int64, device=codes.device)
    diags = (base_diags[:, None] + offs[None, :]) & MASK32
    nmm = verify.verify_diagonals(index, packed, torch.zeros_like(packed),
                                  lengths, diags)
    best = torch.argmin(nmm.to(torch.int64) * window + offs[None, :], dim=1)
    return (torch.gather(diags, 1, best[:, None])[:, 0],
            torch.gather(nmm, 1, best[:, None])[:, 0])


def _put(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _staged_concordance(index, batch, res, n, pairmax, orientation,
                        pairexpect, pairdev):
    """The concordance reduction over the staged cascade's ranked
    candidates of each pair's two ends (tpumap paired.py:293-324), on
    the index's device: (valid, the chosen (diag, strand, nmm) of end
    1, of end 2), each [n] on the host."""
    dev = index.device
    lens = np.asarray(batch["lengths"])
    ends = []
    for w in (0, 1):
        ends += [_put(res["cand_diags"][w:2 * n:2].astype(np.int64), dev),
                 _put(res["cand_strands"][w:2 * n:2].astype(np.int32), dev),
                 _put(res["cand_nmm"][w:2 * n:2].astype(np.int32), dev),
                 _put(lens[w:2 * n:2].astype(np.int32), dev)]
    ci, cj, cval, _ins = ladder.concordance_device(
        *ends, pairmax, orientation, pairexpect or 1000, pairdev)
    ci, cj, cval = ci.cpu().numpy(), cj.cpu().numpy(), cval.cpu().numpy()

    def take(key, w, idx):
        return np.take_along_axis(res[key][w:2 * n:2], idx[:, None].astype(
            np.int64), axis=1)[:, 0]
    return cval, tuple(take(k, 0, ci) for k in ("cand_diags", "cand_strands",
                                                "cand_nmm")), \
        tuple(take(k, 1, cj) for k in ("cand_diags", "cand_strands",
                                       "cand_nmm"))


def align_paired_records(db: GenomeDB, index: DeviceIndex,
                         pairs: list[tuple[Record, Record]],
                         config: AlignConfig = AlignConfig(),
                         pairmax: int = 2000,
                         batch_size: int = 512,
                         novelsplicing: bool = False,
                         max_intron: int = 200_000,
                         known=None,
                         orientation: str = "FR",
                         pairexpect: int | None = None,
                         pairdev: int = 100,
                         max_insertions: int = 6, max_deletions: int = 9,
                         indel_endlength: int = 4,
                         use_localdb: bool = True, known_indels=None,
                         device_ctx=None, tr=None,
                         resolve_inner: bool = True, sink=None,
                         stats: dict | None = None
                         ) -> list[tuple[sam.SamRecord, sam.SamRecord]]:
    """Align read pairs on the index's device: through the fused paired
    program, or with tr (a (Transcriptome, DeviceIndex) pair: XX/XY
    remap tags on each pair) or known_indels (a KnownIndels) through the
    staged path (the cascade, the concordance reduction over its
    candidates, then refine_unsolved's stages). Returns (mate 1, mate 2)
    SAM record pairs in input order, or, with sink (a callable taking
    bytes), streams the SAM text to it and returns []. known: a
    KnownSplicing (-s). stats, if given, receives the counts of
    utils/trace.py: batches, reads (mates), the overflow scalars, the
    indel rows, the rows each emitter wrote, the rescue rows, the mates
    rescued, the repair rows and the mates repaired; pairs, those the
    concordance reduction found concordant, those that took the
    EXHAUSTIVE fallback, those emitted as proper pairs, and those whose
    TLEN ends at a special mate's aligned end (tlen_from_alignment).
    device_ctx (parallel/pipeline.MeshContext) runs the paired program,
    the cascade and the chain solver over its device grid."""
    dev = index.device
    remapper = None
    if tr is not None:
        remapper = getattr(tr[0], "_remapper", None)
        if remapper is None:
            remapper = remap_mod.TranscriptRemapper(tr[0])
            tr[0]._remapper = remapper
    use_fused = tr is None and known_indels is None
    known_dev = (known_to_device(known, dev)
                 if known is not None and use_fused else None)
    sc = pathdp.PathScoring(max_intron=max(max_intron, 9))
    # one (B, L) shape for the whole run
    run_L = pad_to_bucket(max((len(r.sequence)
                               for p in pairs for r in p), default=1))
    pad_tail = len(pairs) >= batch_size

    def _dispatch(start):
        chunk = pairs[start:start + batch_size]
        flat = [r for p in chunk for r in p]
        B = (2 * batch_size if (pad_tail or len(chunk) == batch_size)
             else pad_to_bucket(2 * len(chunk)))
        batch = make_batch(flat, B, run_L)
        pbatch = _to_device(batch, dev)
        res = _enqueue(index, pbatch, config, run_L, sc,
                       novelsplicing or known is not None,
                       novelsplicing and use_localdb, use_fused, known_dev,
                       device_ctx, pair=(pairmax, orientation,
                                         pairexpect or 1000, pairdev))
        return chunk, batch, ladder.start_fetch(res)

    bulk_ok = remapper is None and sam_bulk._get_lib() is not None
    out = []
    starts = list(range(0, len(pairs), batch_size))
    with counting(stats):
        pending = _dispatch(starts[0]) if starts else None
        for si, start in enumerate(starts):
            chunk, batch, wait = pending
            if si + 1 < len(starts):
                # the next batch's device work runs under this batch's
                # host work
                pending = _dispatch(starts[si + 1])
            res = wait()
            if counting_on():
                ladder.count_batch(res, 2 * len(chunk))
            out_chunk = _pair_chunk(
                db, index, chunk, batch, res, config, run_L, pairmax,
                novelsplicing, max_intron, known, orientation, pairexpect,
                pairdev, max_insertions, max_deletions, indel_endlength,
                use_localdb, known_indels, remapper, resolve_inner, bulk_ok,
                sink, device_ctx)
            if sink is None:
                out.extend(out_chunk)
    return out


@traced("rescue")
def _rescue(index, batch, res, rescue_rows, L, pairmax, config):
    """Rescue each (pair, bad, good) row's mate `bad` inside the insert
    window of `good` (the LOCAL_MATE method). Returns (rescued, bases):
    rescued[bad] = (diag, strand, nmm) of the best acceptable fit, bases
    the uint32 window starts per rescue row."""
    nb = pad_to_bucket(len(rescue_rows))
    codes = np.zeros((nb, L), np.uint8)
    lengths = np.ones(nb, np.int32)
    bases = np.zeros(nb, np.uint32)
    for row, (p, bad, good) in enumerate(rescue_rows):
        li = int(batch["lengths"][bad])
        c = batch["codes"][bad][:li]
        # the expected mate orientation is opposite to the solved end's
        if 1 - int(res["strand"][good]):
            c = dna.revcomp_codes(c)
        codes[row, :li] = c
        lengths[row] = li
        gd = int(res["diag"][good])
        if int(res["strand"][good]) == 0:
            base = gd
        else:
            base = max(gd + int(batch["lengths"][good]) - pairmax, 0)
        bases[row] = base
    dev = index.device
    bd, bn = rescue_mate(index, _put(codes, dev), _put(lengths, dev),
                         pairmax, _put(bases.astype(np.int64), dev))
    bd = bd.cpu().numpy().astype(np.uint32)
    bn = bn.cpu().numpy()
    rescued = {}
    for row, (p, bad, good) in enumerate(rescue_rows):
        li = int(batch["lengths"][bad])
        if bn[row] <= int(li * config.max_mismatch_frac):
            prev = rescued.get(bad)
            cand_r = (int(bd[row]), 1 - int(res["strand"][good]),
                      int(bn[row]))
            if prev is None or cand_r[2] < prev[2]:
                rescued[bad] = cand_r
    return rescued, bases


@traced("repair")
def _mate_repair(db, index, batch, res, repair_rows, bases, L, pairmax,
                 max_intron, config, device_ctx=None):
    """GMAP-style mate repair (paired.py:394-496): an unplaced mate's
    end and middle 16-base fragments located in the insert window (K6a),
    their diagonals chained (K5). Returns {row: splice_result dict}."""
    FL = 16
    W = min(65536, max(1024, pairmax))
    R = pad_to_bucket(len(repair_rows))
    frag_a = np.zeros((R, FL), np.uint8)
    frag_b = np.zeros((R, FL), np.uint8)
    frag_c = np.zeros((R, FL), np.uint8)   # middle (2-junction mates)
    flens = np.zeros(R, np.int32)
    wstarts = np.zeros(R, np.uint32)
    oriented = {}
    for rr, (row, p, bad, good) in enumerate(repair_rows):
        li = int(batch["lengths"][bad])
        c = batch["codes"][bad][:li]
        m = batch["nmask"][bad][:li]
        want_strand = 1 - int(res["strand"][good])
        if want_strand:
            c = dna.revcomp_codes(c)
            m = m[::-1]
        oriented[bad] = (c, m, want_strand, li)
        if li >= FL:
            frag_a[rr] = c[:FL]
            frag_b[rr] = c[li - FL:]
            frag_c[rr] = c[(li - FL) // 2:(li - FL) // 2 + FL]
            flens[rr] = FL
        wstarts[rr] = bases[row]
    dev = index.device
    ws_t, fl_t = _put(wstarts.astype(np.int64), dev), _put(flens, dev)
    scans = []
    for fr in (frag_a, frag_b, frag_c):
        pos, mm = localscan.scan_fragment(index.genome_packed, ws_t,
                                          _put(fr, dev), fl_t, W, FL)
        scans.append((pos.cpu().numpy(), mm.cpu().numpy()))
    chain_rows = []
    for rr, (row, p, bad, good) in enumerate(repair_rows):
        c, m, want_strand, li = oriented[bad]
        cands = []
        for (pos, mm), off in zip(scans, (0, li - FL, (li - FL) // 2)):
            for t in range(pos.shape[1]):
                if mm[rr, t] <= 2:
                    d = int(pos[rr, t]) - off
                    if d >= 0 and d not in cands:
                        cands.append(d)
        if cands:
            chain_rows.append((bad, cands[:8], int(wstarts[rr])))
    repair_result = {}
    if not chain_rows:
        return repair_result
    mended = 0
    nb2 = pad_to_bucket(len(chain_rows))
    codes2 = np.zeros((nb2, L), np.uint8)
    nmask2 = np.zeros((nb2, L), bool)
    lengths2 = np.ones(nb2, np.int32)
    cdiags2 = np.full((nb2, 8), 0xFFFFFFFF, np.int64)
    for rr, (bad, cands, _w0) in enumerate(chain_rows):
        c, m, want_strand, li = oriented[bad]
        codes2[rr, :li] = c
        nmask2[rr, :li] = m
        lengths2[rr] = li
        cdiags2[rr, :len(cands)] = np.asarray(cands, np.uint32)
    _chain = (device_ctx.chain_solve if device_ctx is not None
              else pathdp.chain_solve)
    cres2 = _chain(
        index, _put(codes2, dev), _put(nmask2, dev), _put(lengths2, dev),
        _put(cdiags2, dev),
        scoring=pathdp.PathScoring(max_intron=max(max_intron, 30)))
    cres2 = {k: v.cpu().numpy() for k, v in cres2.items()}
    for rr, (bad, cands, win0) in enumerate(chain_rows):
        c, m, want_strand, li = oriented[bad]
        nsegs = int(cres2["nsegs"][rr])
        if not 1 <= nsegs <= pathdp.MAX_SEGMENTS:
            continue
        q_start = int(cres2["q_start"][rr])
        q_end = int(cres2["q_end"][rr])
        nmm = int(cres2["nmm"][rr])
        alen = q_end - q_start
        if (nmm > max(1, int(alen * config.max_mismatch_frac))
                or alen < max(20, int(li * config.min_coverage))):
            continue
        segs = [(int(cres2["seg_q"][rr][s]), int(cres2["seg_diag"][rr][s]))
                for s in range(nsegs)]
        chroms = {db.chrnum(d + q) for q, d in segs}
        chroms.add(db.chrnum(segs[-1][1] + q_end - 1))
        if len(chroms) != 1:
            continue
        repair_result[bad] = {
            "segs": segs, "q_start": q_start, "q_end": q_end,
            "strand": want_strand, "score": int(cres2["score"][rr]),
            "nmm": nmm, "_win": (win0, win0 + W + li),
        }
        mended += _mend_overrun(repair_result[bad])
    count("chain_ins_refused", mended)
    return repair_result


def _resolve_amb_with_mate(res, amb_res, splice_result, len2, end_info, B2,
                           pairexpect, pairdev):
    """Altsplice resolution with the mate (paired.py:551-612): an
    ambiguous splice end whose mate is placed takes the distal placement
    nearest the expected insert; the rest keep their soft clip and XA:Z:
    alternatives."""
    for i in sorted(amb_res):
        if i >= B2:
            continue
        li_e = int(len2[i])
        lo = int(len2[i ^ 1])
        other = end_info(i ^ 1)
        ambs = amb_res.get(i)
        if not ambs or other is None:
            continue
        mate_lo, mate_hi = other[0], other[0] + lo
        keep = []
        for amb in ambs:
            ix = se.resolve_with_mate(amb, li_e, mate_lo, mate_hi,
                                      pairexpect or 1000, pairdev)
            if ix is None:
                keep.append(amb)
                continue
            diag = amb.diags[ix]
            s = splice_result.get(i)
            if s is None:
                if "trim_qstart" not in res:
                    keep.append(amb)
                    continue
                tqs = int(res["trim_qstart"][i])
                tqe = min(int(res["trim_qend"][i]), li_e)
                nmm = int(res.get("trim_nmm", res["nmismatch"])[i])
                s = {"segs": [(tqs, int(res["diag"][i]))],
                     "q_start": tqs, "q_end": tqe,
                     "strand": int(res["strand"][i]),
                     "score": 8 * (tqe - tqs) - 32 * nmm, "nmm": nmm}
                splice_result[i] = s
            if amb.side == "qend" and amb.qb > s["segs"][-1][0]:
                s["score"] += 8 * (li_e - s["q_end"])
                s["segs"] = s["segs"] + [(amb.qb, diag)]
                s["q_end"] = li_e
            elif (amb.side == "qstart"
                  and amb.qb < (s["segs"][1][0] if len(s["segs"]) > 1
                                else s["q_end"])):
                s["score"] += 8 * s["q_start"]
                s["segs"] = ([(0, diag), (amb.qb, s["segs"][0][1])]
                             + s["segs"][1:])
                s["q_start"] = 0
            else:
                keep.append(amb)
        if keep:
            amb_res[i] = keep
        else:
            amb_res.pop(i, None)


@traced("pair")
def _pair_chunk(db, index, chunk, batch, res, config, L, pairmax,
                novelsplicing, max_intron, known, orientation, pairexpect,
                pairdev, max_insertions, max_deletions, indel_endlength,
                use_localdb, known_indels, remapper, resolve_inner, bulk_ok,
                sink, device_ctx=None):
    """The host half of one batch (paired.py:286-691). Returns the
    chunk's record pairs, or streams them to sink and returns []."""
    n = len(chunk)
    # the concordant combination the device reduction chose: in the
    # fused program, or here over the staged cascade's candidates
    if "pe_valid" in res:
        cval = res["pe_valid"][:n]
        cd1, cs1, cn1 = (res["pe_cd1"][:n], res["pe_cs1"][:n],
                         res["pe_cn1"][:n])
        cd2, cs2, cn2 = (res["pe_cd2"][:n], res["pe_cs2"][:n],
                         res["pe_cn2"][:n])
    else:
        cval, (cd1, cs1, cn1), (cd2, cs2, cn2) = _staged_concordance(
            index, batch, res, n, pairmax, orientation, pairexpect, pairdev)

    # mate rescue where exactly one end maps; pairs whose two mapped ends
    # have no concordant combination take the EXHAUSTIVE fallback: each
    # end rescued in the other's window, the better concordant pair kept
    rescue_rows = []
    exh_pairs = set()
    for p in range(n):
        i1, i2 = 2 * p, 2 * p + 1
        ok1 = res["mapped"][i1]
        ok2 = res["mapped"][i2]
        if ok1 != ok2:
            rescue_rows.append((p, i2 if ok1 else i1, i1 if ok1 else i2))
        elif ok1 and ok2 and not cval[p]:
            exh_pairs.add(p)
            rescue_rows.append((p, i2, i1))
            rescue_rows.append((p, i1, i2))
    rescued, bases = {}, None
    if rescue_rows:
        rescued, bases = _rescue(index, batch, res, rescue_rows, L, pairmax,
                                 config)
    # EXHAUSTIVE pairs: keep only the better rescue (ties re-place end 2)
    for p in exh_pairs:
        i1, i2 = 2 * p, 2 * p + 1
        a, b = rescued.get(i2), rescued.get(i1)
        if a is not None and b is not None:
            tot_a = int(res["nmismatch"][i1]) + a[2]
            tot_b = int(res["nmismatch"][i2]) + b[2]
            del rescued[i1 if tot_a <= tot_b else i2]

    mapq = mapq_from_scores(res["nmismatch"], res["second_nmismatch"],
                            res["n_best"], batch["lengths"],
                            mm_qualsum=res.get("mm_qualsum"),
                            qual_mean16=res.get("qual_mean16"))

    repair_rows = [(row, p, bad, good)
                   for row, (p, bad, good) in enumerate(rescue_rows)
                   if (novelsplicing and bad not in rescued
                       and not res["mapped"][bad])]
    repair_result = {}
    if repair_rows:
        repair_result = _mate_repair(db, index, batch, res, repair_rows,
                                     bases, L, pairmax, max_intron, config,
                                     device_ctx)
    count("pairs", n)
    count("pairs_concordant", int(np.count_nonzero(cval)))
    count("pairs_exhaustive", len(exh_pairs))
    count("rescue_rows", len(rescue_rows))
    count("rescued", len(rescued))
    count("repair_rows", len(repair_rows))
    count("repaired", len(repair_result))

    amb_res = {}
    dp_result, splice_result, _fus = refine_unsolved(
        db, index, batch, res, config, novelsplicing, max_intron, known,
        L=L, max_insertions=max_insertions, max_deletions=max_deletions,
        indel_endlength=indel_endlength, use_localdb=use_localdb,
        known_indels=known_indels, quals=batch.get("quals"),
        amb_out=amb_res, dict_all=True, device_ctx=device_ctx)
    for bad, s_rep in repair_result.items():
        cur = splice_result.get(bad)
        if cur is not None:
            # keep the ladder's solution unless it is weaker and lies
            # entirely outside the intron-expanded mate window
            lo, hi = s_rep["_win"]
            d0 = cur["segs"][0][1] + cur["q_start"]
            d1 = cur["segs"][-1][1] + cur["q_end"]
            if (cur["score"] > s_rep["score"]
                    or (lo <= d0 + max_intron and d1 <= hi + max_intron)):
                continue
        splice_result[bad] = s_rep

    # vectorised end resolution over the whole batch
    B2 = 2 * n
    len2 = np.asarray(batch["lengths"])[:B2].astype(np.int64)
    ediag = res["diag"][:B2].astype(np.int64)
    estrand = res["strand"][:B2].astype(np.int64)
    enmm = res["nmismatch"][:B2].astype(np.int64)
    evalid = res["mapped"][:B2].astype(bool).copy()
    L1v, L2v = len2[0::2], len2[1::2]
    ov = (np.asarray(cval, bool)
          & (cn1.astype(np.int64) <= L1v * config.max_mismatch_frac)
          & (cn2.astype(np.int64) <= L2v * config.max_mismatch_frac))
    for (dst, src) in ((ediag[0::2], cd1), (estrand[0::2], cs1),
                       (enmm[0::2], cn1), (ediag[1::2], cd2),
                       (estrand[1::2], cs2), (enmm[1::2], cn2)):
        dst[ov] = src[ov].astype(np.int64)
    evalid[0::2] |= ov
    evalid[1::2] |= ov
    for i, (d, s, nm) in rescued.items():
        ediag[i], estrand[i], enmm[i] = d, s, nm
        evalid[i] = True

    def end_info(i):
        if evalid[i]:
            return (int(ediag[i]), int(estrand[i]), int(enmm[i]))
        return None

    if amb_res:
        _resolve_amb_with_mate(res, amb_res, splice_result, len2, end_info,
                               B2, pairexpect, pairdev)

    out_chunk, plain = _emit_pair_rows(
        db, chunk, res, config, known, mapq, len2, dp_result, splice_result,
        amb_res, evalid, end_info, pairmax, resolve_inner, remapper,
        bulk_ok)
    ip = np.nonzero(plain)[0]
    count("rows_native", 2 * len(ip))
    count("rows_python", 2 * (n - len(ip)))
    blob = None
    if len(ip):
        blob = _emit_plain_pairs_bulk(db, batch, chunk, ip, ediag, estrand,
                                      enmm, len2, mapq, pairmax,
                                      resolve_inner, out_chunk,
                                      raw=sink is not None)
    if sink is None:
        return out_chunk
    _stream_pairs(out_chunk, blob, sink)
    return []


@traced("emit_rows")
def _emit_pair_rows(db, chunk, res, config, known, mapq, len2, dp_result,
                    splice_result, amb_res, evalid, end_info, pairmax,
                    resolve_inner, remapper, bulk_ok):
    """The Python records of one batch of pairs: the special rows (solved
    beyond a plain ungapped record) and every pair that is not plain
    (both ends mapped, no special, no ambiguous end), which the native
    bulk emission takes where bulk_ok. Returns (out_chunk with the
    non-plain pairs' records, the plain mask)."""
    n = len(chunk)
    B2 = 2 * n
    # specials: rows the ladder solved beyond a plain ungapped record
    specials = {}
    for i in sorted(set(splice_result) | set(dp_result)):
        if i >= B2:
            continue
        sp = _special_record(db, chunk[i // 2][i & 1], i, res, dp_result,
                             splice_result, int(len2[i]), config,
                             int(mapq[i]), known=known)
        if sp is not None:
            specials[i] = sp

    # plain both-mapped pairs with no special emit through one native
    # bulk call; the rest through the Python pair emitter
    irregular = np.zeros(n, bool)
    for i in specials:
        irregular[i // 2] = True
    for i in amb_res:
        if i < B2:
            irregular[i // 2] = True
    both = evalid[0::2] & evalid[1::2]
    plain = both & ~irregular if bulk_ok else np.zeros(n, bool)

    out_chunk = [None] * n
    for p in np.nonzero(~plain)[0].tolist():
        i1, i2 = 2 * p, 2 * p + 1
        r1, r2 = chunk[p]
        special = {i1: specials.get(i1), i2: specials.get(i2)}
        pair_rec = _emit_pair(db, r1, r2, end_info(i1), end_info(i2),
                              int(mapq[i1]), int(mapq[i2]), pairmax,
                              resolve_inner=resolve_inner, special=special,
                              keys=(i1, i2))
        if pair_rec[0].flag & 0x2:
            count("pairs_proper")
        if amb_res:
            for idx, r_out in ((i1, pair_rec[0]), (i2, pair_rec[1])):
                if idx in amb_res and not r_out.flag & 4:
                    r_out.tags.append(se.xa_tag(amb_res[idx]))
        if remapper is not None:
            # transcript remap and the pair's joint velocity (XX/XY)
            remap_mod.tag_pair(remapper, db, pair_rec[0], pair_rec[1])
        out_chunk[p] = pair_rec
    return out_chunk, plain


@traced("emit_rows")
def _stream_pairs(out_chunk, blob, sink) -> None:
    """Stream one batch's pairs in input order: plain pairs as byte spans
    of the native blob (consecutive spans coalesced), the other pairs as
    record lines."""
    buf = blob.buf if blob is not None else b""
    run_a = run_b = None
    for item in out_chunk:
        if isinstance(item, tuple) and item and item[0] == "__blob__":
            _tag, a, b = item
            if run_b == a:
                run_b = b
            else:
                if run_a is not None:
                    sink(buf[run_a:run_b])
                run_a, run_b = a, b
            continue
        if run_a is not None:
            sink(buf[run_a:run_b])
            run_a = run_b = None
        ra, rb = item
        sink(ra.lines().encode())
        sink(rb.lines().encode())
    if run_a is not None:
        sink(buf[run_a:run_b])


@traced("emit")
def _emit_plain_pairs_bulk(db, batch, chunk, ip, ediag, estrand, enmm,
                           len2, mapq, pairmax, resolve_inner, out_chunk,
                           raw=False):
    """Vectorised _pair_plan and one native bulk emission for the plain
    both-mapped pairs (mate fields, FLAG and TLEN as _plan_record gives
    them). With raw=True returns the SamBlob and marks out_chunk entries
    with ("__blob__", start, end) byte spans (the streaming path)."""
    i1 = 2 * ip
    i2 = i1 + 1
    d1, d2 = ediag[i1], ediag[i2]
    s1, s2 = estrand[i1], estrand[i2]
    L1, L2 = len2[i1], len2[i2]
    m = len(ip)
    qs1 = np.zeros(m, np.int64)
    qe1 = L1.copy()
    qs2 = np.zeros(m, np.int64)
    qe2 = L2.copy()
    opp = s1 != s2
    if resolve_inner:
        # dovetail / read-through: clip the plus end past the fragment
        # end, the minus end before the fragment start
        plus1 = s1 == 0
        dplus = np.where(plus1, d1, d2)
        Lp = np.where(plus1, L1, L2)
        dminus = np.where(plus1, d2, d1)
        Lm = np.where(plus1, L2, L1)
        over_hi = (dplus + Lp) - (dminus + Lm)
        cut_hi = opp & (over_hi > 0) & (over_hi <= Lp - 20)
        over_lo = dplus - dminus
        cut_lo = opp & (over_lo > 0) & (over_lo <= Lm - 20)
        qe_plus = np.where(cut_hi, Lp - over_hi, Lp)
        qs_minus = np.where(cut_lo, over_lo, 0)
        qe1 = np.where(plus1, qe_plus, qe1)
        qe2 = np.where(~plus1, qe_plus, qe2)
        qs1 = np.where(~plus1, qs_minus, qs1)
        qs2 = np.where(plus1, qs_minus, qs2)
    f1 = (np.full(m, 0x1 | 0x40, np.int32)
          | np.where(s1 == 1, 16, 0) | np.where(s2 == 1, 0x20, 0))
    f2 = (np.full(m, 0x1 | 0x80, np.int32)
          | np.where(s2 == 1, 16, 0) | np.where(s1 == 1, 0x20, 0))
    lo = np.minimum(d1 + qs1, d2 + qs2)
    hi = np.maximum(d1 + qe1, d2 + qe2)
    tlen = hi - lo
    proper = opp & (tlen <= pairmax)
    sign1 = np.where(d1 + qs1 <= d2 + qs2, 1, -1)
    tlen1 = np.where(proper, sign1 * tlen, 0)
    tlen2 = -tlen1
    f1 |= np.where(proper, 2, 0)
    f2 |= np.where(proper, 2, 0)
    count("pairs_proper", int(np.count_nonzero(proper)))

    # interleave the ends back into emission rows
    M = 2 * m
    rows = np.empty(M, np.int64)
    rows[0::2] = i1
    rows[1::2] = i2
    diag_r = np.empty(M, np.uint64)
    diag_r[0::2] = d1.astype(np.uint64)
    diag_r[1::2] = d2.astype(np.uint64)
    strand_r = np.empty(M, np.uint8)
    strand_r[0::2] = s1
    strand_r[1::2] = s2
    flags_r = np.empty(M, np.int32)
    flags_r[0::2] = f1
    flags_r[1::2] = f2
    mate_r = np.empty(M, np.uint64)
    mate_r[0::2] = (d2 + qs2).astype(np.uint64)
    mate_r[1::2] = (d1 + qs1).astype(np.uint64)
    tlen_r = np.empty(M, np.int64)
    tlen_r[0::2] = tlen1
    tlen_r[1::2] = tlen2
    qs_r = np.empty(M, np.int32)
    qs_r[0::2] = qs1
    qs_r[1::2] = qs2
    qe_r = np.empty(M, np.int32)
    qe_r[0::2] = qe1
    qe_r[1::2] = qe2
    mq_r = mapq[rows].astype(np.int32)
    recs = [r for p in ip.tolist() for r in chunk[p]]
    codes_np = np.asarray(batch["codes"])
    nmask_np = np.asarray(batch["nmask"])
    lines = sam_bulk.emit_ungapped_bulk(
        db, recs, np.ascontiguousarray(codes_np[rows]),
        np.ascontiguousarray(nmask_np[rows]), len2[rows],
        diag_r, strand_r, mq_r, None, qs_r, qe_r,
        np.ones(M, np.uint8), flags=flags_r, mate_u=mate_r, tlen=tlen_r,
        raw=raw)

    def python_pair(j, p):
        # the native emitter declined a row of this pair
        r1, r2 = chunk[p]
        e1 = (int(d1[j]), int(s1[j]), int(enmm[2 * p]))
        e2 = (int(d2[j]), int(s2[j]), int(enmm[2 * p + 1]))
        return _emit_pair(db, r1, r2, e1, e2, int(mq_r[2 * j]),
                          int(mq_r[2 * j + 1]), pairmax,
                          resolve_inner=resolve_inner)

    if raw and lines is not None:
        # streaming: each fully emitted pair's byte span in the blob
        # (both mates are adjacent rows 2j, 2j + 1)
        off = lines.off
        for j, p in enumerate(ip.tolist()):
            a, b = int(off[2 * j]), int(off[2 * j + 2])
            if off[2 * j + 1] > off[2 * j] and off[2 * j + 2] > off[2 * j + 1]:
                out_chunk[p] = ("__blob__", a, b)
            else:
                out_chunk[p] = python_pair(j, p)
        return lines
    for j, p in enumerate(ip.tolist()):
        j1, j2 = 2 * j, 2 * j + 1
        if lines is not None and lines[j1] is not None \
                and lines[j2] is not None:
            out_chunk[p] = (
                sam_bulk.RawSamRecord(lines[j1], int(flags_r[j1]),
                                      int(mq_r[j1])),
                sam_bulk.RawSamRecord(lines[j2], int(flags_r[j2]),
                                      int(mq_r[j2])))
        else:
            out_chunk[p] = python_pair(j, p)
    return None


def _special_record(db, rec, i, res, dp_result, splice_result, li, config,
                    mq, known=None):
    """A spliced or gapped record for batch row i if the ladder produced
    one that passes the filters; else None. Returns (record, effective
    start, strand)."""
    max_equiv = int(li * config.max_mismatch_frac)
    if i in splice_result:
        s = splice_result[i]
        alen = s["q_end"] - s["q_start"]
        if (s["nmm"] <= max(1, int(alen * config.max_mismatch_frac))
                and alen >= max(20, int(li * config.min_coverage))):
            count("path_rows")
            return (sam.path_record(
                db, rec.accession, rec.sequence, rec.quality,
                s["segs"], s["q_start"], s["q_end"], s["strand"], mq,
                known=known),
                s["segs"][0][1] + s["q_start"], s["strand"])
    if i in dp_result:
        pos0, ops, score = dp_result[i]
        if (3 * li - score) // 6 <= max_equiv:
            return (sam.gapped_record(
                db, rec.accession, rec.sequence, rec.quality, pos0,
                int(res["strand"][i]), mq, ops), pos0,
                int(res["strand"][i]))
    return None


def _pair_plan(r1, r2, e1, e2, pairmax, sp1=None, sp2=None,
               resolve_inner=True):
    """Mate-field arithmetic shared by the Python and bulk emitters: per
    mate (clip qs/qe, flag bits, mate univcoord or None, tlen) after the
    superseding specials and --resolve-inner dovetail clipping. TLEN and
    the proper-pair test against pairmax span the mates' aligned bases
    (SAM v1.6, 1.4): a special mate's from its own POS and CIGAR, a
    substitution placement's from its clips."""
    if sp1 is not None:
        e1 = (sp1[1], sp1[2], 0)
    if sp2 is not None:
        e2 = (sp2[1], sp2[2], 0)
    # q ranges are in the aligned orientation, so q_start always trims
    # the genomic-low side
    L1, L2 = len(r1.sequence), len(r2.sequence)
    clips = [[0, L1], [0, L2]]
    if (resolve_inner and e1 is not None and e2 is not None
            and sp1 is None and sp2 is None and e1[1] != e2[1]):
        (dplus, Lp, kp), (dminus, Lm, km) = (
            ((e1[0], L1, 0), (e2[0], L2, 1)) if e1[1] == 0 else
            ((e2[0], L2, 1), (e1[0], L1, 0)))
        over_hi = (dplus + Lp) - (dminus + Lm)   # plus end past fragment
        if 0 < over_hi <= Lp - 20:
            clips[kp][1] = Lp - over_hi
        over_lo = dplus - dminus                 # minus end before start
        if 0 < over_lo <= Lm - 20:
            clips[km][0] = over_lo
    plans = []
    for (e, other, first, ki) in ((e1, e2, True, 0), (e2, e1, False, 1)):
        flag_extra = 0x1 | (0x40 if first else 0x80)
        if e is None:
            flag_extra |= 0x4
        mate_u = None
        if other is None:
            flag_extra |= 0x8
        else:
            if other[1]:
                flag_extra |= 0x20
            mate_u = other[0] + clips[1 - ki][0]
        plans.append({"e": e, "qs": clips[ki][0], "qe": clips[ki][1],
                      "flag_extra": flag_extra, "mate_u": mate_u,
                      "tlen": 0})
    # proper pair and TLEN when both map on opposite strands in range
    if e1 is not None and e2 is not None and e1[1] != e2[1]:
        # each mate's aligned genome span [start, end)
        spans = [(e[0], e[0] + sam.ref_consumed(sp[0].cigar))
                 if sp is not None else (e[0] + clip[0], e[0] + clip[1])
                 for e, sp, clip in ((e1, sp1, clips[0]),
                                     (e2, sp2, clips[1]))]
        lo = min(spans[0][0], spans[1][0])
        hi = max(spans[0][1], spans[1][1])
        tlen = hi - lo
        if tlen <= pairmax:
            sign1 = 1 if spans[0][0] <= spans[1][0] else -1
            for pl, sg in ((plans[0], sign1), (plans[1], -sign1)):
                pl["flag_extra"] |= 0x2
                pl["tlen"] = sg * tlen
            if any(sp is not None and sn[1] == hi
                   for sp, sn in zip((sp1, sp2), spans)):
                count("tlen_from_alignment")
    return plans


def _plan_record(db, rec, pl, mq, sp=None):
    """The Python SamRecord a _pair_plan entry describes."""
    e = pl["e"]
    if sp is not None:
        s = sp[0]
    elif e is None:
        s = sam.unmapped_record(rec.accession, rec.sequence, rec.quality)
    else:
        s = sam.ungapped_record(db, rec.accession, rec.sequence,
                                rec.quality, e[0], e[1], mq, e[2],
                                q_start=pl["qs"], q_end=pl["qe"])
    s.flag |= pl["flag_extra"]
    if pl["mate_u"] is not None:
        rname, chrpos = db.chrpos(pl["mate_u"])
        s.rnext = "=" if (e is not None and s.rname == rname) else rname
        s.pnext = chrpos + 1
    s.tlen = pl["tlen"]
    return s


def _emit_pair(db, r1, r2, e1, e2, mq1, mq2, pairmax, special=None,
               keys=(None, None), resolve_inner=True):
    """Both records of a pair; a special (spliced, gapped or repaired)
    record supersedes its end's substitution placement, for its own
    fields and its mate's."""
    special = special or {}
    sp1, sp2 = special.get(keys[0]), special.get(keys[1])
    plans = _pair_plan(r1, r2, e1, e2, pairmax, sp1, sp2, resolve_inner)
    return (_plan_record(db, r1, plans[0], mq1, sp1),
            _plan_record(db, r2, plans[1], mq2, sp2))
