"""Host driver of the port: batching, the fused ladder and the staged
path, SAM output and failure isolation (port of the single-end path of
tpumap/gsnap/driver.py); the command line is tpumap_torch.cli.gsnap_cli.

The host half here is a JAX-free copy of tpumap's: `make_batch` packs a
batch in one C pass, the fused ladder runs on the index's device, and
its result goes through the same acceptance rules (indels, chain
solutions, the ambiguous splice-end review of stage 3b), MAPQ and
native SAM emitters (tpumap.io.sam_bulk) as tpumap's fused branch. Batch
i+1 is dispatched before the host work of batch i, so device and host
overlap.

Known splicing (-s) runs on the same fused ladder: partner diagonals
from the known junction table and the known-site bonus on the device,
every chain row through the Python path_record for its XS tag. The
alignment modes (--mode) and SNP tolerance (-v) change the cascade; as
in tpumap they turn the native emitters off, and the Python records
count NM/MD in the strand's base space (XW/XV with -v).

Fusions and learned indels take the staged path (tpumap's use_fused):
the cascade alone in the batch's program, then refine_unsolved's
stages, each its own launches: the indel DP (K2, K3), the chain stage
(K5) with its salvage scans (K6a), the splice-end review
(find_splice_ends, K6b), the fusion joins (refine_splices, torch ops);
the next batch is dispatched after them. The transcriptome rung (tr)
is a cascade of its own a batch (K1) on the transcript db's index;
its records carry the XX/XY remap tags. With device_ctx (a
parallel/pipeline.MeshContext) the device calls run data-parallel over a
device grid and give the single-device records.
"""
from __future__ import annotations

import ctypes
import sys
from collections import Counter

import numpy as np
import torch

from tpumap_torch import native
from tpumap_torch.gsnap import ladder
from tpumap_torch.gsnap import remap as remap_mod
from tpumap_torch.gsnap.engine import (AlignConfig, align_batch_cascaded,
                                       align_batch_cascaded_packed,
                                       mapq_from_scores, refine_indels,
                                       refine_splices)
from tpumap_torch.gsnap.knownsplicing import known_to_device
from tpumap_torch.gsnap.params import (CHAIN_K, CLIP_INDEL_TRIGGER,
                                       CLIP_SPLICE_TRIGGER, INDEL_BAND,
                                       INDEL_MARGIN, INDEL_NMM_TRIGGER,
                                       MAX_CAND_PAIRS, MIN_INTRON,
                                       SPLICE_NMM_TRIGGER)
from tpumap_torch.gsnap.spliceends import (AMB_MAX, NC_REVIEW_MAX,
                                           find_splice_ends,
                                           pool_device_results, xa_tag)
from tpumap_torch.index.build import GenomeDB
from tpumap_torch.index.device import DeviceIndex
from tpumap_torch.io import sam, sam_bulk
from tpumap_torch.io.fasta import Record
from tpumap_torch.ops import dp as dp_ops
from tpumap_torch.ops import localscan, pathdp, verify
from tpumap_torch.ops.mode import MODE_SPACES
from tpumap_torch.ops.pack import words_for
from tpumap_torch.utils import dna
from tpumap_torch.utils.trace import count, counting, counting_on, span, traced


MIN_FUSION_PIECE = 20     # src/path-fusion.c requires substantial ends
KNOWN_INDEL_BONUS = 12    # score credit for an indel at a learned site


# the methods a row is emitted by (--show-method's YM:Z tag); every other
# count of utils/trace.py is a counter of its own
METHODS = ("sub", "splice", "indel", "fusion", "tr", "unmapped")


def pad_to_bucket(n: int, buckets=(32, 64, 96, 128, 160, 192, 256, 384, 512)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return ((n + 511) // 512) * 512


@traced("encode")
def make_batch(records: list[Record], batch_size: int, L: int):
    """Encode a batch: codes/nmask/lengths, plus (with the native library)
    the 2-bit packed words, packed N flags, has_n and quals in one C
    pass."""
    codes = np.zeros((batch_size, L), dtype=np.uint8)
    nmask = np.zeros((batch_size, L), dtype=bool)
    lengths = np.zeros(batch_size, dtype=np.int32)
    lib = native.get_lib()
    any_qual = any(r.quality for r in records)
    if lib is not None and records:
        W = words_for(L)
        packed = np.zeros((batch_size, W), dtype=np.uint32)
        pnmask = np.zeros((batch_size, W), dtype=np.uint32)
        blob = "".join(r.sequence for r in records).encode("ascii")
        lens = np.fromiter((len(r.sequence) for r in records),
                           dtype=np.int64, count=len(records))
        starts = np.zeros(len(records), dtype=np.int64)
        np.cumsum(lens[:-1], out=starts[1:])
        if any_qual:
            quals = np.empty((batch_size, L), dtype=np.uint8)
            quals[len(records):] = 30
            qblob = "".join(r.quality or "" for r in records).encode(
                "ascii", "replace")
            qlens = np.fromiter((len(r.quality or "") for r in records),
                                dtype=np.int64, count=len(records))
            qstarts = np.zeros(len(records), dtype=np.int64)
            np.cumsum(qlens[:-1], out=qstarts[1:])
            has_q = (qlens >= lens).astype(np.uint8)
        else:
            quals = qblob = None
            qstarts = has_q = None
        lp = ctypes.POINTER(ctypes.c_long)
        u8 = ctypes.POINTER(ctypes.c_uint8)
        any_n = lib.encode_packed_batch(
            blob, starts.ctypes.data_as(lp), lens.ctypes.data_as(lp),
            len(records),
            qblob, qstarts.ctypes.data_as(lp) if any_qual else None,
            has_q.ctypes.data_as(u8) if any_qual else None,
            L, W,
            codes.ctypes.data_as(u8),
            nmask.ctypes.data_as(u8),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            pnmask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            quals.ctypes.data_as(u8) if any_qual else None)
        batch = {"codes": codes, "nmask": nmask, "lengths": lengths,
                 "packed": packed, "pnmask": pnmask,
                 "has_n": bool(any_n)}
        if any_qual:
            batch["quals"] = quals
        return batch
    for i, rec in enumerate(records):
        c, m = dna.encode(rec.sequence)
        codes[i, :len(c)] = c
        nmask[i, :len(c)] = m
        lengths[i] = len(c)
    quals = None
    for i, rec in enumerate(records):
        if rec.quality:
            if quals is None:
                quals = np.full((batch_size, L), 30, dtype=np.uint8)
            qv = np.frombuffer(rec.quality.encode("ascii"),
                               np.uint8)[:lengths[i]]
            quals[i, :len(qv)] = np.maximum(qv, 33) - 33
    batch = {"codes": codes, "nmask": nmask, "lengths": lengths}
    if quals is not None:
        batch["quals"] = quals
    return batch


def _pack_host(codes: np.ndarray) -> np.ndarray:
    """[B, L] uint8 codes -> [B, ceil(L/16)] uint32 packed words."""
    B, L = codes.shape
    W = words_for(L)
    lanes = np.pad(codes, ((0, 0), (0, 16 * W - L))).reshape(B, W, 16)
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, None, :]
    return (lanes.astype(np.uint32) << shifts).sum(axis=2, dtype=np.uint32)


@traced("upload")
def _to_device(batch, device) -> dict:
    """A make_batch dict as the ladder's device inputs; N-free batches
    send a (1, 1) pnmask stub."""
    if "packed" in batch:
        packed, pnmask = batch["packed"], batch["pnmask"]
        has_n = batch.get("has_n", True)
    else:
        packed = _pack_host(batch["codes"])
        pnmask = _pack_host(batch["nmask"].astype(np.uint8))
        has_n = bool(batch["nmask"].any())
    if not has_n:
        pnmask = np.zeros((1, 1), dtype=np.uint32)

    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if torch.device(device).type == "cuda":
            # pinned source: the copy is queued, the host does not wait
            return t.pin_memory().to(device, non_blocking=True)
        return t

    out = {"packed": put(packed.view(np.int32)),
           "pnmask": put(pnmask.view(np.int32)),
           "lengths": put(batch["lengths"])}
    if "quals" in batch:        # FASTQ input: quality-weighted MAPQ
        out["quals"] = put(batch["quals"])
    return out


def _indel_limits_ok(ops, max_insertions: int, max_deletions: int,
                     indel_endlength: int) -> bool:
    """Enforce gsnap -Y/--max-insertions, -Z/--max-deletions and
    --indel-endlength on a DP edit transcript (forward order)."""
    if not ops:
        return True
    runs = []                     # (op, runlength)
    for o in ops:
        if runs and runs[-1][0] == o:
            runs[-1][1] += 1
        else:
            runs.append([o, 1])
    if all(o == dp_ops.T_MATCH for o, _n in runs):
        return True
    for o, n in runs:
        if o == dp_ops.T_INS and n > max_insertions:
            return False
        if o == dp_ops.T_DEL and n > max_deletions:
            return False
    if runs[0][0] != dp_ops.T_MATCH or runs[0][1] < indel_endlength:
        return False
    if runs[-1][0] != dp_ops.T_MATCH or runs[-1][1] < indel_endlength:
        return False
    return True


@traced("refine")
def refine_unsolved(db, index, batch, res, config, novelsplicing=False,
                    max_intron=200_000, known=None, find_fusions=False,
                    tr_records=None, L=None, max_insertions=6,
                    max_deletions=9, indel_endlength=4, use_localdb=True,
                    known_indels=None, quals=None, amb_out=None,
                    dict_all=False, device_ctx=None):
    """The refinement ladder after the cascade, shared by the single-end
    and paired drivers (tpumap driver.py:271-680). On the fused ladder's
    results (res holds in_idx) the host acceptance of its chain and indel
    blocks; on the staged path's (a cascade dict) the stages themselves,
    each its own launches on the index's device: the indel DP (K2, K3)
    with the known-indel trigger, the chain stage (K5) over the ranked
    candidates, known partners and the salvage scans (K6a). Then the
    ambiguous splice-end review and the fusions (_late_stages). Returns
    (dp_result, splice_result, fusion_result) keyed by batch row:
    dp_result[i] = (genome start, forward ops, score); splice_result
    dicts (every chain row with known splicing or dict_all, the paired
    emitter's need; res["sp_sel"] the fused ladder's array-form rest)."""
    tr_records = tr_records or {}
    if L is None:
        L = batch["codes"].shape[1]
    chunk_len = res["nmismatch"].shape[0]
    len_v = np.asarray(batch["lengths"])[:chunk_len].astype(np.int32)
    if "in_idx" in res:
        dp_result, splice_result = _fused_acceptance(
            batch, res, known, dict_all, chunk_len, len_v, max_insertions,
            max_deletions, indel_endlength)
    else:
        dp_result = _staged_indels(
            index, batch, res, tr_records, L, chunk_len, len_v,
            max_insertions, max_deletions, indel_endlength, known_indels)
        splice_result = {}
        if novelsplicing or known is not None:
            splice_result = _staged_chains(
                db, index, batch, res, dp_result, tr_records, L, chunk_len,
                len_v, novelsplicing, max_intron, known, use_localdb, quals,
                device_ctx)
    count("indel_accepted", len(dp_result))
    return _late_stages(db, index, batch, res, config, dp_result,
                        splice_result, novelsplicing, max_intron, known,
                        find_fusions, tr_records, L, amb_out, chunk_len,
                        len_v)


def _fused_acceptance(batch, res, known, dict_all, chunk_len, len_v,
                      max_insertions, max_deletions, indel_endlength):
    """Host acceptance of the fused ladder's chain and indel blocks
    (tpumap's fused branch of refine_unsolved): (dp_result,
    splice_result), and res["sp_sel"] for the chain rows the native
    emitters take as arrays."""
    diag_v = res["diag"][:chunk_len]
    dp_result = {}
    splice_result = {}
    if "ch_sel" in res:
        ch_idx = res["ch_idx"]
        segq_l = res["ch_segq"]
        segd_l = res["ch_segd"]
        nsegs_l = res["ch_nsegs"].astype(np.int32)
        st_l = res["strand"]
        sel = res["ch_sel"] & (ch_idx < chunk_len)
        # rows whose accepted path has a short terminal exon need the
        # splice-ends review and so a mutable dict; the rest stay
        # array-form for the native bulk emitter (sp_sel)
        last_q = np.take_along_axis(
            segq_l, np.maximum(nsegs_l - 1, 0)[:, None],
            axis=1)[:, 0].astype(np.int64)
        multi = nsegs_l >= 2
        end_short = multi & (res["ch_qend"] - last_q >= 1) & (
            res["ch_qend"] - last_q <= NC_REVIEW_MAX)
        start_short = multi & (
            segq_l[:, 1].astype(np.int64) - res["ch_qstart"] >= 1) & (
            segq_l[:, 1].astype(np.int64) - res["ch_qstart"]
            <= NC_REVIEW_MAX)
        # insertion junctions (diagonal decreases) emit through
        # path_record: the native emitter takes N/D gaps only
        sd = segd_l.astype(np.int64)
        vpair = np.arange(1, sd.shape[1])[None, :] < nsegs_l[:, None]
        has_ins = np.any(vpair & (sd[:, 1:] < sd[:, :-1]), axis=1)
        need_dict = sel & (end_short | start_short | has_ins)
        if sam_bulk._get_lib() is None or dict_all or known is not None:
            need_dict = sel
        for r in np.nonzero(need_dict)[0].tolist():
            i = int(ch_idx[r])
            ns = int(nsegs_l[r])
            splice_result[i] = {
                "segs": list(zip(segq_l[r][:ns].tolist(),
                                 segd_l[r][:ns].tolist())),
                "q_start": int(res["ch_qstart"][r]),
                "q_end": int(res["ch_qend"][r]),
                "strand": int(st_l[i]),
                "score": int(res["ch_score"][r]),
                "nmm": int(res["ch_nmm"][r]),
            }
        res["sp_sel"] = sel & ~need_dict
    irows = np.nonzero(res["in_sel"])[0]
    count("indel_rows", len(irows))
    if len(irows):
        nmm_v = res["nmismatch"]
        trim_score_v = res.get("trim_score")
        runop_l = res["in_runop"][irows].tolist()
        runlen_l = res["in_runlen"][irows].tolist()
        score_l = res["in_score"][irows].tolist()
        start_l = res["in_startoff"][irows].tolist()
        for row, r in enumerate(irows.tolist()):
            i = int(res["in_idx"][r])
            if i >= chunk_len or i in splice_result:
                continue
            li = int(len_v[i])
            sub_score = 3 * li - 6 * int(nmm_v[i])
            if trim_score_v is not None:
                sub_score = max(sub_score, int(trim_score_v[i]) * 3 // 8)
            if score_l[row] > sub_score:
                ops = []
                for op1, n in zip(runop_l[row], runlen_l[row]):
                    if not op1:
                        break
                    ops.extend([op1 - 1] * n)
                if not _indel_limits_ok(ops, max_insertions, max_deletions,
                                        indel_endlength):
                    continue
                dp_result[i] = (int(diag_v[i]) + start_l[row], ops,
                                score_l[row])
    return dp_result, splice_result


def _put(index, a: np.ndarray) -> torch.Tensor:
    """A host array on the index's device (uint32 as int64)."""
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a)).to(index.device)


def _staged_indels(index, batch, res, tr_records, L, chunk_len, len_v,
                   max_insertions, max_deletions, indel_endlength,
                   known_indels):
    """The staged indel stage (tpumap driver.py:398-474): banded DP and
    traceback (refine_indels: K2, K3) on the rows at or past the
    mismatch or clip trigger, or (known_indels) with a mismatch over a
    learned indel site; an indel placed at a learned site relaxes the
    end length and gets a score bonus."""
    diag_v = np.asarray(res["diag"])[:chunk_len]
    nmm_v = np.asarray(res["nmismatch"])[:chunk_len]
    strand_v = np.asarray(res["strand"])[:chunk_len]
    valid_v = diag_v != 0xFFFFFFFF
    nmm_l = nmm_v.tolist()
    need_m = valid_v & (nmm_v >= INDEL_NMM_TRIGGER)
    if "trim_qstart" in res:
        # clipped ends can hide an end indel under the mismatch trigger
        tqs_c = np.asarray(res["trim_qstart"])[:chunk_len]
        tqe_c = np.minimum(np.asarray(res["trim_qend"])[:chunk_len], len_v)
        need_m |= valid_v & ((tqs_c + (len_v - tqe_c))
                             >= CLIP_INDEL_TRIGGER)
    if known_indels is not None:
        for i in np.nonzero(valid_v & ~need_m & (nmm_v >= 1))[0]:
            d = int(diag_v[i])
            if known_indels.any_in(d, d + int(len_v[i])):
                need_m[i] = True
    for i in tr_records:
        if i < chunk_len:
            need_m[i] = False
    need = np.nonzero(need_m)[0]
    count("indel_rows", len(need))
    dp_result = {}
    if not len(need):
        return dp_result
    nb = pad_to_bucket(len(need))
    codes = np.zeros((nb, L), dtype=np.uint8)
    lengths = np.ones(nb, dtype=np.int32)
    diags = np.zeros(nb, dtype=np.uint32)
    codes[:len(need)], _ = _oriented_rows(batch, need, strand_v[need], L)
    lengths[:len(need)] = len_v[need]
    diags[:len(need)] = diag_v[need]
    ref = refine_indels(index, _put(index, codes), _put(index, lengths),
                        _put(index, diags), INDEL_BAND, INDEL_MARGIN)
    ops_l = ref["ops"].cpu().tolist()
    score_l = ref["score"].cpu().tolist()
    start_l = ref["start_off"].cpu().tolist()
    trim_score_l = (np.asarray(res["trim_score"]).tolist()
                    if "trim_score" in res else None)
    for row, i in enumerate(need):
        li = int(len_v[i])
        sub_score = 3 * li - 6 * nmm_l[i]
        if trim_score_l is not None:
            # an end-trimmed soft clip may already explain the read
            sub_score = max(sub_score, trim_score_l[i] * 3 // 8)
        ops = [o for o in ops_l[row][::-1] if o != dp_ops.T_END]
        # an indel placed at a learned site relaxes the end length and
        # gets a score bonus (src/knownindels.c)
        eff_endlength = indel_endlength
        bonus = 0
        if known_indels is not None:
            g = int(diag_v[i]) + start_l[row]
            goff = 0
            for o in ops:
                if o != dp_ops.T_MATCH and known_indels.near(g + goff):
                    eff_endlength = min(indel_endlength, 2)
                    bonus = KNOWN_INDEL_BONUS
                    break
                if o != dp_ops.T_INS:
                    goff += 1
        if score_l[row] + bonus > sub_score:
            if not _indel_limits_ok(ops, max_insertions, max_deletions,
                                    eff_endlength):
                continue
            dp_result[i] = (int(diag_v[i]) + start_l[row], ops,
                            score_l[row])
    return dp_result


def _staged_chains(db, index, batch, res, dp_result, tr_records, L,
                   chunk_len, len_v, novelsplicing, max_intron, known,
                   use_localdb, quals, device_ctx=None):
    """The staged chain stage (tpumap driver.py:476-668): each row at
    the splice trigger (mismatches or clipped bases) gets its ranked
    candidates, known-junction partners and, with one candidate, the
    salvage scans' placements of its unseeded end (K6a over a window
    of the localdb scale), solved by the chain DP (K5); a solution that
    beats the row's other paths and stays on one chromosome goes to
    splice_result."""
    diag_v = np.asarray(res["diag"])[:chunk_len]
    strand_v = np.asarray(res["strand"])[:chunk_len]
    valid_v = diag_v != 0xFFFFFFFF
    nmm_l = np.asarray(res["nmismatch"])[:chunk_len].tolist()
    trim_nmm = res.get("trim_nmm", res["nmismatch"])
    trim_qs = res.get("trim_qstart")
    trim_qe = res.get("trim_qend")
    chain_m = valid_v & (np.asarray(trim_nmm)[:chunk_len]
                         >= SPLICE_NMM_TRIGGER)
    if trim_qs is not None:
        clipped_v = (np.asarray(trim_qs)[:chunk_len]
                     + (len_v - np.asarray(trim_qe)[:chunk_len]))
        chain_m |= valid_v & (clipped_v >= CLIP_SPLICE_TRIGGER)
    for i in tr_records:
        if i < chunk_len:
            chain_m[i] = False
    sneed = np.nonzero(chain_m)[0]
    splice_result = {}
    if not len(sneed):
        return splice_result
    cd_rows = np.asarray(res["cand_diags"])[sneed]
    keep = ((cd_rows != 0xFFFFFFFF)
            & (np.asarray(res["cand_strands"])[sneed]
               == strand_v[sneed, None]))
    cands_per_read = []
    for j, i in enumerate(sneed):
        # first-occurrence dedupe, order kept
        cands = list(dict.fromkeys(cd_rows[j][keep[j]].tolist()))
        if known is not None:
            li = int(len_v[i])
            for a in list(cands):
                for (_da, db_) in known.derived_pairs(a, li, max_intron):
                    if db_ not in cands:
                        cands.append(db_)
        cands_per_read.append((int(strand_v[i]), cands[:CHAIN_K]))
    # one oriented gather serves the salvage and the chain rows
    sc_codes, sc_nmask = _oriented_rows(batch, sneed, strand_v[sneed], L)
    sc_quals = None
    if quals is not None:
        _c, _m, sc_quals = _oriented_rows(batch, sneed, strand_v[sneed], L,
                                          quals=np.asarray(quals))
    if novelsplicing and use_localdb:
        _salvage(db, index, sneed, cands_per_read, sc_codes, len_v,
                 max_intron)
    row_js = [j for j, (_st0, cands) in enumerate(cands_per_read) if cands]
    rows = [(int(sneed[j]),) + cands_per_read[j] for j in row_js]
    if not rows:
        return splice_result
    nb = pad_to_bucket(len(rows))
    codes = np.zeros((nb, L), dtype=np.uint8)
    nmask = np.zeros((nb, L), dtype=bool)
    lengths = np.ones(nb, dtype=np.int32)
    cdiags = np.full((nb, CHAIN_K), 0xFFFFFFFF, dtype=np.uint32)
    cquals = np.full((nb, L), 30, dtype=np.uint8)
    codes[:len(rows)] = sc_codes[row_js]
    nmask[:len(rows)] = sc_nmask[row_js]
    lengths[:len(rows)] = len_v[sneed[row_js]]
    if quals is not None:
        cquals[:len(rows)] = sc_quals[row_js]
    for row, (_i, _st0, cands) in enumerate(rows):
        cdiags[row, :len(cands)] = cands
    # a device context (parallel/pipeline.py) runs the chain solver over
    # its device grid
    _chain = (device_ctx.chain_solve if device_ctx is not None
              else pathdp.chain_solve)
    cres = _chain(
        index, _put(index, codes), _put(index, nmask),
        _put(index, lengths), _put(index, cdiags),
        scoring=pathdp.PathScoring(max_intron=max(max_intron, MIN_INTRON)),
        with_quals=quals is not None,
        quals=_put(index, cquals) if quals is not None else None,
        known=(known_to_device(known, index.device) if known is not None
               else None))
    cres = {k: v.cpu().numpy() for k, v in cres.items()}
    nsegs_l = cres["nsegs"].tolist()
    score_l8 = cres["score"].tolist()
    qs_l = cres["q_start"].tolist()
    qe_l = cres["q_end"].tolist()
    nmm_cl = cres["nmm"].tolist()
    segq_l = cres["seg_q"].tolist()
    segd_l = cres["seg_diag"].tolist()
    trim_score_l2 = (np.asarray(res["trim_score"]).tolist()
                     if trim_qs is not None else None)
    for row, (i, st0, cands) in enumerate(rows):
        li = int(len_v[i])
        nsegs = nsegs_l[row]
        if nsegs < 1:
            continue
        score8 = score_l8[row]
        # the alternatives on the same 8-scale: the trimmed (or full)
        # substitution path and the indel path
        if trim_score_l2 is not None:
            best_other = trim_score_l2[i]
        else:
            best_other = 8 * li - 32 * nmm_l[i]
        if i in dp_result:
            best_other = max(best_other, dp_result[i][2] * 8 // 3)
        if score8 <= best_other:
            continue
        q_start = qs_l[row]
        q_end = qe_l[row]
        segs = list(zip(segq_l[row][:nsegs], segd_l[row][:nsegs]))
        # every segment on one chromosome
        chroms = {db.chrnum(d + q) for q, d in segs}
        chroms.add(db.chrnum(segs[-1][1] + q_end - 1))
        if len(chroms) != 1:
            continue
        splice_result[i] = {
            "segs": segs, "q_start": q_start, "q_end": q_end,
            "strand": st0, "score": score8, "nmm": nmm_cl[row],
        }
    return splice_result


def _salvage(db, index, sneed, cands_per_read, sc_codes, len_v,
             max_intron):
    """The localdb salvage of the staged chain stage (tpumap
    driver.py:531-606): a row with one candidate has its unaligned
    ends (past its first and last 20-base exact runs, native
    anchor_runs) located by fragment scans (K6a) in a window of the
    localdb scale; placements within the intron range join its
    candidates (cands_per_read, in place)."""
    one = [j for j, (_st0, cands) in enumerate(cands_per_read)
           if len(cands) == 1]
    if not one:
        return
    adiag = np.array([cands_per_read[j][1][0] for j in one],
                     dtype=np.uint64)
    alen = len_v[sneed[one]].astype(np.int32)
    u_arr, e_arr = _anchor_runs(db, adiag,
                                np.ascontiguousarray(sc_codes[one]), alen)
    salv = []
    for k, j in enumerate(one):
        if u_arr[k] < 0:
            continue
        salv.append((j, int(adiag[k]), sc_codes[j], int(alen[k]),
                     int(u_arr[k]), int(e_arr[k])))
    if not salv:
        return
    F = 16
    # the reference's localdb region scale (65,536-bp suffix arrays);
    # splice distances past W are the seeded chain path's
    W = min(65536, max(1024, max_intron))
    R = pad_to_bucket(len(salv))
    frag_s = np.zeros((R, F), dtype=np.uint8)
    frag_p = np.zeros((R, F), dtype=np.uint8)
    flen_s = np.ones(R, dtype=np.int32)
    flen_p = np.ones(R, dtype=np.int32)
    ws_s = np.zeros(R, dtype=np.uint32)
    ws_p = np.zeros(R, dtype=np.uint32)
    for row, (j, a, c, li, u, e) in enumerate(salv):
        v = li - e                  # the unaligned suffix
        if v >= 6:
            fl = min(F, v)
            frag_s[row, :fl] = c[e:e + fl]
            flen_s[row] = fl
            ws_s[row] = a + e + MIN_INTRON
        if u >= 6:
            fl = min(F, u)
            frag_p[row, :fl] = c[u - fl:u]
            flen_p[row] = fl
            ws_p[row] = max(a - MIN_INTRON - W, 0)
    pos_s, mm_s = localscan.scan_fragment(
        index.genome_packed, _put(index, ws_s), _put(index, frag_s),
        _put(index, flen_s), W, F)
    pos_p, mm_p = localscan.scan_fragment(
        index.genome_packed, _put(index, ws_p), _put(index, frag_p),
        _put(index, flen_p), W, F)
    pos_s, mm_s, pos_p, mm_p = (x.cpu().numpy()
                                for x in (pos_s, mm_s, pos_p, mm_p))
    for row, (j, a, c, li, u, e) in enumerate(salv):
        v = li - e
        st0, cands = cands_per_read[j]
        if v >= 6:
            for t in range(pos_s.shape[1]):
                if mm_s[row, t] <= 1:
                    dB = int(pos_s[row, t]) - e
                    if (MIN_INTRON <= dB - a <= max_intron
                            and dB not in cands):
                        cands.append(dB)
        if u >= 6:
            fl = min(F, u)
            for t in range(pos_p.shape[1]):
                if mm_p[row, t] <= 1:
                    dA = int(pos_p[row, t]) - (u - fl)
                    if (MIN_INTRON <= a - dA <= max_intron
                            and dA not in cands):
                        cands.append(dA)
        cands_per_read[j] = (st0, cands[:CHAIN_K])


def _anchor_runs(db, diags, codes_rows, lengths, runlen: int = 20):
    """Per row: the first 20-base exact run's start (u) and the last
    run's end (e) of the read against the genome on its diagonal (the
    native anchor_runs); u = -1 where there is no run."""
    R, Lstride = codes_rows.shape
    u_out = np.full(R, -1, dtype=np.int32)
    e_out = np.full(R, -1, dtype=np.int32)
    lib = native.get_lib()
    if lib is not None:
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.anchor_runs(
            db.genome_packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            len(db.genome_packed) << 4,
            np.ascontiguousarray(diags, np.uint64).ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint64)),
            codes_rows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            Lstride,
            np.ascontiguousarray(lengths, np.int32).ctypes.data_as(i32p),
            R, runlen, u_out.ctypes.data_as(i32p),
            e_out.ctypes.data_as(i32p))
        return u_out, e_out
    # without g++ (native.get_lib says so): tpumap's Python loop
    for r in range(R):
        li = int(lengths[r])
        g = db.get_codes(int(diags[r]), li)
        if len(g) < li:
            continue
        match = codes_rows[r, :li] == g
        runs = np.convolve(match.astype(np.int32),
                           np.ones(runlen, dtype=np.int32),
                           mode="valid") == runlen
        starts = np.nonzero(runs)[0]
        if len(starts):
            u_out[r] = int(starts[0])
            e_out[r] = int(starts[-1]) + runlen
    return u_out, e_out


def _oriented_rows(batch, idx, strands, L, quals=None):
    """Host rows idx of the batch as (codes, nmask[, quals]), strand-1
    rows reverse-complemented (past the read length zero-padded)."""
    codes = np.asarray(batch["codes"])[idx]
    nmask = np.asarray(batch["nmask"])[idx]
    li = np.asarray(batch["lengths"])[idx].astype(np.int64)
    st = np.asarray(strands).astype(bool)
    qv = quals[idx] if quals is not None else None
    if st.any():
        ar = np.arange(L)
        src = li[:, None] - 1 - ar[None, :]
        valid = src >= 0
        srcc = np.clip(src, 0, L - 1)
        rc = np.where(valid, 3 - np.take_along_axis(codes, srcc, axis=1),
                      0).astype(np.uint8)
        rm = np.where(valid, np.take_along_axis(nmask, srcc, axis=1),
                      False)
        codes = np.where(st[:, None], rc, codes)
        nmask = np.where(st[:, None], rm, nmask)
        if qv is not None:
            rq = np.where(valid, np.take_along_axis(qv, srcc, axis=1),
                          0).astype(np.uint8)
            qv = np.where(st[:, None], rq, qv)
    if quals is not None:
        return codes, nmask, qv
    return codes, nmask


_CANON_PAIRS = {(2, 3, 0, 2), (2, 1, 0, 2), (0, 3, 0, 1),   # GT-AG GC-AG AT-AC
                (1, 3, 0, 1), (1, 3, 2, 1), (2, 3, 0, 3)}   # antisense


def _junction_bonus_zero(db, dprox, ddist, qb, known) -> bool:
    """True iff the junction boundary at query position qb between the
    proximal diagonal dprox and distal diagonal ddist carries no signal:
    noncanonical dinucleotides and (if given) not a known site pair."""
    lo, hi = (dprox, ddist) if dprox <= ddist else (ddist, dprox)
    don = db.get_codes(lo + qb, 2)
    acc = db.get_codes(hi + qb - 2, 2)
    if len(don) < 2 or len(acc) < 2:
        return False
    if (int(don[0]), int(don[1]), int(acc[0]), int(acc[1])) in _CANON_PAIRS:
        return False
    if known is not None:
        sl, sr = lo + qb, hi + qb
        if ((sl in known.donor and sr in known.acceptor)
                or (sl in known.antiacceptor and sr in known.antidonor)):
            return False
    return True


def _noncanon_tie(db, c, s, side, known) -> bool:
    """The altsplice.c tie rule on a junction boundary: a noncanonical
    boundary that can wobble to another equal-mismatch noncanonical
    placement has no evidence for either, and the caller demotes the
    terminal exon to a soft clip."""
    segs = s["segs"]
    if side == "qend":
        qb, dprox, ddist = segs[-1][0], segs[-2][1], segs[-1][1]
        lo_q = segs[-2][0] + 1
        hi_q = s["q_end"] - 1
    else:
        qb, ddist, dprox = segs[1][0], segs[0][1], segs[1][1]
        lo_q = s["q_start"] + 1
        hi_q = (segs[2][0] if len(segs) > 2 else s["q_end"]) - 1
    if not _junction_bonus_zero(db, dprox, ddist, qb, known):
        return False
    d_lt = segs[-2][1] if side == "qend" else segs[0][1]   # earlier-q diag
    d_rt = segs[-1][1] if side == "qend" else segs[1][1]
    for sh in (-2, -1, 1, 2):
        qb2 = qb + sh
        if not (lo_q <= qb2 <= hi_q):
            continue
        a, b = sorted((qb, qb2))
        gl = db.get_codes(d_lt + a, b - a)
        gr = db.get_codes(d_rt + a, b - a)
        if len(gl) < b - a or len(gr) < b - a:
            continue
        seg = c[a:b]
        delta = int(np.sum(seg != gl)) - int(np.sum(seg != gr))
        if sh < 0:
            delta = -delta
        # a zero-cost move to another signal-free boundary is a tie
        if delta == 0 and _junction_bonus_zero(db, d_lt, d_rt, qb2, known):
            return True
    return False


def _demote(s, side) -> None:
    """Drop a path's terminal exon on `side`; the residue becomes a soft
    clip."""
    if side == "qend":
        s["score"] -= 8 * (s["q_end"] - s["segs"][-1][0])
        s["q_end"] = s["segs"][-1][0]
        s["segs"] = s["segs"][:-1]
    else:
        s["score"] -= 8 * (s["segs"][1][0] - s["q_start"])
        s["q_start"] = s["segs"][1][0]
        s["segs"] = s["segs"][1:]


def _splice_ends_review(db, index, batch, res, config, dp_result,
                        splice_result, max_intron, L, amb_out, chunk_len,
                        len_v, known, tr_records):
    """Stage 3b of tpumap's _late_stages (src/altsplice.c,
    src/spliceends.c): short terminal residues (1..AMB_MAX bases) placed
    by an exact-site scan: the fused ladder's in-program one, or on the
    staged path find_splice_ends (one K6b launch). A unique distal
    placement extends a
    trimmed row's path with the junction (into splice_result); tied
    placements keep the soft clip and go to amb_out (XA:Z:); a solved
    short terminal exon with tied placements, or with a noncanonical
    boundary that wobbles to a tie, is demoted to a soft clip."""
    diag_v = res["diag"][:chunk_len]
    strand_v = res["strand"][:chunk_len]
    valid_v = diag_v != 0xFFFFFFFF
    trim_nmm = res.get("trim_nmm", res["nmismatch"])
    amb_rows = []       # trimmed rows whose short end may splice
    review_rows = []    # solved splices with a short terminal exon
    nc_rows = []        # ... and those reviewed for boundary-wobble ties
    acode_req = {}
    acodes = {}
    tqs_v = np.asarray(res["trim_qstart"])[:chunk_len].astype(np.int64)
    tqe_v = np.minimum(np.asarray(res["trim_qend"])[:chunk_len],
                       len_v).astype(np.int64)
    u_va, v_va = tqs_v, len_v - tqe_v
    tnm_v = np.asarray(trim_nmm)[:chunk_len]
    amb_m = valid_v & (((u_va >= 1) & (u_va <= AMB_MAX))
                       | ((v_va >= 1) & (v_va <= AMB_MAX)))
    amb_m = amb_m & (tnm_v <= np.maximum(
        1, ((tqe_v - tqs_v).astype(np.float64)
            * config.max_mismatch_frac).astype(np.int64)))
    for i in sorted(set(np.nonzero(amb_m)[0].tolist()) | set(splice_result)):
        if i in tr_records or not valid_v[i]:
            continue
        li = int(len_v[i])
        if i in splice_result:
            s = splice_result[i]
            segs = s["segs"]
            if len(segs) < 2:
                continue
            sides = []
            # only splice junctions are reviewed; terminal segments joined
            # by an insertion or deletion are placed by the DP
            end_intron = int(segs[-1][1]) - int(segs[-2][1]) >= MIN_INTRON
            start_intron = int(segs[1][1]) - int(segs[0][1]) >= MIN_INTRON
            if end_intron and 1 <= s["q_end"] - segs[-1][0] <= AMB_MAX:
                sides.append(("qend", segs[-2][1], 0, segs[-1][0]))
            if start_intron and 1 <= segs[1][0] - s["q_start"] <= AMB_MAX:
                sides.append(("qstart", segs[1][1], segs[1][0], li))
            if (end_intron
                    and 1 <= s["q_end"] - segs[-1][0] <= NC_REVIEW_MAX):
                nc_rows.append((i, "qend"))
            if (start_intron
                    and 1 <= segs[1][0] - s["q_start"] <= NC_REVIEW_MAX):
                nc_rows.append((i, "qstart"))
            if not sides and not (nc_rows and nc_rows[-1][0] == i):
                continue
            acode_req[i] = s["strand"]
            for (side, a, tqs, tqe) in sides:
                review_rows.append((i, a, tqs, tqe, li, (side,)))
            continue
        if i in dp_result or not amb_m[i]:
            continue
        tqs, tqe = int(tqs_v[i]), int(tqe_v[i])
        acode_req[i] = int(strand_v[i])
        amb_rows.append((i, int(diag_v[i]), tqs, tqe, li,
                         ("qstart", "qend")))
    if acode_req:
        iis = np.fromiter(acode_req.keys(), dtype=np.int64)
        sts = np.fromiter(acode_req.values(), dtype=np.int64)
        ac, _m = _oriented_rows(batch, iis, sts, L)
        acodes = {int(ii): ac[k] for k, ii in enumerate(iis)}
    if amb_rows or review_rows:
        if "amb_pos" in res:
            # the fused ladder ran the review scan in its program
            se_res, se_amb = pool_device_results(res, max_intron)
        else:
            se_res, se_amb = find_splice_ends(
                db, index, acodes, amb_rows + review_rows, max_intron)
        for (i, a, tqs, tqe, li, _sides) in amb_rows:
            sides = se_res.get(i)
            if sides:
                lo, hi = tqs, tqe             # proximal segment span
                segs = []
                q_start, q_end = tqs, tqe
                for (side, qb, diag, _sense) in sides:
                    if side == "qstart":
                        segs.append((0, diag))
                        q_start, lo = 0, qb
                    else:
                        q_end, hi = li, qb
                segs.append((lo, a))
                for (side, qb, diag, _sense) in sides:
                    if side == "qend":
                        segs.append((qb, diag))
                # mismatches at the (possibly shifted) boundaries; the
                # distal residues matched exactly
                c = acodes[i]
                nmm = int(np.sum(c[lo:hi] != db.get_codes(a + lo, hi - lo)))
                splice_result[i] = {
                    "segs": segs, "q_start": q_start, "q_end": q_end,
                    "strand": int(res["strand"][i]),
                    "score": 8 * (q_end - q_start) - 32 * nmm,
                    "nmm": nmm,
                }
            if amb_out is not None and i in se_amb:
                amb_out[i] = se_amb[i]
        # a unique placement confirms a solved junction; tied placements
        # demote it and surface in XA:Z:
        for (i, _a, _tqs, _tqe, _li, sides) in review_rows:
            for amb in se_amb.get(i, []):
                if amb.side not in sides:
                    continue
                _demote(splice_result[i], amb.side)
                if amb_out is not None:
                    amb_out.setdefault(i, []).append(amb)
    for (i, side) in nc_rows:
        s = splice_result.get(i)
        if s is None or len(s["segs"]) < 2 or i not in acodes:
            continue
        if side == "qend" and s["q_end"] <= s["segs"][-1][0]:
            continue            # already demoted by the review above
        if side == "qstart" and s["q_start"] >= s["segs"][1][0]:
            continue
        if _noncanon_tie(db, acodes[i], s, side, known):
            _demote(s, side)


def _late_stages(db, index, batch, res, config, dp_result, splice_result,
                 novelsplicing, max_intron, known, find_fusions, tr_records,
                 L, amb_out, chunk_len, len_v):
    """The stages after the indel and chain stages on both paths (tpumap
    driver.py:739-1089): the ambiguous splice-end review (stage 3b),
    then the fusions. Returns the refine_unsolved triple."""
    if (novelsplicing or known is not None) and "trim_qstart" in res:
        _splice_ends_review(db, index, batch, res, config, dp_result,
                            splice_result, max_intron, L, amb_out,
                            chunk_len, len_v, known, tr_records)
    fusion_result = {}
    if find_fusions and "cand_diags" in res:
        fusion_result = _fusions(index, db, batch, res, dp_result,
                                 splice_result, tr_records, L, chunk_len,
                                 max_intron)
    return dp_result, splice_result, fusion_result


def _cands_by_strand(res, i):
    """Row i's distinct valid candidate diagonals by strand, in rank
    order."""
    cands = {0: [], 1: []}
    for c in range(res["cand_diags"].shape[1]):
        dg = int(res["cand_diags"][i, c])
        st = int(res["cand_strands"][i, c])
        if dg != 0xFFFFFFFF and dg not in cands[st]:
            cands[st].append(dg)
    return cands


def _fusions(index, db, batch, res, dp_result, splice_result, tr_records,
             L, chunk_len, max_intron):
    """Fusions (stage 4, tpumap driver.py:915-1089, src/path-fusion.c):
    for reads nothing else solved, same-strand candidate pairs on
    different chromosomes or outside the intron window scored as one
    junction (refine_splices), then inverted (cross-strand) joins from
    the two orientations' mismatch masks over the genome windows of the
    candidates (extract_codes_window). A join beating the row's other
    paths goes to fusion_result."""
    fusion_result = {}
    fneed = []
    for i in range(chunk_len):
        solved = (i in tr_records or i in splice_result
                  or (i in dp_result and (
                      3 * int(batch["lengths"][i])
                      - dp_result[i][2]) // 6 < SPLICE_NMM_TRIGGER))
        if res["nmismatch"][i] >= SPLICE_NMM_TRIGGER and not solved:
            fneed.append(i)
    fpairs_per_read = []
    for i in fneed:
        cands = _cands_by_strand(res, i)
        pairs = []
        for st in (0, 1):
            for a in cands[st]:
                for b in cands[st]:
                    if a == b:
                        continue
                    # a fusion pair is cross-chromosome, or outside the
                    # intron window (distant or inverted order)
                    same_chrom = db.chrnum(a) == db.chrnum(b)
                    intronic = MIN_INTRON <= b - a <= max_intron
                    if not same_chrom or not intronic:
                        pairs.append((a, b, st))
        fpairs_per_read.append(pairs[:MAX_CAND_PAIRS])
    fneed_all = list(fneed)         # the inversions see every candidate
    fneed = [i for i, p in zip(fneed, fpairs_per_read) if p]
    fpairs_per_read = [p for p in fpairs_per_read if p]
    if fneed:
        nb = pad_to_bucket(len(fneed))
        codes = np.zeros((nb, L), dtype=np.uint8)
        nmask = np.zeros((nb, L), dtype=bool)
        lengths = np.ones(nb, dtype=np.int32)
        dA = np.full((nb, MAX_CAND_PAIRS), 0xFFFFFFFF, dtype=np.uint32)
        dB = np.full((nb, MAX_CAND_PAIRS), 0xFFFFFFFF, dtype=np.uint32)
        strands = np.zeros((nb, MAX_CAND_PAIRS), dtype=np.int32)
        for row, (i, pairs) in enumerate(zip(fneed, fpairs_per_read)):
            li = int(batch["lengths"][i])
            st0 = pairs[0][2]
            c = batch["codes"][i]
            m = batch["nmask"][i]
            if st0:
                c = np.concatenate([dna.revcomp_codes(c[:li]),
                                    np.zeros(L - li, np.uint8)])
                m = np.concatenate([m[:li][::-1], np.zeros(L - li, bool)])
            codes[row] = c
            nmask[row] = m
            lengths[row] = li
            for pcol, (a, b, st) in enumerate(pairs):
                if st != st0:
                    continue
                dA[row, pcol] = a
                dB[row, pcol] = b
                strands[row, pcol] = st
        fres = refine_splices(index, _put(index, codes), _put(index, nmask),
                              _put(index, lengths), _put(index, dA),
                              _put(index, dB))
        fres = {k: v.cpu().numpy() for k, v in fres.items()}
        for row, i in enumerate(fneed):
            li = int(batch["lengths"][i])
            pcol = int(np.argmin(np.where(fres["valid"][row],
                                          fres["nmm"][row], li + 1)))
            if not fres["valid"][row][pcol]:
                continue
            qstar = int(fres["qstar"][row][pcol])
            nmm = int(fres["nmm"][row][pcol])
            if qstar < MIN_FUSION_PIECE or li - qstar < MIN_FUSION_PIECE:
                continue
            score = 3 * li - 6 * nmm - 24   # the distant-join penalty
            best_other = 3 * li - 6 * int(res["nmismatch"][i])
            if i in dp_result:
                best_other = max(best_other, dp_result[i][2])
            if score > best_other:
                fusion_result[i] = {
                    "dA": int(dA[row, pcol]), "dB": int(dB[row, pcol]),
                    "qstar": qstar, "strand": int(strands[row, pcol]),
                    "nmm": nmm, "score": score,
                }
    _inverted_fusions(index, batch, res, dp_result, fneed_all, L,
                      fusion_result)
    return fusion_result


def _inverted_fusions(index, batch, res, dp_result, fneed_all, L,
                      fusion_result):
    """Cross-strand joins (src/path-fusion.c inversions): one piece
    forward, the other reverse-complemented. For a (d_fwd, d_rc) pair
    the breakpoint cost needs only the two orientations' mismatch masks:
    fwd-first cost[q] = prefF[q] + prefR[L-q], rc-first cost[q] =
    (prefR[L] - prefR[L-q]) + (prefF[L] - prefF[q]), since read[q:] ==
    rc(read)[:L-q]. Fills fusion_result in place."""
    inv_rows = []           # (i, orient, diag): one mask row each
    inv_need = []
    for i in fneed_all:
        if i in fusion_result:
            continue
        cands = _cands_by_strand(res, i)
        if cands[0] and cands[1]:
            inv_need.append((i, cands[0][:4], cands[1][:4]))
    if not inv_need:
        return
    row_of = {}
    for i, cf, cr in inv_need:
        for st, cc in ((0, cf), (1, cr)):
            for dg in cc:
                row_of[(i, st, dg)] = len(inv_rows)
                inv_rows.append((i, st, dg))
    nb = pad_to_bucket(len(inv_rows))
    rcodes = np.zeros((nb, L), np.uint8)
    rnm = np.zeros((nb, L), bool)
    rdiags = np.zeros(nb, np.uint32)
    for row, (i, st, dg) in enumerate(inv_rows):
        li = int(batch["lengths"][i])
        c = batch["codes"][i]
        m = batch["nmask"][i]
        if st:
            c = np.concatenate([dna.revcomp_codes(c[:li]),
                                np.zeros(L - li, np.uint8)])
            m = np.concatenate([m[:li][::-1], np.zeros(L - li, bool)])
        rcodes[row] = c
        rnm[row] = m
        rdiags[row] = dg
    gwin = verify.extract_codes_window(index.genome_packed,
                                       _put(index, rdiags), L).cpu().numpy()
    n = len(inv_rows)
    masks = (gwin[:n] != rcodes[:n]) | rnm[:n]
    for i, cf, cr in inv_need:
        li = int(batch["lengths"][i])
        best = None
        for dF in cf:
            prefF = np.zeros(li + 1, np.int32)
            np.cumsum(masks[row_of[(i, 0, dF)]][:li], out=prefF[1:])
            for dR in cr:
                prefR = np.zeros(li + 1, np.int32)
                np.cumsum(masks[row_of[(i, 1, dR)]][:li], out=prefR[1:])
                qs = np.arange(MIN_FUSION_PIECE, li - MIN_FUSION_PIECE + 1)
                if len(qs) == 0:
                    continue
                c1 = prefF[qs] + prefR[li - qs]
                c2 = ((prefR[li] - prefR[li - qs])
                      + (prefF[li] - prefF[qs]))
                j1, j2 = int(np.argmin(c1)), int(np.argmin(c2))
                for q_, nmm_, ff in ((int(qs[j1]), int(c1[j1]), True),
                                     (int(qs[j2]), int(c2[j2]), False)):
                    if best is None or nmm_ < best[1]:
                        best = (q_, nmm_, ff, dF, dR)
        if best is None:
            continue
        q_, nmm_, ff, dF, dR = best
        score = 3 * li - 6 * nmm_ - 24      # the distant-join penalty
        best_other = 3 * li - 6 * int(res["nmismatch"][i])
        if i in dp_result:
            best_other = max(best_other, dp_result[i][2])
        if score > best_other:
            fusion_result[i] = {
                "inv": True, "d_fwd": dF, "d_rc": dR, "qstar": q_,
                "fwd_first": ff, "nmm": nmm_, "score": score,
            }


def _sub_rows(batch, res, config, n):
    """Per-row substitution classification shared by the emitters:
    (li, diag, strand, tqs, tqe, plain, trim_ok)."""
    li = np.asarray(batch["lengths"][:n]).astype(np.int32)
    mapped = np.asarray(res["mapped"][:n]).astype(bool)
    diag = np.asarray(res["diag"][:n]).astype(np.uint64)
    strand = np.asarray(res["strand"][:n]).astype(np.uint8)
    if config.soft_clips and "trim_qstart" in res:
        tqs = np.asarray(res["trim_qstart"][:n]).astype(np.int32)
        tqe = np.minimum(np.asarray(res["trim_qend"][:n]),
                         li).astype(np.int32)
    else:
        tqs = np.zeros(n, np.int32)
        tqe = li.copy()
    trimmed = (tqs > 0) | (tqe < li)
    alen = tqe - tqs
    trim_nmm = np.asarray(res.get("trim_nmm", res["nmismatch"])[:n])
    min_alen = np.maximum(20, (li * config.min_coverage).astype(np.int32))
    max_nmm = np.maximum(1, (alen.astype(np.float64)
                             * config.max_mismatch_frac).astype(np.int32))
    valid = np.asarray(res["diag"][:n]) != 0xFFFFFFFF
    trim_ok = valid & trimmed & (alen >= min_alen) & (trim_nmm <= max_nmm)
    plain = mapped & ~trimmed
    return li, diag, strand, tqs, tqe, plain, trim_ok


def _sp_array_rows(res, li, config, amb_result, tr_records, n):
    """Array-form chain solutions (res["sp_sel"]) of rows below n:
    (rsel, rows, ok), ok where the path passes the coverage and mismatch
    filters and has no XA alternatives or transcriptome record."""
    rsel = np.nonzero(res["sp_sel"])[0]
    ii = res["ch_idx"][rsel].astype(np.int64)
    keep = ii < n
    rsel, ii = rsel[keep], ii[keep]
    al = (res["ch_qend"][rsel] - res["ch_qstart"][rsel]).astype(np.int32)
    a_nmm = res["ch_nmm"][rsel].astype(np.int32)
    ok = ((a_nmm <= np.maximum(
              1, (al * config.max_mismatch_frac).astype(np.int32)))
          & (al >= np.maximum(
              20, (li[ii] * config.min_coverage).astype(np.int32))))
    if amb_result or tr_records:
        ok &= ~np.fromiter((int(i_) in amb_result or int(i_) in tr_records
                            for i_ in ii), dtype=bool, count=len(ii))
    return rsel, ii, ok


def _path_ok(s, li, config, S) -> bool:
    """A splice_result path the native emitters take: it passes the
    filters and has at most S segments, none joined by an insertion."""
    al = s["q_end"] - s["q_start"]
    if not (s["nmm"] <= max(1, int(al * config.max_mismatch_frac))
            and al >= max(20, int(li * config.min_coverage))):
        return False
    segs = s["segs"]
    return (segs[0][0] == s["q_start"] and len(segs) <= S
            and not any(b[1] < a[1] for a, b in zip(segs, segs[1:])))


@traced("emit")
def _bulk_emit_chunk(db, chunk, batch, res, mapq, overrides, config,
                     known):
    """Native C calls emit the final SAM text of every plain or
    soft-clipped ungapped row, every unmapped row and every chain-DP path
    row (known splicing leaves the path rows to path_record, for XS).
    overrides: (tr_records, splice_result, fusion_result, dp_result,
    amb_result, sec_map).
    Returns (lines, flags, methods), lines[i] None where the Python loop
    emits row i, or None without the native library."""
    if sam_bulk._get_lib() is None:
        return None
    tr_records, splice_result, _fus, _dp, amb_result, _sec = overrides
    n = len(chunk)
    li, diag, strand, tqs, tqe, plain, trim_ok = _sub_rows(batch, res,
                                                           config, n)
    emit = plain | trim_ok
    unm = ~plain & ~trim_ok
    for d in overrides:
        for i in d:
            if i < n:
                emit[i] = False
                unm[i] = False
    sp_rows = None
    if "sp_sel" in res and known is None:
        rsel, ii, ok = _sp_array_rows(res, li, config, amb_result,
                                      tr_records, n)
        emit[ii] = False            # spliced rows never emit as ungapped
        sp_rows = (rsel[ok], ii[ok])
        unm[sp_rows[1]] = False
    qstart = np.where(plain, 0, tqs).astype(np.int32)
    qend = np.where(plain, li, tqe).astype(np.int32)
    methods = np.full(n, "sub", dtype=object)
    flags = np.where(strand, 16, 0).astype(np.int32)
    lines = None
    if emit.any():
        lines = sam_bulk.emit_ungapped_bulk(
            db, chunk, batch["codes"], batch["nmask"], li, diag, strand,
            mapq, np.asarray(res["n_best"][:n]), qstart, qend, emit)
    if lines is None:
        lines = [None] * n
    if unm.any():
        ulines = sam_bulk.emit_unmapped_bulk(
            db, chunk, batch["codes"], batch["nmask"], li,
            unm.astype(np.uint8))
        if ulines is not None:
            for i in np.nonzero(unm)[0].tolist():
                if ulines[i] is not None:
                    lines[i] = ulines[i]
                    flags[i] = 4
                    methods[i] = "unmapped"

    # chain-DP spliced and deletion paths
    if (splice_result or (sp_rows is not None and len(sp_rows[0]))) \
            and known is None:
        S = res["ch_segq"].shape[1] if "ch_segq" in res else 8
        rows = []
        sp_strand = np.zeros(n, np.uint8)
        sp_qs = np.zeros(n, np.int32)
        sp_qe = np.zeros(n, np.int32)
        sp_emit = np.zeros(n, np.uint8)
        counts = np.zeros(n, dtype=np.int64)
        segq_m = np.zeros((n, S), np.int32)
        segd_m = np.zeros((n, S), np.uint64)
        if sp_rows is not None and len(sp_rows[0]):
            rsel, ii = sp_rows
            ns = res["ch_nsegs"][rsel].astype(np.int64)
            rows.extend(ii.tolist())
            sp_emit[ii] = 1
            flags[ii] = np.where(strand[ii], 16, 0)
            sp_strand[ii] = strand[ii]
            sp_qs[ii] = res["ch_qstart"][rsel]
            sp_qe[ii] = res["ch_qend"][rsel]
            counts[ii] = ns
            segq_m[ii] = res["ch_segq"][rsel]
            segd_m[ii] = res["ch_segd"][rsel]
            methods[ii[ns > 1]] = "splice"
        for i in sorted(splice_result):
            s = splice_result[i]
            if (i >= n or i in amb_result or i in tr_records
                    or not _path_ok(s, li[i], config, S)):
                continue
            segs = s["segs"]
            rows.append(i)
            sp_emit[i] = 1
            flags[i] = 16 if s["strand"] else 0
            sp_strand[i] = s["strand"]
            sp_qs[i] = s["q_start"]
            sp_qe[i] = s["q_end"]
            counts[i] = len(segs)
            for c_, (q0, d0) in enumerate(segs):
                segq_m[i, c_] = q0
                segd_m[i, c_] = d0
            methods[i] = "splice" if len(segs) > 1 else "sub"
        if rows:
            # row i's segments are [off[i], off[i+1]) of the flat arrays
            off = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(counts, out=off[1:])
            segmask = (np.arange(S, dtype=np.int64)[None, :]
                       < counts[:, None])
            plines = sam_bulk.emit_path_bulk(
                db, chunk, batch["codes"], batch["nmask"], li, sp_strand,
                mapq, sp_qs, sp_qe, off, segq_m[segmask].astype(np.int32),
                segd_m[segmask].astype(np.uint64), sp_emit, MIN_INTRON)
            if plines is not None:
                for i in rows:
                    if plines[i] is not None:
                        lines[i] = plines[i]
    return lines, flags, methods


@traced("emit")
def _mixed_emit_chunk(db, chunk, batch, res, mapq, overrides, config,
                      known):
    """Row-order blob emission: every unmapped, ungapped and chain-DP
    path row in one C call (io/sam_bulk.emit_mixed_blob); rows of the
    overrides (transcriptome records, splice_result rows the native
    emitter does not take, fusion and indel rows, rows with XA
    alternatives) get kind 0 and their lines from the Python loop. Returns (SamBlob, methods) or None without the
    native library."""
    if sam_bulk._get_lib() is None:
        return None
    tr_records, splice_result, fusion_result, dp_result, amb_result, \
        _sec = overrides
    n = len(chunk)
    li, diag, strand, tqs, tqe, plain, trim_ok = _sub_rows(batch, res,
                                                           config, n)
    kind = np.where(plain | trim_ok, np.uint8(2), np.uint8(1))
    qstart = np.where(plain, 0, tqs).astype(np.int32)
    qend = np.where(plain, li, tqe).astype(np.int32)
    S = res["ch_segq"].shape[1] if "ch_segq" in res else 8
    counts = np.zeros(n, dtype=np.int64)
    segq_m = np.zeros((n, S), np.int32)
    segd_m = np.zeros((n, S), np.uint64)
    if "sp_sel" in res and known is None:
        rsel, ii, ok = _sp_array_rows(res, li, config, amb_result,
                                      tr_records, n)
        rsel, ii = rsel[ok], ii[ok]
        if len(ii):
            kind[ii] = 3
            qstart[ii] = res["ch_qstart"][rsel]
            qend[ii] = res["ch_qend"][rsel]
            counts[ii] = res["ch_nsegs"][rsel].astype(np.int64)
            segq_m[ii] = res["ch_segq"][rsel]
            segd_m[ii] = res["ch_segd"][rsel]
    for i in sorted(splice_result):
        if i >= n:
            continue
        s = splice_result[i]
        kind[i] = 0             # the Python path_record by default
        if (known is not None or i in amb_result or i in tr_records
                or not _path_ok(s, li[i], config, S)):
            continue
        kind[i] = 3
        strand[i] = s["strand"]
        qstart[i] = s["q_start"]
        qend[i] = s["q_end"]
        counts[i] = len(s["segs"])
        for c_, (q0, d0) in enumerate(s["segs"]):
            segq_m[i, c_] = q0
            segd_m[i, c_] = d0
    for d in (tr_records, fusion_result, dp_result, amb_result):
        for i in d:
            if i < n:
                kind[i] = 0
    off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=off[1:])
    segmask = np.arange(S, dtype=np.int64)[None, :] < counts[:, None]
    mq_eff = np.where(kind == 1, 0, mapq[:n]).astype(np.int32)
    blob = sam_bulk.emit_mixed_blob(
        db, chunk, batch["codes"], batch["nmask"], li, kind, diag, strand,
        mq_eff, np.asarray(res["n_best"][:n]), qstart, qend, MIN_INTRON,
        seg_off=off, seg_q=segq_m[segmask].astype(np.int32),
        seg_d=segd_m[segmask].astype(np.uint64), has_qual="quals" in batch)
    if blob is None:
        return None
    methods = np.full(n, "sub", dtype=object)
    methods[kind == 1] = "unmapped"
    methods[(kind == 3) & (counts > 1)] = "splice"
    return blob, methods


def align_records(db: GenomeDB, index: DeviceIndex, records: list[Record],
                  config: AlignConfig = AlignConfig(),
                  novelsplicing: bool = False, max_intron: int = 200_000,
                  batch_size: int = 1024, known=None, tr=None,
                  find_fusions: bool = False, npaths: int = 1,
                  show_method: bool = False, stats: dict | None = None,
                  max_insertions: int = 6, max_deletions: int = 9,
                  indel_endlength: int = 4, use_localdb: bool = True,
                  merge_distant_samechr: bool = False, known_indels=None,
                  device_ctx=None, sink=None) -> list[sam.SamRecord]:
    """Align single-end reads (DNA, or RNA with novelsplicing and/or
    known, a KnownSplicing) on the index's device. Returns SAM records in
    input order, or, with sink (a callable taking bytes), streams the
    final SAM text to it in input order and returns [].

    The fused ladder serves every request it can express; fusions
    (find_fusions) and learned indels (known_indels, a KnownIndels) take
    the staged path: the cascade, then each refinement stage its own
    launches (refine_unsolved). tr, a (Transcriptome, DeviceIndex over
    its transcript db) pair, adds the transcriptome rung, its own
    cascade a batch, with the XX/XY remap tags on every mapped record.
    merge_distant_samechr emits a colinear same-chromosome distant join
    as one spliced line. device_ctx (parallel/pipeline.MeshContext)
    runs the batches' device work over its device grid; a context
    without a fused ladder (SingleChipContext) takes the staged path, as
    in tpumap. stats, if given, receives the counts of utils/trace.py:
    each METHODS row count, batches, reads, the overflow scalars, the
    indel rows and the rows each emitter wrote."""
    out = []
    remapper = None
    if tr is not None:
        remapper = getattr(tr[0], "_remapper", None)
        if remapper is None:
            remapper = remap_mod.TranscriptRemapper(tr[0])
            tr[0]._remapper = remapper
    use_fused = (not find_fusions and known_indels is None
                 and (device_ctx is None
                      or hasattr(device_ctx, "ladder_full")))
    scoring = pathdp.PathScoring(max_intron=max(max_intron, MIN_INTRON))
    known_dev = (known_to_device(known, index.device)
                 if known is not None and use_fused else None)
    splicing_on = novelsplicing or known is not None
    # one (B, L) shape for the whole run; runs smaller than one batch use
    # the small buckets
    run_L = pad_to_bucket(max((len(r.sequence) for r in records),
                              default=1))
    pad_tail = len(records) >= batch_size
    spaces = MODE_SPACES[config.mode]
    # the native emitters know no base space, alternate genome or remap
    can_bulk = (remapper is None and not show_method
                and not config.snp_tolerant and spaces == (None, None))

    def _dispatch(start):
        """Encode one batch and enqueue its device work and result
        copies; returns (chunk, batch, wait)."""
        chunk = records[start:start + batch_size]
        B = (batch_size if (pad_tail or len(chunk) == batch_size)
             else pad_to_bucket(len(chunk)))
        batch = make_batch(chunk, B, run_L)
        pbatch = _to_device(batch, index.device)
        with span("enqueue"):
            if use_fused:
                # compactions scale with the batch: an RNA batch can be
                # ~50% spliced
                r_chain = min(max(8192, B // 2), B)
                args = (config, run_L, scoring, splicing_on,
                        novelsplicing and use_localdb, r_chain,
                        min(max(2048, B // 8), r_chain), min(2048, B))
                if device_ctx is not None:
                    dev = device_ctx.ladder_full(pbatch, *args,
                                                 known=known_dev)
                else:
                    dev = ladder.align_batch_full(index, pbatch, *args,
                                                  known=known_dev)
            elif device_ctx is not None:
                dev = ladder.narrow_result(device_ctx.cascade(
                    index, pbatch, config, run_L))
            else:
                dev = ladder.narrow_result(align_batch_cascaded_packed(
                    index, pbatch, config, run_L))
        return chunk, batch, ladder.start_fetch(dev)

    starts = list(range(0, len(records), batch_size))
    # the staged path and the transcriptome rung launch work of their own
    # after the cascade: the next batch's program is enqueued after them,
    # so it does not run ahead of their small launches
    early_dispatch = (tr is None and not find_fusions
                      and (use_fused or not splicing_on))
    with counting(stats):
        pending = _dispatch(starts[0]) if starts else None
        for si, start in enumerate(starts):
            chunk, batch, wait = pending
            if si + 1 < len(starts) and early_dispatch:
                # the next batch's device work runs under this batch's
                # host work (refine, emission, the next encode)
                pending = _dispatch(starts[si + 1])
            tr_records = (_tr_rung(db, tr, chunk, batch, config)
                          if tr is not None else {})
            res = wait()
            if counting_on():
                ladder.count_batch(res, len(chunk))
            mapq = mapq_from_scores(res["nmismatch"],
                                    res["second_nmismatch"], res["n_best"],
                                    batch["lengths"],
                                    mm_qualsum=res.get("mm_qualsum"),
                                    qual_mean16=res.get("qual_mean16"))
            amb_result = {}
            dp_result, splice_result, fusion_result = refine_unsolved(
                db, index, batch, res, config, novelsplicing, max_intron,
                known, find_fusions, tr_records, run_L, max_insertions,
                max_deletions, indel_endlength, use_localdb, known_indels,
                batch.get("quals"), amb_result, device_ctx=device_ctx)
            # secondaries (-n > 1): the fused path's sec_* compaction, or
            # the staged path's full candidate lists of multimapping rows
            sec_map = {}
            if npaths > 1:
                if "sec_idx" in res:
                    for r in np.nonzero(res["sec_sel"])[0].tolist():
                        i2 = int(res["sec_idx"][r])
                        if i2 < len(chunk):
                            sec_map[i2] = (res["sec_diags"][r],
                                           res["sec_strands"][r],
                                           res["sec_nmm"][r])
                else:
                    nb_v = np.asarray(res["n_best"])[:len(chunk)]
                    for i2 in np.nonzero(nb_v > 1)[0].tolist():
                        sec_map[i2] = (res["cand_diags"][i2],
                                       res["cand_strands"][i2],
                                       res["cand_nmm"][i2])
            if si + 1 < len(starts) and not early_dispatch:
                # this batch's own launches are enqueued: now the next
                # batch
                pending = _dispatch(starts[si + 1])

            overrides = (tr_records, splice_result, fusion_result,
                         dp_result, amb_result, sec_map)
            bulk = None
            mix = None
            if sink is not None and can_bulk:
                mix = _mixed_emit_chunk(db, chunk, batch, res, mapq,
                                        overrides, config, known)
            if mix is None and can_bulk:
                bulk = _bulk_emit_chunk(db, chunk, batch, res, mapq,
                                        overrides, config, known)
            if mix is not None:
                blob, methods_m = mix
                native = blob.kind != 0
                if counting_on():
                    count("rows_native", int(np.count_nonzero(native)))
                    _count_methods(methods_m[native])
                if native.all():
                    sink(blob.buf)
                    continue
            _emit_rows(db, chunk, batch, res, mapq, config, overrides, bulk,
                       mix, out, sink, npaths, spaces, known, show_method,
                       remapper, merge_distant_samechr)
    return out


def _count_methods(methods) -> None:
    """Count each method of a list or array of rows' methods."""
    for m, c in Counter(list(methods)).items():
        count(m, c)


@traced("emit_rows")
def _emit_rows(db, chunk, batch, res, mapq, config, overrides, bulk, mix,
               out, sink, npaths, spaces, known, show_method, remapper,
               merge_distant_samechr) -> None:
    """The rows of one batch that the native emitters left (every row
    where neither ran: bulk and mix None), each through io/sam's Python
    records; appended to out, or with sink streamed in input order, into
    the native blob of mix at their row offsets. bulk: _bulk_emit_chunk's
    (lines, flags, methods); mix: _mixed_emit_chunk's (blob, methods)."""
    tr_records, splice_result, fusion_result, dp_result, amb_result, \
        sec_map = overrides
    if bulk is not None:
        bulk_lines, bulk_flags, bulk_methods = bulk
    rows_iter = range(len(chunk))
    row_marks = []
    if mix is not None:
        blob = mix[0]
        rows_iter = rows_py = np.nonzero(blob.kind == 0)[0].tolist()

    # every row bulk-emitted: skip the per-row loop
    if (bulk is not None and not tr_records and not splice_result
            and not fusion_result and not dp_result and not amb_result
            and all(ln is not None for ln in bulk_lines)):
        unm = bulk_methods == "unmapped"
        mq_l = np.where(unm, 0, mapq[:len(bulk_lines)]).tolist()
        if counting_on():
            count("rows_native", len(bulk_lines))
            _count_methods(bulk_methods)
        out.extend(map(sam_bulk.RawSamRecord, bulk_lines,
                       bulk_flags.tolist(), mq_l))
        return

    def _emit(record, method, nh=1):
        if not record.flag & 4 and i in amb_result:
            # tied splice-end placements: the residue stays soft
            # clipped, the alternatives go in XA:Z:
            record.tags.append(xa_tag(amb_result[i]))
        if not record.flag & 4:
            record.tags.append(f"NH:i:{max(1, nh)}")
            record.tags.append("HI:i:1")
            if remapper is not None:
                # transcript remap and velocity tags (XX/XY)
                remap_mod.tag_record(remapper, db, record)
        if show_method:
            record.tags.append(f"YM:Z:{method}")
        count(method)
        out.append(record)

    mark0 = len(out)
    native = []                 # the bulk-emitted rows' methods
    for i in rows_iter:
        rec = chunk[i]
        row_marks.append(len(out))
        if bulk is not None and bulk_lines[i] is not None:
            m = bulk_methods[i]
            native.append(m)
            out.append(sam_bulk.RawSamRecord(
                bulk_lines[i], int(bulk_flags[i]),
                0 if m == "unmapped" else int(mapq[i])))
            continue
        li = int(batch["lengths"][i])
        max_equiv = int(li * config.max_mismatch_frac)
        if i in tr_records:
            _emit(tr_records[i], "tr")
            continue
        if i in splice_result:
            s = splice_result[i]
            alen = s["q_end"] - s["q_start"]
            if (s["nmm"] <= max(1, int(alen * config.max_mismatch_frac))
                    and alen >= max(20, int(li * config.min_coverage))):
                _emit(sam.path_record(
                    db, rec.accession, rec.sequence, rec.quality,
                    s["segs"], s["q_start"], s["q_end"], s["strand"],
                    int(mapq[i]), min_intron=MIN_INTRON, known=known),
                    "splice" if len(s["segs"]) > 1 else "sub")
                continue
        if i in fusion_result and _emit_fusion(
                db, rec, fusion_result[i], li, max_equiv, int(mapq[i]),
                merge_distant_samechr, _emit, out):
            continue
        if i in dp_result:
            pos0, ops, score = dp_result[i]
            if (3 * li - score) // 6 <= max_equiv:
                _emit(sam.gapped_record(
                    db, rec.accession, rec.sequence, rec.quality,
                    pos0, int(res["strand"][i]), int(mapq[i]), ops),
                    "indel")
                continue
        tqs, tqe = 0, li
        if config.soft_clips:
            tqs = int(res["trim_qstart"][i])
            tqe = min(int(res["trim_qend"][i]), li)
        trimmed = tqs > 0 or tqe < li
        alen = tqe - tqs
        trim_ok = (res["diag"][i] != 0xFFFFFFFF and trimmed
                   and alen >= max(20, int(li * config.min_coverage))
                   and int(res["trim_nmm"][i])
                   <= max(1, int(alen * config.max_mismatch_frac)))
        space = spaces[int(res["strand"][i])]
        if res["mapped"][i] and not trimmed:
            _emit(sam.ungapped_record(
                db, rec.accession, rec.sequence, rec.quality,
                int(res["diag"][i]), int(res["strand"][i]),
                int(mapq[i]), int(res["nmismatch"][i]), space=space,
                snp=config.snp_tolerant), "sub",
                nh=int(res["n_best"][i]))
            if npaths > 1 and i in sec_map:
                out[-1].secondaries = _secondaries(
                    db, rec, res, i, sec_map[i], int(mapq[i]), npaths,
                    spaces)
        elif trim_ok:
            _emit(sam.ungapped_record(
                db, rec.accession, rec.sequence, rec.quality,
                int(res["diag"][i]), int(res["strand"][i]),
                int(mapq[i]), int(res["trim_nmm"][i]), space=space,
                snp=config.snp_tolerant, q_start=tqs, q_end=tqe), "sub",
                nh=int(res["n_best"][i]))
        else:
            _emit(sam.unmapped_record(rec.accession, rec.sequence,
                                      rec.quality), "unmapped")
    if counting_on():
        count("rows_native", len(native))
        count("rows_python", len(rows_iter) - len(native))
        _count_methods(native)

    if sink is not None:
        if mix is not None:
            # splice the Python rows' lines into the native blob at
            # their row offsets (input order preserved)
            row_marks.append(len(out))
            buf, off = blob.buf, blob.off
            pos = 0
            for k, i in enumerate(rows_py):
                a = int(off[i])
                if a > pos:
                    sink(buf[pos:a])
                for r in out[row_marks[k]:row_marks[k + 1]]:
                    sink(r.lines().encode())
                pos = int(off[i + 1])
            if pos < len(buf):
                sink(buf[pos:])
        else:
            for r in out[mark0:]:
                sink(r.lines().encode())
        del out[mark0:]


def _emit_fusion(db, rec, f, li, max_equiv, mapq, merge_distant_samechr,
                 emit, out) -> bool:
    """A fusion row's records (tpumap driver.py:1680-1720): an inverted
    join's two records, a colinear same-chromosome distant join as one
    spliced line under merge_distant_samechr (src/gsnap.c:666), else the
    primary and supplementary records; False where the join's score
    misses the mismatch limit (the row falls through)."""
    if (3 * li - f["score"]) // 6 > max_equiv + 4:
        return False
    if f.get("inv"):
        recs = sam.fusion_records_inverted(
            db, rec.accession, rec.sequence, rec.quality, f["d_fwd"],
            f["d_rc"], f["qstar"], f["fwd_first"], mapq)
    elif (merge_distant_samechr and f["dB"] > f["dA"]
            and db.chrnum(f["dA"]) == db.chrnum(f["dB"] + f["qstar"])):
        emit(sam.spliced_record(db, rec.accession, rec.sequence,
                                rec.quality, f["dA"], f["dB"], f["qstar"],
                                li, f["strand"], mapq, 0), "fusion")
        return True
    else:
        recs = sam.fusion_records(db, rec.accession, rec.sequence,
                                  rec.quality, f["dA"], f["dB"], f["qstar"],
                                  f["strand"], mapq)
    emit(recs[0], "fusion")
    out.extend(recs[1:])
    return True


def _tr_rung(db, tr, chunk, batch, config):
    """The transcriptome rung (tpumap driver.py:1807-1844): the chunk's
    reads through the cascade (K1) on the transcript db's device index,
    each read solved on a transcript converted to a genome-coordinate
    multi-exon record from the exon table. Returns {row: SamRecord}."""
    transcriptome, tr_index = tr
    dev = tr_index.device
    res = ladder.fetch_result(ladder.narrow_result(align_batch_cascaded(
        tr_index, {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(dev)
                   for k in ("codes", "nmask", "lengths")}, config)))
    mapq = mapq_from_scores(res["nmismatch"], res["second_nmismatch"],
                            res["n_best"], batch["lengths"])
    trdb = transcriptome.trdb
    out = {}
    for i, rec in enumerate(chunk):
        li = int(batch["lengths"][i])
        if not res["mapped"][i]:
            continue
        if int(res["nmismatch"][i]) > int(li * config.max_mismatch_frac):
            continue
        diag = int(res["diag"][i])
        st = int(res["strand"][i])
        trnum = trdb.chrnum(diag)
        tpos = diag - int(trdb.chrom_offsets[trnum])
        trlen = int(trdb.chrom_offsets[trnum + 1] - trdb.chrom_offsets[trnum])
        if tpos + li > trlen:
            continue            # overhangs the transcript end
        segs, minus = transcriptome.map_to_genome(trnum, tpos, li)
        genome_strand = st ^ (1 if minus else 0)
        sense = -1 if minus else 1
        out[i] = sam.multi_exon_record(
            db, rec.accession, rec.sequence, rec.quality, segs,
            genome_strand, int(mapq[i]), sense if len(segs) > 1 else 0,
            extra_tags=[f"XG:Z:{transcriptome.labels[trnum]}"])
    return out


def _secondaries(db, rec, res, i, sec, mapq: int, npaths: int, spaces):
    """Secondary alignments (gsnap -n): further co-optimal candidates,
    flagged 0x100, attached to the primary record; None if there are
    none. spaces: the mode's (plus, minus) base spaces; as in tpumap,
    secondaries get the space and no SNP tags."""
    sd, ss, sn = sec
    seen = {(int(res["diag"][i]), int(res["strand"][i]))}
    secs = []
    for cix in range(len(sd)):
        if len(seen) >= npaths:
            break
        dg, st, nm = int(sd[cix]), int(ss[cix]), int(sn[cix])
        if dg == 0xFFFFFFFF or (dg, st) in seen or nm > res["nmismatch"][i]:
            continue
        seen.add((dg, st))
        s = sam.ungapped_record(db, rec.accession, rec.sequence,
                                rec.quality, dg, st, mapq, nm,
                                space=spaces[st])
        s.flag |= 0x100
        s.tags.append(f"NH:i:{max(1, int(res['n_best'][i]))}")
        s.tags.append(f"HI:i:{len(secs) + 2}")
        secs.append(s)
    return secs or None


def align_records_isolated(db, index, records, config=AlignConfig(),
                           batch_size: int = 1024, **kw):
    """Failure isolation (SURVEY §5 / the reference's signal handler that
    prints the problem read, src/gmap.c:4651-4708): align in batch_size
    groups; a group that raises is quarantined and re-run one read at a
    time, so a single poison read costs one batch retry instead of the
    whole run, and its accession is reported on stderr. Reads that still
    fail are emitted as unmapped records.

    With sink=..., each group's streamed bytes are buffered locally and
    flushed only when the group succeeds, so a quarantine retry never
    duplicates partial output."""
    sink = kw.pop("sink", None)

    def run(grp):
        if sink is None:
            return align_records(db, index, grp, config,
                                 batch_size=batch_size, **kw)
        chunks = []
        align_records(db, index, grp, config, batch_size=batch_size,
                      sink=chunks.append, **kw)
        for c in chunks:
            sink(c)
        return []

    out = []
    for i in range(0, len(records), batch_size):
        grp = records[i:i + batch_size]
        try:
            out.extend(run(grp))
            continue
        except KeyboardInterrupt:
            raise
        except Exception as exc:
            sys.stderr.write(f"warning: batch starting at read {i} failed "
                             f"({type(exc).__name__}: {exc}); retrying "
                             f"reads individually\n")
        for rec in grp:
            try:
                out.extend(run([rec]))
            except KeyboardInterrupt:
                raise
            except Exception as exc:
                sys.stderr.write(f"error: read {rec.accession} failed "
                                 f"({type(exc).__name__}: {exc}); "
                                 f"reported as unmapped\n")
                unm = sam.unmapped_record(rec.accession, rec.sequence,
                                          rec.quality)
                if sink is not None:
                    sink(unm.lines().encode())
                else:
                    out.append(unm)
    return out
