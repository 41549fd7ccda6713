"""Batched GSNAP cascade (port of tpumap/gsnap/engine.py).

The whole [B] read batch flows through seed -> verify -> select under
masks: the ends rung (end k-mers, 8 deduplicated lanes, a 16-base probe
keeping 3: kernel K8, csrc/ends.cu; then full verify, K1) for every
read, then the prevalent-diagonal rung on a fixed-size top-k compaction
of the unsolved rows, then end trimming (kernel K4, csrc/trim.cu).
`end_lanes_plain` and `trim_stage_plain` beside their wrappers are the
plain versions, which run for CPU tensors.
The alignment modes (cmet, atoi, ttoc) seed and verify each strand in
its reduced base space (ops/mode.py) and take the ends rung without the
probe; SNP tolerance seeds from the SNP index and verifies ref-OR-alt.
Row compactions are fixed-size top-k, so one batch is one asynchronous
chain of launches with no host synchronisation.

Diagonals are int64 (INVALID = 0xFFFFFFFF); packed words int32 bit
patterns; counts and strands int32, as in tpumap.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpumap_torch import kernels
from tpumap_torch.gsnap.knownsplicing import coords_in_set
from tpumap_torch.index.device import SAFE_PAD_WORDS
from tpumap_torch.ops import dp, pack, pathdp, seed, verify
from tpumap_torch.ops.mode import (CODE_MAPS, MODE_SPACES, SPACE_CODES,
                                   map_codes)
from tpumap_torch.ops.u32 import INVALID, MASK32, popcount32, stable_topk, u32
from tpumap_torch.utils.trace import span, traced

ENDS_K = 8          # unique candidate lanes kept per strand in the ends rung
ENDS_VERIFY_K = 3   # lanes fully verified after the probe prefilter
CAND_K = 8          # ranked candidate list width of every rung


@dataclass(frozen=True)
class AlignConfig:
    max_occ: int = 32          # per-oligo occurrence cap (overabundance)
    top_k: int = 8             # candidate diagonals per strand
    qinterval: int = 1         # query oligo stride of the prevalent rung
    # standard | cmet-stranded | atoi-stranded | ttoc-stranded
    mode: str = "standard"
    # seed from the SNP index, count a base matching ref or alt as a match
    snp_tolerant: bool = False
    max_mismatch_frac: float = 0.10   # unaligned if worse
    # N semantics: True = N counts as a mismatch, False = N matches
    query_unk_mismatch: bool = False
    genome_unk_mismatch: bool = True
    soft_clips: bool = True
    min_coverage: float = 0.25


def _i32(x) -> torch.Tensor:
    return x.to(torch.int32)


def _strand_cols(B: int, K: int, device) -> torch.Tensor:
    return torch.cat([torch.zeros((B, K), dtype=torch.int32, device=device),
                      torch.ones((B, K), dtype=torch.int32, device=device)],
                     dim=1)


def _rc_rows(codes, nmask, lengths):
    """Reverse-complemented codes and reversed N flags (through the same
    gather: N -> 0 -> revcomp 3)."""
    rc_nmask = pack.revcomp_codes(
        torch.where(nmask, 0, 3).to(torch.uint8), lengths) == 3
    return pack.revcomp_codes(codes, lengths), rc_nmask


def align_batch(index, batch, config: AlignConfig):
    """The prevalent-diagonal rung: per-position seeds, both strands,
    verify of the top_k diagonals per strand, select_best."""
    codes, nmask, lengths = batch["codes"], batch["nmask"], batch["lengths"]
    B = codes.shape[0]
    rc_codes, rc_nmask = _rc_rows(codes, nmask, lengths)
    space_fwd, space_rc = MODE_SPACES[config.mode]
    snp = config.snp_tolerant

    def one_strand(c, m, space):
        diags, _counts = seed.seed_reads(
            index, c, m, lengths, max_occ=config.max_occ,
            top_k=config.top_k, qinterval=config.qinterval, space=space,
            index_space="snp" if snp else None)
        nmm = verify.verify_diagonals(
            index, pack.pack_reads(c), pack.pack_reads(m.to(torch.uint8)),
            lengths, diags, config.query_unk_mismatch,
            config.genome_unk_mismatch, space=space, snp=snp)
        return diags, nmm

    fdiags, fnmm = one_strand(codes, nmask, space_fwd)
    rdiags, rnmm = one_strand(rc_codes, rc_nmask, space_rc)
    return select_best(torch.cat([fdiags, rdiags], 1),
                       torch.cat([fnmm, rnmm], 1),
                       _strand_cols(B, fdiags.shape[1], codes.device),
                       lengths, config)


def select_best(all_diags, all_nmm, strands, lengths, config: AlignConfig):
    """Rank candidates by mismatch count; best hit + MAPQ inputs."""
    B, K2 = all_diags.shape
    lane = torch.arange(K2, dtype=torch.int32, device=all_diags.device)
    order = torch.argsort(all_nmm * (2 ** 16) + lane, dim=1)
    nmm_sorted = torch.gather(all_nmm, 1, order)
    diag_sorted = torch.gather(all_diags, 1, order)
    strand_sorted = torch.gather(strands, 1, order)
    best_nmm = nmm_sorted[:, 0]
    best_diag = diag_sorted[:, 0]
    best_strand = strand_sorted[:, 0]
    is_best = nmm_sorted == best_nmm[:, None]
    dup = ((diag_sorted == best_diag[:, None])
           & (strand_sorted == best_strand[:, None]))
    n_best = _i32((is_best & ~dup).sum(dim=1) + 1)
    second_nmm = torch.where(dup, 2 ** 15, nmm_sorted).min(dim=1).values
    max_nmm = _i32(lengths.to(torch.float32) * config.max_mismatch_frac)
    mapped = (best_diag != INVALID) & (best_nmm <= max_nmm)
    return {
        "diag": best_diag,
        "strand": best_strand,
        "nmismatch": best_nmm,
        "second_nmismatch": second_nmm,
        "n_best": n_best,
        "mapped": mapped,
        "cand_diags": _pad_to(diag_sorted, CAND_K, INVALID),
        "cand_strands": _pad_to(strand_sorted, CAND_K, 0),
        "cand_nmm": _pad_to(nmm_sorted, CAND_K, 2 ** 15),
    }


def _pad_to(arr: torch.Tensor, k: int, fill) -> torch.Tensor:
    B, n = arr.shape
    if n >= k:
        return arr[:, :k]
    return torch.cat([arr, torch.full((B, k - n), fill, dtype=arr.dtype,
                                      device=arr.device)], dim=1)


def _ends_iv(index) -> int:
    """End-oligo group size: one probe per sampled offset class."""
    return max(1, int(getattr(index, "interval", 3)))


def _end_qpos(index, lengths):
    k = index.k
    iv = _ends_iv(index)
    qlast = torch.clamp(lengths - k, min=0)
    return ([torch.clamp(qlast, max=j) for j in range(iv)]
            + [torch.clamp(qlast - j, min=0) for j in range(iv - 1, -1, -1)])


def _end_diags(offsets, positions, oligos, qpos, occ: int, ok_rows):
    """Up to occ positions of each end oligo int64[B, NE] (table
    offsets/positions) as diagonals at qpos, flattened to [B, NE * occ];
    INVALID where the oligo is overabundant, the lane empty, the row not
    ok_rows [B, 1, 1] or the diagonal before the genome start."""
    B, NE = oligos.shape
    lane = torch.arange(occ, dtype=torch.int64,
                        device=oligos.device)[None, None, :]
    start = seed._take_clip(offsets, oligos)
    count = seed._take_clip(offsets, oligos + 1) - start
    pos = seed._take_clip(positions, start[..., None] + lane)
    ok = (lane < count[..., None]) & (count <= occ)[..., None] & ok_rows
    qp = qpos[..., None]
    bad = ~ok | (pos < qp)
    return torch.where(bad, INVALID, pos - qp).reshape(B, NE * occ)


def align_batch_ends(index, batch, config: AlignConfig):
    """The ends rung: candidates from the end k-mers only, both strands.
    Standard mode takes the gather-free _ends_standard; the modes take
    _ends_mode. Both take their lanes from end_lanes (K8)."""
    codes, nmask, lengths = batch["codes"], batch["nmask"], batch["lengths"]
    if MODE_SPACES[config.mode] == (None, None):
        return _ends_standard(index, codes, nmask, lengths, config)
    return _ends_mode(index, codes, nmask, lengths, config)


def _ends_mode(index, codes, nmask, lengths, config: AlignConfig):
    """The ends rung of the alignment modes (engine.py:183-258): each
    strand's ENDS_K lanes from end_lanes, all verified with no probe, one
    verify per strand in its space."""
    B = codes.shape[0]
    space_fwd, space_rc = MODE_SPACES[config.mode]
    rc_codes, rc_nmask = _rc_rows(codes, nmask, lengths)
    fcands, rcands = end_lanes(index, codes, lengths, config)

    def strand_nmm(c, m, cands, space):
        return verify.verify_diagonals(
            index, pack.pack_reads(c), pack.pack_reads(m.to(torch.uint8)),
            lengths, cands, config.query_unk_mismatch,
            config.genome_unk_mismatch, space=space,
            snp=config.snp_tolerant)

    fnmm = strand_nmm(codes, nmask, fcands, space_fwd)
    rnmm = strand_nmm(rc_codes, rc_nmask, rcands, space_rc)
    return select_best(torch.cat([fcands, rcands], 1),
                       torch.cat([fnmm, rnmm], 1),
                       _strand_cols(B, fcands.shape[1], codes.device),
                       lengths, config)


def _ends_standard(index, codes, nmask, lengths, config: AlignConfig):
    """Standard-mode ends rung: the probe-ranked lanes of both strands
    from end_lanes, one verify of the reads and their reverse complements
    (with SNP tolerance ref-OR-alt)."""
    B = codes.shape[0]
    packed = pack.pack_reads(codes)
    nmask2 = pack.pack_reads(nmask.to(torch.uint8))
    packed2 = torch.cat([packed, pack.revcomp_packed(packed, lengths)], 0)
    nmask22 = torch.cat(
        [nmask2, pack.revcomp_packed(nmask2, lengths, complement=False)], 0)
    lengths2 = torch.cat([lengths, lengths], 0)
    cands2 = end_lanes(index, codes, lengths, config, packed2)  # [2B, K]
    stacked = verify.verify_diagonals(
        index, packed2, nmask22, lengths2, cands2,
        config.query_unk_mismatch, config.genome_unk_mismatch,
        snp=config.snp_tolerant)
    K = cands2.shape[1]
    return select_best(torch.cat([cands2[:B], cands2[B:]], 1),
                       torch.cat([stacked[:B], stacked[B:]], 1),
                       _strand_cols(B, K, codes.device), lengths, config)


def _end_tables(index, config: AlignConfig):
    """The (offsets, positions) each strand seeds from: the SNP index with
    SNP tolerance whatever the space, else the strand's space's table."""
    return tuple(index.mode_index("snp" if config.snp_tolerant else space)
                 for space in MODE_SPACES[config.mode])


def end_kmers(index, codes, lengths, config: AlignConfig):
    """Each strand's ((offsets, positions), k-mers int64[B, NE], their
    read positions int64[B, NE]), as end_lanes_plain looks them up.
    Standard mode rolls the k-mers over the whole read and takes the rc
    strand's by arithmetic; a mode rolls each strand's from its
    space-mapped codes (the rc strand's from the reverse-complemented
    read)."""
    B, L = codes.shape
    k = index.k
    dev = codes.device
    qpos = torch.stack(_end_qpos(index, lengths), dim=1).to(torch.int64)
    tables = _end_tables(index, config)
    space_fwd, space_rc = MODE_SPACES[config.mode]
    if space_fwd is None and space_rc is None:
        # rolling k-mers over the whole read, then one take at the ends
        acc = torch.zeros((B, L), dtype=torch.int64, device=dev)
        for j in range(k):
            acc = ((acc << 2) & MASK32) | torch.roll(codes, -j, dims=1).to(
                torch.int64)
        fwd = torch.gather(acc, 1, qpos)
        # the rc oligo at rc-position (len - k - q) is the revcomp of the
        # fwd oligo at q
        rc_q = torch.clamp(lengths.to(torch.int64)[:, None] - k - qpos,
                           min=0)
        return [(tables[0], fwd, qpos),
                (tables[1], pack.revcomp_kmer(fwd, k), rc_q)]

    def rolled(c, space):
        c = map_codes(c, space).to(torch.int64)
        o = torch.zeros(qpos.shape, dtype=torch.int64, device=dev)
        for j in range(k):
            o = ((o << 2) & MASK32) | torch.gather(
                c, 1, torch.clamp(qpos + j, max=L - 1))
        return o

    rc_codes = pack.revcomp_codes(codes, lengths)
    return [(tables[0], rolled(codes, space_fwd), qpos),
            (tables[1], rolled(rc_codes, space_rc), qpos)]


def end_lanes_plain(index, codes, lengths, config: AlignConfig,
                    packed2=None):
    """K8's plain version. Each strand's end k-mers (end_kmers of codes
    uint8[B, L]), their table positions as diagonals (_end_diags) and
    the ENDS_K smallest distinct of those (_dedup_lanes). Standard mode
    then ranks both strands' lanes by the probe word of packed2 (the
    reads and their reverse complements, int32[2B, W]) and keeps
    ENDS_VERIFY_K: int64[2B, <= 3]; a mode returns int64[2, B, <= 8]."""
    long_enough = (lengths >= index.k)[:, None, None]
    lanes = [_dedup_lanes(_end_diags(*table, oligos, q, config.max_occ,
                                     long_enough), ENDS_K)
             for table, oligos, q in end_kmers(index, codes, lengths,
                                               config)]
    if MODE_SPACES[config.mode] != (None, None):
        return torch.stack(lanes)
    return probe_rank_plain(index, packed2, torch.cat([lengths, lengths], 0),
                            torch.cat(lanes, 0), ENDS_VERIFY_K)


def end_lanes_per(NE: int, occ: int) -> int:
    """K8's lanes a thread a row: 1 or 8 in registers, 0 past 256 lanes
    or 32 end k-mers (the global scratch)."""
    n = NE * occ
    return 1 if NE <= 32 and n <= 32 else 8 if NE <= 32 and n <= 256 else 0


def end_lanes_reads(per: int, B: int, n_sms: int) -> int:
    """K8's reads a warp on its register paths: 2 with one lane a thread
    a row once a read a warp would fill more than a wave (64 warps an
    SM), else 1: a warp's rows share its chain of gathers, but each more
    row lengthens the warp's selection."""
    return 2 if per == 1 and B > 64 * n_sms else 1


def end_lanes(index, codes, lengths, config: AlignConfig, packed2=None):
    """end_lanes_plain for CPU tensors; the K8 kernel for CUDA. K8 builds
    each (read, strand)'s k-mers from the read's end bases (the rc
    strand's from the complement read backwards: the same k-mers and
    positions as the plain version's when len >= k, and no lane when
    len < k), so lanes and tie rules are the plain version's. Its time is
    the latency of three dependent gathers (offsets, positions, probe
    words); a warp serves end_lanes_reads reads, both strands, builds
    their k-mers from one load of their end bases, and issues the probe's
    gathers before the selection."""
    if codes.device.type == "cpu":
        return end_lanes_plain(index, codes, lengths, config, packed2)
    B, L = codes.shape
    dev = codes.device
    NE = 2 * _ends_iv(index)
    occ = max(int(config.max_occ), 0)
    K = min(ENDS_K, NE * occ)
    standard = MODE_SPACES[config.mode] == (None, None)
    keep = min(ENDS_VERIFY_K, K) if standard else 0
    out = torch.empty(((2 * B, keep) if standard else (2, B, K)),
                      dtype=torch.int64, device=dev)
    if out.numel() == 0:
        return out
    codes, lengths = codes.contiguous(), lengths.contiguous()
    if codes.data_ptr() % 4:
        codes = codes.clone()           # K8 reads the codes as 4-byte words
    (off_f, pos_f), (off_r, pos_r) = _end_tables(index, config)
    W = packed2.shape[1] if standard else 0
    kernels.check_args(
        "end_lanes", dev, (codes, torch.uint8, (B, L)),
        (lengths, torch.int32, (B,)), (off_f, torch.int32, None),
        (pos_f, torch.int32, None), (off_r, torch.int32, None),
        (pos_r, torch.int32, None), (index.genome_packed, torch.int32, None),
        *(((packed2, torch.int32, (2 * B, W)),) if standard else ()))
    n = NE * occ
    per = end_lanes_per(NE, occ)
    rp = end_lanes_reads(per, B, kernels.n_sms(dev))
    nslots = -(-min(2 * B, 16 * kernels.n_sms(dev)) // 4) * 4 \
        if per == 0 else 0                  # whole blocks of 4 warps
    scratch = (torch.empty((nslots, n), dtype=torch.int32, device=dev)
               if per == 0 else None)
    space_fwd, space_rc = MODE_SPACES[config.mode]
    kernels.launch(
        "end_lanes", dev, codes, lengths, off_f, off_f.shape[0], pos_f,
        pos_f.shape[0], off_r, off_r.shape[0], pos_r, pos_r.shape[0],
        index.genome_packed, index.genome_packed.shape[0],
        packed2 if standard else None, W, B, L, index.k, NE // 2, occ, K,
        keep, _code_lut(space_fwd), _code_lut(space_rc), per, rp, scratch,
        nslots, out)
    return out


def _code_lut(space) -> int:
    """CODE_MAPS[space] as 2 bits a code (K8 maps codes through it)."""
    cmap = CODE_MAPS[space] if space is not None else range(4)
    return sum(int(v) << (2 * c) for c, v in enumerate(cmap))


def probe_rank_plain(index, packed2, lengths2, cands2, keep: int):
    """Rank candidate lanes by one mid-read 16-base probe word and keep
    the `keep` best (INVALID lanes rank last, ties to the lower lane)."""
    valid = cands2 != INVALID
    pw = torch.clamp(lengths2.to(torch.int64) // 32, 0, packed2.shape[1] - 1)
    rw = u32(torch.gather(packed2, 1, pw[:, None]))
    starts = (torch.where(valid, cands2, 0) + (pw * 16)[:, None]) & MASK32
    gw = verify.extract_packed_window(index.genome_packed, starts, 1)[..., 0]
    diff = rw ^ gw
    probe_mm = _i32(popcount32((diff | (diff >> 1)) & 0x55555555))
    probe_mm = torch.where(valid, probe_mm, 999)
    _neg, top_idx = stable_topk(-probe_mm, keep)
    return torch.gather(cands2, 1, top_idx)


def _dedup_lanes(cands: torch.Tensor, keep: int) -> torch.Tensor:
    """Sort lanes, drop duplicates, compact uniques to the front, keep
    the first `keep`: the `keep` smallest distinct lanes, INVALID after."""
    s = torch.sort(cands, dim=1).values
    dup = torch.cat([torch.zeros_like(s[:, :1], dtype=torch.bool),
                     s[:, 1:] == s[:, :-1]], dim=1)
    s = torch.sort(torch.where(dup, INVALID, s), dim=1).values
    return s[:, :keep].contiguous()      # K1 takes contiguous diagonals


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    while mask.ndim < like.ndim:
        mask = mask[..., None]
    return mask


def row_map(rows, fn, index, *args):
    """fn(index, *args) for a row-independent fn; with rows (a
    parallel/pipeline.RowSplit) over contiguous row chunks of args, each
    on its data device with that device's index, concatenated back."""
    if rows is None:
        return fn(index, *args)
    return rows.map(fn, *args)


def align_batch_cascaded(index, batch, config: AlignConfig,
                         solved_nmm: int = 3, stage2_rows: int = 512,
                         rows=None):
    """Two-rung cascade: the ends rung for every read, then the
    prevalent rung on the up-to-stage2_rows worst unsolved reads
    (fixed-size top-k), scattered back where it improved. With rows
    each rung and the trim stage run over row chunks (row_map); the
    compaction ranks the whole batch once."""
    codes, nmask, lengths = batch["codes"], batch["nmask"], batch["lengths"]
    B, L = codes.shape
    S = min(stage2_rows, B)
    with span("ends"):
        res = row_map(rows, lambda ix, b: align_batch_ends(ix, b, config),
                      index, {"codes": codes, "nmask": nmask,
                              "lengths": lengths})

    with span("prevalent"):
        unsolved = res["nmismatch"] > solved_nmm
        prio = torch.where(unsolved, res["nmismatch"], -1)
        _, idx = stable_topk(prio, S)
        selected = unsolved[idx]
        sub = {"codes": codes[idx], "nmask": nmask[idx],
               "lengths": lengths[idx]}
        res2 = row_map(rows, lambda ix, b: align_batch(ix, b, config),
                       index, sub)

        better = selected & (res2["nmismatch"] < res["nmismatch"][idx])
        out = {}
        for key in res:
            o = res[key].clone()
            o[idx] = torch.where(_bcast(better, res2[key]), res2[key],
                                 res[key][idx])
            out[key] = o
        # stage-2 rows get the union of both rungs' ranked candidates
        mcd, mcs, mcn = _merge_cand_lists(
            res["cand_diags"][idx], res["cand_strands"][idx],
            res["cand_nmm"][idx],
            res2["cand_diags"], res2["cand_strands"], res2["cand_nmm"])
        sel_b = _bcast(selected, mcd)
        for key, merged in (("cand_diags", mcd), ("cand_strands", mcs),
                            ("cand_nmm", mcn)):
            out[key][idx] = torch.where(sel_b, merged, out[key][idx])
        n_uns = _i32(unsolved.sum())
        out["stage2_overflow"] = torch.clamp(n_uns - _i32(selected.sum()),
                                             min=0)
    if config.soft_clips:
        with span("trim"):
            out.update(row_map(
                rows, lambda ix, c, m, ln, r, q: _trim_stage(
                    ix, c, m, ln, r, config, quals=q),
                index, codes, nmask, lengths,
                {"strand": out["strand"], "diag": out["diag"]},
                batch.get("quals")))
    return out


def trim_stage_plain(index, codes, nmask, lengths, res, config: AlignConfig,
                     quals=None):
    """K4's plain version: end trimming of the best diagonal: per-base
    mismatch mask in the aligned orientation -> max-scoring query
    interval; with quals also the quality-weighted MAPQ inputs
    mm_qualsum and qual_mean16."""
    B, L = codes.shape
    packed = pack.pack_reads(codes)
    nmask2 = pack.pack_reads(nmask.to(torch.uint8))
    is_rc = (res["strand"] == 1)[:, None]
    sel_p = torch.where(is_rc, pack.revcomp_packed(packed, lengths), packed)
    sel_n = torch.where(is_rc, pack.revcomp_packed(nmask2, lengths,
                                                   complement=False), nmask2)
    space_fwd, space_rc = MODE_SPACES[config.mode]

    def mask(space):
        return verify.mismatch_mask_single(
            index, sel_p, sel_n, lengths, res["diag"], L,
            config.query_unk_mismatch, config.genome_unk_mismatch,
            space=space, snp=config.snp_tolerant)

    # the modes: one mask per space, each row's by its strand
    mm = (mask(space_fwd) if space_fwd == space_rc
          else torch.where(is_rc, mask(space_rc), mask(space_fwd)))
    qs, qe, score, nmm_in = pathdp.trim_ends(mm, lengths)
    out = {"trim_qstart": qs, "trim_qend": qe, "trim_score": score,
           "trim_nmm": nmm_in}
    if quals is not None:
        idx = torch.arange(L, dtype=torch.int64, device=codes.device)
        rev = torch.clamp(lengths.to(torch.int64)[:, None] - 1 - idx, 0,
                          L - 1)
        q_or = _i32(torch.where(is_rc, torch.gather(quals, 1, rev), quals))
        kept = (idx >= qs[:, None]) & (idx < qe[:, None])
        out["mm_qualsum"] = _i32(torch.where(mm & kept, q_or, 0).sum(1))
        span = torch.clamp(qe - qs, min=1)
        out["qual_mean16"] = _i32(
            torch.div(16 * torch.where(kept, q_or, 0).sum(1), span,
                      rounding_mode="floor"))
    return out


# K4 serves a row with a segment of up to 32 lanes (one mismatch word a
# lane) up to this many words, past it with a warp; a warp's row keeps
# its words in shared memory up to TRIM_SMEM_WORDS words (4 warps a
# block, 48 KB), past it in a global scratch
TRIM_SEG_WORDS = 32
TRIM_SMEM_WORDS = 3072


def _trim_stage(index, codes, nmask, lengths, res, config: AlignConfig,
                quals=None):
    """trim_stage_plain for CPU tensors; the K4 kernel for CUDA. K4 builds
    each row's mismatch words in its own base space only (the strand's),
    from the codes read forwards or, on the rc strand, complemented
    backwards (only bases < len reach the scans, where both orientations
    are the plain version's). A row's work is short, so its time is the
    latency of two rounds of loads and of its reductions: up to 32 words
    a row has a segment of lanes (W rounded up to a power of two, one word
    a lane in registers, 16-byte loads where L is a multiple of 16), and a
    row with no mismatch ends after one ballot."""
    if codes.device.type == "cpu":
        return trim_stage_plain(index, codes, nmask, lengths, res, config,
                                quals)
    B, L = codes.shape
    dev = codes.device
    W = pack.words_for(L)
    codes, lengths = codes.contiguous(), lengths.contiguous()
    nm = nmask.contiguous().view(torch.uint8)
    strand = res["strand"].contiguous()
    diag = res["diag"].contiguous()
    galt = index.genomealt_packed if config.snp_tolerant else None
    q = None if quals is None else quals.contiguous()
    kernels.check_args(
        "trim_stage", dev, (index.genome_packed, torch.int32, None),
        (index.genome_nmask, torch.int32, None),
        (codes, torch.uint8, (B, L)), (nm, torch.uint8, (B, L)),
        (lengths, torch.int32, (B,)), (strand, torch.int32, (B,)),
        (diag, torch.int64, (B,)),
        *(() if galt is None else ((galt, torch.int32, None),)),
        *(() if q is None else ((q, torch.uint8, (B, L)),)))
    out = torch.empty((4 if q is None else 6, B), dtype=torch.int32,
                      device=dev)
    if B:
        seg = 1 << (W - 1).bit_length() if 0 < W <= TRIM_SEG_WORDS else 0
        vec = int(L % 16 == 0 and all(
            t.data_ptr() % 16 == 0 for t in (codes, nm, q) if t is not None))
        scratch = (torch.empty((B, W), dtype=torch.int32, device=dev)
                   if W > TRIM_SMEM_WORDS else None)
        space_fwd, space_rc = MODE_SPACES[config.mode]
        kernels.launch(
            "trim_stage", dev, index.genome_packed,
            index.genome_packed.shape[0], index.genome_nmask,
            index.genome_nmask.shape[0], galt,
            0 if galt is None else galt.shape[0], codes, nm, lengths,
            strand, diag, q, B, L, W, int(index.genome_has_n),
            int(config.query_unk_mismatch), int(config.genome_unk_mismatch),
            SPACE_CODES[space_fwd], SPACE_CODES[space_rc], SAFE_PAD_WORDS,
            seg, vec, scratch, out)
    keys = ("trim_qstart", "trim_qend", "trim_score", "trim_nmm",
            "mm_qualsum", "qual_mean16")
    return dict(zip(keys, out))


def _merge_cand_lists(cd_a, cs_a, cn_a, cd_b, cs_b, cn_b):
    """Union two ranked candidate lists [R, K] -> best K by nmm, without
    duplicate (strand, diagonal) pairs; INVALID lanes sort last."""
    cd = torch.cat([cd_a, cd_b], 1)
    cs = torch.cat([cs_a, cs_b], 1)
    cn = torch.cat([cn_a, cn_b], 1)
    K2 = cd.shape[1]
    lane = torch.arange(K2, dtype=torch.int32, device=cd.device)
    key = torch.where(cd == INVALID, 2 ** 20, cn)
    order = torch.argsort(key * K2 + lane, dim=1)
    cd = torch.gather(cd, 1, order)
    cs = torch.gather(cs, 1, order)
    cn = torch.gather(cn, 1, order)
    same = ((cd[:, None, :] == cd[:, :, None])
            & (cs[:, None, :] == cs[:, :, None])
            & (lane[None, :] < lane[:, None])[None])
    cd = torch.where(same.any(dim=2), INVALID, cd)
    key2 = torch.where(cd == INVALID, 2 ** 20, cn)
    order2 = torch.argsort(key2 * K2 + lane, dim=1)[:, :cd_a.shape[1]]
    return (torch.gather(cd, 1, order2), torch.gather(cs, 1, order2),
            torch.gather(cn, 1, order2))


def indel_forward(index, codes, lengths, diags, band: int, margin: int = 8):
    """Forward half of the indel refinement: banded DP scores and
    direction matrix around each diagonal, no traceback."""
    B, L = codes.shape
    gstart = torch.clamp(diags, min=margin) - margin
    W = L + band + margin
    gcodes = verify.extract_codes_window(index.genome_packed, gstart, W)
    # (uint32 genome_length - gstart) cast to int32, as tpumap does
    glens = torch.clamp(_i32((index.genome_length - gstart) & MASK32),
                        max=W)
    out = dp.banded_align(codes, _i32(lengths), gcodes, glens, band,
                          mode="glocal")
    out["gstart_off"] = _i32(gstart) - _i32(diags)
    return out


def indel_traceback(fwd, lengths, band: int):
    """Traceback half: transcripts, their runs and genome start offsets
    for the (compacted) rows of an indel_forward result."""
    ops, k_final, run_op, run_len, nruns = dp.traceback(
        fwd["dirs"], _i32(lengths), fwd["end_k"], band)
    return {"score": fwd["score"], "ops": ops,
            "start_off": (k_final - band) + fwd["gstart_off"],
            "run_op": run_op, "run_len": run_len, "nruns": nruns}


def refine_indels(index, codes, lengths, diags, band: int, margin: int = 8):
    """Banded-DP refinement around candidate diagonals (tpumap
    engine.py:585-600): indel_forward (K2), then indel_traceback (K3).
    codes in the aligned orientation, diags int64 (uint32 values). Returns
    score int32[B], ops uint8[B, S] (end-first transcripts) and
    start_off int32[B] (the alignment's genome start less the diagonal),
    with the transcripts' runs beside them."""
    return indel_traceback(indel_forward(index, codes, lengths, diags, band,
                                         margin), lengths, band)


def refine_splices(index, codes, nmask, lengths, diagsA, diagsB,
                   known=None):
    """One-intron junctions for candidate diagonal pairs (tpumap
    engine.py:603-695, Splice_resolve): the prefix on diagonal A, the
    suffix on B, the boundary q* the one of fewest mismatches, canonical
    dinucleotides and (with known, a dict of
    knownsplicing.known_to_device) known sites breaking ties, the first
    best on a tie as jnp.argmax. codes [B, L] aligned; diagsA, diagsB
    int64[B, P] (INVALID-padded). Returns per pair qstar int32, nmm
    int32 (mismatches at q*), bonus float32, sense int32 (+1, -1, 0) and
    bool valid."""
    B, L = codes.shape
    dev = codes.device
    validp = (diagsA != INVALID) & (diagsB != INVALID)
    dA = torch.where(validp, diagsA, 0)
    dB = torch.where(validp, diagsB, 0)
    gA = verify.extract_codes_window(index.genome_packed, dA, L + 1)
    gB = verify.extract_codes_window(index.genome_packed, dB, L + 1)
    q = codes[:, None, :]
    inlen = (torch.arange(L, device=dev)[None, None, :]
             < lengths[:, None, None])
    mmA = ((q != gA[..., :L]) | nmask[:, None, :]) & inlen
    mmB = ((q != gB[..., :L]) | nmask[:, None, :]) & inlen
    # at boundary q*: prefix mismatches on A, suffix ones on B
    prefA = torch.cumsum(mmA, dim=2)
    prefB = torch.cumsum(mmB, dim=2)
    costs = (prefA + (mmB.sum(dim=2, keepdim=True) - prefB))[..., :L - 1]
    costs = costs.to(torch.float32)                 # q* = 1 .. L-1
    qs = torch.arange(1, L, dtype=torch.int64, device=dev)
    don1, don2 = gA[..., 1:L], gA[..., 2:L + 1]
    acc1 = torch.where(qs >= 2, gB[..., torch.clamp(qs - 2, min=0)], 4)
    acc2 = gB[..., 0:L - 1]

    def canon(a, b, c, d):
        return (don1 == a) & (don2 == b) & (acc1 == c) & (acc2 == d)
    s_gtag, s_gcag, s_atac = canon(2, 3, 0, 2), canon(2, 1, 0, 2), \
        canon(0, 3, 0, 1)
    a_ctac, a_ctgc, a_gtat = canon(1, 3, 0, 1), canon(1, 3, 2, 1), \
        canon(2, 3, 0, 3)
    bonus = torch.where(s_gtag | a_ctac, 2.0,
                        torch.where(s_gcag | a_ctgc, 1.2,
                                    torch.where(s_atac | a_gtat, 0.8, 0.0))
                        ).to(torch.float32)
    sense = torch.where(s_gtag | s_gcag | s_atac, 1,
                        torch.where(a_ctac | a_ctgc | a_gtat, -1, 0))
    if known is not None:
        # boundary coordinates at q*: the first intron base on A, the
        # first exon base on B (uint32 arithmetic)
        left = (dA[..., None] + qs) & MASK32
        right = (dB[..., None] + qs) & MASK32
        known_s = (coords_in_set(known["donor"], left)
                   & coords_in_set(known["acceptor"], right))
        known_a = (coords_in_set(known["antiacceptor"], left)
                   & coords_in_set(known["antidonor"], right))
        bonus = torch.where(known_s | known_a, bonus + 4.0, bonus)
        sense = torch.where(known_s, 1, torch.where(known_a, -1, sense))
    in_read = qs < lengths.to(torch.int64)[:, None, None]
    score = torch.where(in_read, bonus - 3.0 * costs, -torch.inf)
    jbest = torch.argmax(score, dim=2)              # the first maximum

    def take(arr):
        return torch.gather(arr, 2, jbest[..., None])[..., 0]
    nmm = torch.where(validp, _i32(take(costs)), lengths[:, None])
    return {"qstar": _i32(jbest + 1), "nmm": nmm, "bonus": take(bonus),
            "sense": _i32(take(sense)), "valid": validp}


@traced("mapq")
def mapq_from_scores(nmm: np.ndarray, second: np.ndarray, n_best: np.ndarray,
                     lengths: np.ndarray, base_qual: float = 30.0,
                     mm_qualsum: np.ndarray | None = None,
                     qual_mean16: np.ndarray | None = None) -> np.ndarray:
    """MAPQ as the posterior error of the best alignment (host numpy,
    a copy of tpumap's): multimappers get 0, the cap is 40."""
    if mm_qualsum is not None and qual_mean16 is not None:
        qbar = qual_mean16.astype(np.float64) / 16.0
        gap = np.clip((second.astype(np.float64) * qbar - mm_qualsum)
                      / base_qual, 0, 12)
    else:
        gap = np.clip(second - nmm, 0, 12).astype(np.float64)
    l2 = 10.0 ** (-(base_qual / 10.0) * gap)
    no_second = second >= 2 ** 15               # sentinel: no runner-up
    others = (np.maximum(n_best - 1, 0).astype(np.float64)
              + np.where(no_second, 0.0, l2))
    p_err = others / (1.0 + others)
    with np.errstate(divide="ignore"):
        mapq = np.where(p_err > 0, -10.0 * np.log10(p_err + 1e-12), 40.0)
    mapq = np.where(n_best > 1, 0.0, mapq)
    return np.clip(mapq, 0, 40).astype(np.int32)


@traced("cascade")
def align_batch_cascaded_packed(index, pbatch, config: AlignConfig, L: int,
                                solved_nmm: int = 3,
                                stage2_rows: int = 512, rows=None):
    """align_batch_cascaded fed by host-packed reads: pbatch holds packed
    int32[B, W], pnmask int32[B, W] (or a (1, 1) stub for N-free
    batches), lengths int32[B] and optionally quals uint8[B, L]."""
    codes = pack.unpack_reads(pbatch["packed"], L)
    if pbatch["pnmask"].shape == pbatch["packed"].shape:
        nmask = pack.unpack_reads(pbatch["pnmask"], L).to(torch.bool)
    else:
        nmask = torch.zeros(codes.shape, dtype=torch.bool,
                            device=codes.device)
    batch = {"codes": codes, "nmask": nmask, "lengths": pbatch["lengths"]}
    if "quals" in pbatch:
        batch["quals"] = pbatch["quals"]
    return align_batch_cascaded(index, batch, config, solved_nmm,
                                stage2_rows, rows)
