"""Index-sharded, data-parallel alignment over a (data, index) device grid
(port of tpumap/parallel/sharded.py).

For genomes whose k-mer positions exceed one device's memory, positions
are sharded by oligo range along the `index` axis. Each device seeds its
data shard's reads against its local oligo range; the candidate
diagonals of all index shards are then gathered (tpumap's all_gather
over `index`, here tensor moves to the data row's first device and a
concatenation in tpumap's index-shard-major order, which
prevalent_diagonals' tie order depends on) and verified (K1) against the
replicated genome. The full variant runs the trim stage and the whole
refinement ladder (ladder.refine_full: chain DP, salvage, indels,
splice-end review, and with paired=True the concordance reduction) on
each data shard, with tpumap's per-shard compaction sizes, and
globalises the compacted-row indices by the shard's row offset.

Shards that share a device run on it in turn; results come back
concatenated along the batch on the grid's first device.
"""
from __future__ import annotations

import numpy as np
import torch

from tpumap_torch.gsnap import ladder
from tpumap_torch.gsnap.engine import (AlignConfig, _rc_rows, _strand_cols,
                                       _trim_stage, select_best)
from tpumap_torch.index.build import GenomeDB
from tpumap_torch.index.device import DeviceIndex
from tpumap_torch.ops import pack, pathdp, seed, verify
from tpumap_torch.parallel.mesh import (INDEX_AXIS, DeviceMesh,
                                        batch_sharding, replicated)
from tpumap_torch.parallel.pipeline import _device_scope

# scalar diagnostics of refine_full that have no rows to concatenate
_SCALARS = ("indel_tb_overflow", "stage2_overflow", "amb_row_overflow",
            "amb_task_overflow", "sec_overflow")
# compacted-row indices local to a data shard
_ROW_KEYS = ("ch_idx", "in_idx", "amb_idx", "sec_idx")


def shard_index_host(db: GenomeDB, n_shards: int) -> dict:
    """Split the k-mer index into n_shards contiguous oligo ranges.

    Returns host arrays with a leading shard dimension:
      offsets   uint32[n_shards, 4^k//n_shards + 1]  (rebased per shard)
      positions uint32[n_shards, Pmax]               (INVALID padded)
    """
    noligos = 4 ** db.k
    if noligos % n_shards:
        raise ValueError("4^k must divide by n_shards")
    span = noligos // n_shards
    offs, poss = [], []
    pmax = 0
    for s in range(n_shards):
        lo, hi = s * span, (s + 1) * span
        o = db.offsets[lo:hi + 1].astype(np.int64)
        p = db.positions[o[0]:o[-1]]
        offs.append((o - o[0]).astype(np.uint32))
        poss.append(p)
        pmax = max(pmax, len(p))
    pmax += 64  # gather overrun pad
    positions = np.full((n_shards, pmax), 0xFFFFFFFF, dtype=np.uint32)
    for s, p in enumerate(poss):
        positions[s, :len(p)] = p
    return {
        "offsets": np.stack(offs),
        "positions": positions,
        "span": span,
    }


def _per_device(a: np.ndarray, mesh: DeviceMesh, devices) -> dict:
    """One copy of a uint32 array per distinct device, as its int32 bit
    pattern (the device dtype): {device: tensor}."""
    return replicated(mesh, np.ascontiguousarray(a, np.uint32).view(
        np.int32), devices)


def _place_shards(mesh: DeviceMesh, parts: dict, names) -> dict:
    """Index shard j of each named [n_shards, ...] array on the devices
    of grid column j: name -> [ {device: tensor} per shard ]."""
    for off in parts.get("offsets", ()):
        if off.size and int(off[-1]) >= 2 ** 31:
            raise ValueError("offsets exceed the int32 range")
    return {name: [_per_device(parts[name][j], mesh, mesh.column(j))
                   for j in range(mesh.shape[INDEX_AXIS])]
            for name in names}


def _shard_arrays(mesh: DeviceMesh, db: GenomeDB, pad_words: int):
    """Device arrays shared by both sharded builders: the genome on every
    device, the oligo-range shards of offsets/positions on their
    columns."""
    parts = shard_index_host(db, mesh.shape[INDEX_AXIS])
    arrays = _place_shards(mesh, parts, ("offsets", "positions"))
    arrays["genome_packed"] = _per_device(
        np.concatenate([db.genome_packed, np.zeros(pad_words, np.uint32)]),
        mesh, mesh.devices)
    arrays["genome_nmask"] = _per_device(
        np.concatenate([db.genome_nmask,
                        np.full(pad_words, 0xFFFFFFFF, np.uint32)]),
        mesh, mesh.devices)
    return arrays, parts["span"]


def _local_index(arrays, device, k: int, genome_has_n: bool = True,
                 **fields) -> DeviceIndex:
    """The verify/refine view of the replicated genome on one device (no
    alternate genome, like tpumap's LocalIndex); fields (offsets,
    positions, chrom_offsets, genome_length, interval) where a caller
    reads them."""
    def stub(dtype):
        return torch.zeros(1, dtype=dtype, device=device)
    fields = {"offsets": stub(torch.int32), "positions": stub(torch.int32),
              "chrom_offsets": stub(torch.int64), "genome_length": 0,
              **fields}
    return DeviceIndex(genome_packed=arrays["genome_packed"][device],
                       genome_nmask=arrays["genome_nmask"][device], k=k,
                       genome_has_n=genome_has_n, **fields)


def _strand_candidates(li, arrays, row_devs, k, span, config, c, m,
                       lengths):
    """One strand's candidates behind the oligo sharding: each index
    shard seeds its local range on its device, the shards' lanes are
    concatenated shard-major per read on the row's first device, ranked
    by k-mer support and verified (K1) against the genome."""
    dev0 = row_devs[0]
    oligos, valid = seed.query_oligos(c, m, lengths, k)
    B, NQ = oligos.shape
    local = []
    for j, d in enumerate(row_devs):
        lo = j * span
        o, v = oligos.to(d), valid.to(d)
        in_range = (o >= lo) & (o < lo + span)
        with _device_scope(d):
            diags = seed.lookup_diagonals(
                arrays["offsets"][j][d], arrays["positions"][j][d],
                torch.where(in_range, o - lo, 0), v & in_range,
                torch.arange(NQ, dtype=torch.int64, device=d),
                config.max_occ)
        local.append(diags.reshape(B, -1).to(dev0))
    # all_gather over `index` then transpose(1, 0, 2).reshape(B, -1):
    # per read, index shard 0's lanes first
    diags, _ = seed.prevalent_diagonals(torch.cat(local, dim=1),
                                        config.top_k)
    nmm = verify.verify_diagonals(li, pack.pack_reads(c),
                                  pack.pack_reads(m.to(torch.uint8)),
                                  lengths, diags)
    return diags, nmm


def _cascade_result(li, arrays, row_devs, k, span, config, codes, nmask,
                    lengths):
    """Both-strand sharded cascade -> select_best dict."""
    rc_codes, rc_nmask = _rc_rows(codes, nmask, lengths)
    fdiags, fnmm = _strand_candidates(li, arrays, row_devs, k, span, config,
                                      codes, nmask, lengths)
    rdiags, rnmm = _strand_candidates(li, arrays, row_devs, k, span, config,
                                      rc_codes, rc_nmask, lengths)
    B, K = fdiags.shape
    return select_best(torch.cat([fdiags, rdiags], 1),
                       torch.cat([fnmm, rnmm], 1),
                       _strand_cols(B, K, codes.device), lengths, config)


def _run_data_shards(mesh: DeviceMesh, batch: dict, body) -> dict:
    """body(i, row devices, shard batch on the row's first device) per
    data shard; the dicts concatenated on the grid's first device."""
    parts = []
    for i, shard in enumerate(batch_sharding(mesh, batch)):
        row_devs = list(mesh.grid[i])
        with _device_scope(row_devs[0]):
            parts.append(body(i, row_devs, shard))
    dev = mesh.grid[0][0]
    return {key: torch.cat([p[key].to(dev) for p in parts])
            for key in parts[0]}


def _batch(batch: dict) -> dict:
    return {"codes": torch.as_tensor(batch["codes"]),
            "nmask": torch.as_tensor(batch["nmask"]).to(torch.bool),
            "lengths": torch.as_tensor(batch["lengths"]).to(torch.int32)}


def make_sharded_aligner(mesh: DeviceMesh, db: GenomeDB,
                         config: AlignConfig, pad_words: int = 64):
    """(device_arrays, fn(device_arrays, batch) -> results).

    device_arrays: the genome on every device of the grid, the k-mer
    offsets/positions shards on their index columns. batch: codes,
    nmask and lengths (numpy or tensors) whose rows divide the data axis.
    Results: select_best's dict, rows in batch order, on the grid's
    first device."""
    arrays, span = _shard_arrays(mesh, db, pad_words)
    k = db.k

    def align(arrays, batch):
        def body(i, row_devs, b):
            li = _local_index(arrays, row_devs[0], k)
            return _cascade_result(li, arrays, row_devs, k, span, config,
                                   b["codes"], b["nmask"], b["lengths"])
        return _run_data_shards(mesh, _batch(batch), body)

    return arrays, align


def make_sharded_full_aligner(mesh: DeviceMesh, db: GenomeDB,
                              config: AlignConfig, scoring=None,
                              splicing: bool = True, salvage: bool = False,
                              r_chain: int = 256, r_salv: int = 64,
                              r_indel: int = 64, paired: bool = False,
                              pairmax: int = 2000, orientation: str = "FR",
                              pairexpect: int = 1000, pairdev: int = 100,
                              pad_words: int = 4352):
    """Full-capability sharded-index aligner: cascade seeding per oligo
    shard and the gather of candidate diagonals, then the trim stage and
    the refinement ladder (ladder.refine_full; and with paired the
    concordance reduction over interleaved mates) locally on each data
    shard against the replicated genome.

    Returns (device_arrays, fn(device_arrays, batch) -> the
    align_batch_full / align_pair_full dict without its scalar
    diagnostics, compacted-row indices as batch rows)."""
    if scoring is None:
        scoring = pathdp.PathScoring()
    arrays, span = _shard_arrays(mesh, db, pad_words)
    k = db.k
    chrom_offsets = torch.from_numpy(
        np.asarray(db.chrom_offsets, np.uint32).astype(np.int64))
    genome_length = int(db.genome_length)
    has_n = bool(np.any(db.genome_nmask))
    interval = int(getattr(db, "interval", 3))

    def align(arrays, batch):
        def body(i, row_devs, b):
            d0 = row_devs[0]
            li = _local_index(
                arrays, d0, k, has_n, offsets=arrays["offsets"][0][d0],
                positions=arrays["positions"][0][d0],
                chrom_offsets=chrom_offsets.to(d0),
                genome_length=genome_length, interval=interval)
            codes, nmask, lengths = b["codes"], b["nmask"], b["lengths"]
            B, L = codes.shape
            res = _cascade_result(li, arrays, row_devs, k, span, config,
                                  codes, nmask, lengths)
            if config.soft_clips:
                res.update(_trim_stage(li, codes, nmask, lengths, res,
                                       config))
            pbatch = {"packed": pack.pack_reads(codes),
                      "pnmask": pack.pack_reads(nmask.to(torch.uint8)),
                      "lengths": lengths}
            out = ladder.refine_full(
                li, pbatch, res, config, L, scoring, splicing, salvage,
                min(r_chain, B), min(r_salv, B), min(r_indel, B),
                keep_cands=paired)
            # the compacted rows are local to this data shard: as batch
            # rows after the concatenation
            for key in _ROW_KEYS:
                if key in out:
                    out[key] = out[key] + i * B
            for key in _SCALARS:
                out.pop(key, None)
            if paired:
                cd, cs, cn = (out.pop("cand_diags"), out.pop("cand_strands"),
                              out.pop("cand_nmm"))
                ci, cj, valid, insert = ladder.concordance_device(
                    cd[0::2], cs[0::2], cn[0::2], lengths[0::2],
                    cd[1::2], cs[1::2], cn[1::2], lengths[1::2],
                    pairmax, orientation, pairexpect, pairdev)
                out.update(pe_ci=ci, pe_cj=cj, pe_valid=valid,
                           pe_insert=insert)
                for key, arr, ix in (("pe_cd1", cd[0::2], ci),
                                     ("pe_cs1", cs[0::2], ci),
                                     ("pe_cn1", cn[0::2], ci),
                                     ("pe_cd2", cd[1::2], cj),
                                     ("pe_cs2", cs[1::2], cj),
                                     ("pe_cn2", cn[1::2], cj)):
                    out[key] = torch.gather(arr, 1,
                                            ix[:, None].to(torch.int64))[:, 0]
            return out
        return _run_data_shards(mesh, _batch(batch), body)

    return arrays, align
