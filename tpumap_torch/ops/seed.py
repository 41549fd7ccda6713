"""Seed finding (port of tpumap/ops/seed.py).

Gather the genomic positions of a read's k-mers, turn them into
univdiagonals (genome coordinate of query base 0), and rank diagonals by
k-mer support with a per-row sort and run-length count. Diagonals are
int64 values with INVALID = 0xFFFFFFFF padding, which sorts last.
"""
from __future__ import annotations

import torch

from tpumap_torch.ops.mode import map_codes
from tpumap_torch.ops.u32 import INVALID, MASK32, stable_topk, u32


def query_oligos(codes: torch.Tensor, nmask: torch.Tensor,
                 lengths: torch.Tensor, k: int):
    """[B, L] codes -> (int64[B, L-k+1] oligos, bool valid). The oligo at
    q covers codes[q:q+k], leftmost base in the high bits; oligos over
    the read end or an N are invalid."""
    B, L = codes.shape
    n = L - k + 1
    acc = torch.zeros((B, n), dtype=torch.int64, device=codes.device)
    bad = torch.zeros((B, n), dtype=torch.bool, device=codes.device)
    for j in range(k):
        acc = ((acc << 2) & MASK32) | codes[:, j:j + n].to(torch.int64)
        bad = bad | nmask[:, j:j + n]
    q = torch.arange(n, dtype=torch.int64, device=codes.device)[None, :]
    valid = (q + k <= lengths.to(torch.int64)[:, None]) & ~bad
    return acc, valid


def _take_clip(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """u32(arr[clip(idx)]) — JAX's take(..., mode="clip")."""
    flat = idx.clamp(0, arr.shape[0] - 1).reshape(-1)
    return u32(arr[flat]).reshape(idx.shape)


def lookup_diagonals(offsets, positions, oligos, valid, qpos,
                     max_occ: int, keep_overabundant: bool = False
                     ) -> torch.Tensor:
    """Up to max_occ genomic positions per oligo as univdiagonals
    int64[B, NQ, max_occ]; oligos with more hits are dropped (the
    overabundance cap), or with keep_overabundant keep their first
    max_occ hits (the repetitive-region fallback); INVALID pads."""
    oligos_c = torch.where(valid, oligos, 0)
    start = _take_clip(offsets, oligos_c)
    count = _take_clip(offsets, oligos_c + 1) - start
    ok = valid if keep_overabundant else valid & (count <= max_occ)
    lane = torch.arange(max_occ, dtype=torch.int64,
                        device=oligos.device)[None, None, :]
    pos = _take_clip(positions, start[..., None] + lane)
    qp = qpos.to(torch.int64)[None, :, None]
    bad = ~ok[..., None] | (lane >= count[..., None]) | (pos < qp)
    return torch.where(bad, INVALID, pos - qp)


def prevalent_diagonals(diags: torch.Tensor, top_k: int,
                        merge_slop: int = 0, return_last: bool = False):
    """Top-k diagonals per read by k-mer support: (int64[B, top_k]
    diagonals, int32[B, top_k] counts), count-descending with ties to
    the lower sorted position (lax.top_k). With merge_slop > 0 a
    diagonal within slop of its predecessor in sorted order joins the
    predecessor's run, so a run ends where the next element starts one;
    return_last adds each run's last (largest) diagonal. tpumap's uint32
    difference d - prev never wraps past the first column (the sort puts
    prev <= d), so the int64 difference gives the same starts."""
    B, N = diags.shape
    d = torch.sort(diags, dim=1).values
    inv = torch.full((B, 1), INVALID, dtype=d.dtype, device=d.device)
    prev = torch.cat([inv, d[:, :-1]], dim=1)
    is_start = d != prev if merge_slop == 0 else (d - prev) > merge_slop
    is_start[:, 0] = True
    i = torch.arange(N, dtype=torch.int64, device=d.device)[None, :]
    run_start = torch.cummax(torch.where(is_start, i, 0), dim=1).values
    if merge_slop == 0:
        is_last = d != torch.cat([d[:, 1:], inv], dim=1)
    else:
        is_last = torch.cat([is_start[:, 1:],
                             torch.ones_like(is_start[:, :1])], dim=1)
    count = torch.where(is_last & (d != INVALID), i - run_start + 1,
                        0).to(torch.int32)
    rep = torch.gather(d, 1, run_start)
    top_counts, top_idx = stable_topk(count, top_k)
    found = top_counts > 0
    top_diags = torch.where(found, torch.gather(rep, 1, top_idx), INVALID)
    if return_last:
        # count is nonzero only at a run's last element
        top_last = torch.where(found, torch.gather(d, 1, top_idx), INVALID)
        return top_diags, top_counts, top_last
    return top_diags, top_counts


def seed_reads(index, codes, nmask, lengths, max_occ: int = 32,
               top_k: int = 8, qinterval: int = 1, space=None,
               index_space=None):
    """Full seed stage: codes -> top-k candidate univdiagonals per read.
    With `space` the codes are mapped to the reduced base space and the
    space's table is used; index_space picks the table without mapping
    the codes ("snp": the SNP index). The N mask stays as it is."""
    codes = map_codes(codes, space)
    offsets, positions = index.mode_index(
        index_space if index_space is not None else space)
    oligos, valid = query_oligos(codes, nmask, lengths, index.k)
    NQ = oligos.shape[1]
    qpos = torch.arange(0, NQ, qinterval, dtype=torch.int64,
                        device=codes.device)
    diags = lookup_diagonals(offsets, positions,
                             oligos[:, ::qinterval], valid[:, ::qinterval],
                             qpos, max_occ)
    return prevalent_diagonals(diags.reshape(diags.shape[0], -1), top_k)
