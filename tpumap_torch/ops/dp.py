"""Banded affine-gap DP and traceback (port of tpumap/ops/dp.py).

`banded_align` wraps the CUDA kernel K2 (csrc/dp.cu) and `traceback` the
kernel K3 (csrc/traceback.cu), which also run-length encodes the
transcript as tpumap's fused ladder does on device (ladder.py:505-523).
The plain versions beside them run for CPU tensors; they loop over
query rows and walker steps with the same int32 arithmetic as tpumap,
so the direction bits, ties and transcripts are identical.

Band layout: cell (i, j) with |j - i| <= band sits at lane
k = j - i + band of row i. Scoring follows tpumap: match +3,
mismatch -3, gap open -8 including the first residue, extend -3.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from tpumap_torch import kernels
from tpumap_torch.ops.u32 import INT32_MIN, take_along

NEG = -(2 ** 20)

# direction codes
DIAG, UP, LEFT, STOP = 0, 1, 2, 3
# edit transcript codes (INS: extra query base; DEL: extra genome base)
T_MATCH, T_INS, T_DEL, T_END = 0, 1, 2, 3
MAXRUNS = 12   # transcript runs kept per row (ladder.py)


@dataclass(frozen=True)
class Scoring:
    match: int = 3
    mismatch: int = -3
    gap_open: int = 8      # cost of a 1-residue gap
    gap_extend: int = 3    # per additional residue


def banded_align_plain(qcodes, qlens, gcodes, glens, band: int,
                       scoring: Scoring = Scoring(), mode: str = "glocal"):
    """qcodes uint8[B, Lq], gcodes uint8[B, Lg]; qlens/glens int32[B].
    Returns score int32[B], end_k int32[B], dirs uint8[B, Lq, W] and
    H_last int32[B, W]."""
    B, Lq = qcodes.shape
    Lg = gcodes.shape[1]
    W = 2 * band + 1
    dev = qcodes.device
    i32 = torch.int32
    lanes = torch.arange(W, dtype=i32, device=dev)[None, :]
    o, e = scoring.gap_open, scoring.gap_extend
    if mode == "global":
        lead = lanes - band
        H = torch.where(lead == 0, 0,
                        torch.where(lead > 0, -(o + (lead - 1) * e), NEG))
        H = H.to(i32).expand(B, W).contiguous()
    else:
        H = torch.zeros((B, W), dtype=i32, device=dev)
    F = torch.full((B, W), NEG, dtype=i32, device=dev)
    negcol = torch.full((B, 1), NEG, dtype=i32, device=dev)
    glens_c = glens.to(i32)[:, None]
    dirs = torch.empty((B, Lq, W), dtype=torch.uint8, device=dev)
    for i in range(1, Lq + 1):
        j = i - 1 + lanes - band
        g = torch.gather(gcodes, 1, j.clamp(0, Lg - 1).to(torch.int64)
                         .expand(B, W))
        in_band = (j >= 0) & (j < glens_c)
        eq = (g == qcodes[:, i - 1:i]) & in_band
        s = torch.where(eq, scoring.match, scoring.mismatch).to(i32)
        H_up = torch.cat([H[:, 1:], negcol], dim=1)
        F_up = torch.cat([F[:, 1:], negcol], dim=1)
        Fn = torch.maximum(H_up - o, F_up - e)
        M = H + s
        MF = torch.maximum(M, Fn)
        t = MF + e * lanes
        c = torch.cummax(t, dim=1).values
        c_shift = torch.cat([negcol, c[:, :-1]], dim=1)
        E = c_shift - o - e * (lanes - 1)
        Hn = torch.where(in_band, torch.maximum(MF, E), NEG)
        Fn = torch.where(in_band, Fn, NEG)
        d = torch.where(Hn == M, DIAG, torch.where(Hn == E, LEFT, UP))
        fcont = (Fn == F_up - e) & (Fn != H_up - o)
        esrc = c_shift == torch.cat([negcol, t[:, :-1]], dim=1)
        dirs[:, i - 1] = (d | (fcont.to(i32) << 2) | (esrc.to(i32) << 3)
                          | ((MF == M).to(i32) << 4)).to(torch.uint8)
        active = (i <= qlens)[:, None]
        H = torch.where(active, Hn, H)
        F = torch.where(active, Fn, F)
    if mode == "global":
        end_k = (glens - qlens + band).to(i32)
        # JAX's take_along_axis fill for out-of-band end lanes
        score = take_along(H, end_k[:, None], INT32_MIN)[:, 0]
    else:
        # torch.max returns the first maximal index, as jnp.argmax
        score, end_k = torch.max(H, dim=1)
        end_k = end_k.to(i32)
    return {"score": score, "end_k": end_k, "dirs": dirs, "H_last": H}


def banded_align(qcodes, qlens, gcodes, glens, band: int,
                 scoring: Scoring = Scoring(), mode: str = "glocal"):
    """banded_align_plain for CPU tensors; the K2 kernel for CUDA (one
    warp a problem, so band <= 63; every caller passes INDEL_BAND = 32)."""
    if mode not in ("glocal", "global"):
        raise ValueError(f"unknown mode {mode!r}")
    if qcodes.device.type == "cpu":
        return banded_align_plain(qcodes, qlens, gcodes, glens, band,
                                  scoring, mode)
    B, Lq = qcodes.shape
    Lg = gcodes.shape[1]
    W = 2 * band + 1
    dev = qcodes.device
    kernels.check_args("banded_align", dev,
                       (qcodes, torch.uint8, (B, Lq)),
                       (qlens, torch.int32, (B,)),
                       (gcodes, torch.uint8, (B, Lg)),
                       (glens, torch.int32, (B,)))
    out = {"score": torch.empty(B, dtype=torch.int32, device=dev),
           "end_k": torch.empty(B, dtype=torch.int32, device=dev),
           "dirs": torch.empty((B, Lq, W), dtype=torch.uint8, device=dev),
           "H_last": torch.empty((B, W), dtype=torch.int32, device=dev)}
    if B == 0:
        return out
    if not 0 <= band <= 63 or Lq < 1 or Lg < 1:
        raise ValueError("banded_align: needs 0 <= band <= 63 (one warp "
                         "a problem) and non-empty sequences")
    kernels.launch("banded_align", dev, qcodes, qlens, gcodes, glens,
                   B, Lq, Lg, band, int(mode == "global"),
                   scoring.match, scoring.mismatch, scoring.gap_open,
                   scoring.gap_extend, out["dirs"], out["score"],
                   out["end_k"], out["H_last"])
    return out


def run_length_plain(ops: torch.Tensor, maxruns: int = MAXRUNS):
    """Run-length encoding of end-first transcripts ops uint8[R, S]
    (ladder.py:505-523): run_op uint8[R, maxruns] (op + 1, 0 = none),
    run_len int16[R, maxruns] and nruns int32[R], in forward order."""
    rev = ops.flip(1)
    valid = rev != T_END
    prev = torch.cat([torch.full_like(rev[:, :1], 255), rev[:, :-1]], 1)
    prev_valid = torch.cat([torch.zeros_like(valid[:, :1]), valid[:, :-1]],
                           1)
    newrun = valid & ((rev != prev) | ~prev_valid)
    runidx = torch.cumsum(newrun.to(torch.int32), dim=1) - 1
    nruns = torch.where(valid, runidx, -1).max(dim=1).values + 1
    slot = torch.arange(maxruns, dtype=runidx.dtype, device=ops.device)
    onehot = (runidx[:, :, None] == slot) & valid[:, :, None]
    run_len = onehot.sum(dim=1).to(torch.int16)
    run_op = torch.where(onehot, rev.to(torch.int32)[:, :, None] + 1, 0)
    return (run_op.max(dim=1).values.to(torch.uint8), run_len,
            nruns.to(torch.int32))


def traceback_plain(dirs, qlens, end_k, band: int, maxruns: int = MAXRUNS):
    """Walk the direction matrix back to row 0.

    Returns ops uint8[B, S] (S = Lq + 2*band, end-first), k_final
    int32[B], and the transcript's runs (run_length_plain)."""
    B, Lq, W = dirs.shape
    S = Lq + 2 * band
    ST_H, ST_E, ST_F, ST_MF = 0, 1, 2, 3
    dev = dirs.device
    i = qlens.to(torch.int64).clone()
    k = end_k.to(torch.int64).clone()
    st = torch.zeros(B, dtype=torch.int64, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    flat = dirs.reshape(B, Lq * W).to(torch.int64)
    ops = torch.empty((B, S), dtype=torch.uint8, device=dev)
    for step in range(S):
        cell = torch.gather(flat, 1, ((i - 1).clamp(0, Lq - 1) * W
                                      + k.clamp(0, W - 1))[:, None])[:, 0]
        d = cell & 3
        fcont = (cell >> 2) & 1
        esrc = (cell >> 3) & 1
        mf_is_m = (cell >> 4) & 1
        at_end = done | (i <= 0)
        in_e = (st == ST_E) | ((st == ST_H) & (d == LEFT))
        is_m = (((st == ST_H) & (d == DIAG))
                | ((st == ST_MF) & (mf_is_m == 1)))
        emit = torch.where(at_end, T_END,
                           torch.where(in_e, T_DEL,
                                       torch.where(is_m, T_MATCH, T_INS)))
        ops[:, step] = emit.to(torch.uint8)
        nst = torch.where(in_e, torch.where(esrc == 1, ST_MF, ST_E),
                          torch.where(is_m, ST_H,
                                      torch.where(fcont == 1, ST_F, ST_H)))
        ni = torch.where(in_e, i, i - 1)
        nk = torch.where(in_e, k - 1, torch.where(is_m, k, k + 1))
        done = at_end | ((emit != T_DEL) & (ni <= 0))
        i = torch.where(at_end, i, ni)
        k = torch.where(at_end, k, nk)
        st = torch.where(at_end, st, nst)
    run_op, run_len, nruns = run_length_plain(ops, maxruns)
    return ops, k.to(torch.int32), run_op, run_len, nruns


def traceback(dirs, qlens, end_k, band: int, maxruns: int = MAXRUNS):
    """traceback_plain for CPU tensors; the K3 kernel for CUDA (which
    writes run_len as uint16 into the int16 tensor, the bits of
    traceback_plain's int16 lengths)."""
    if dirs.device.type == "cpu":
        return traceback_plain(dirs, qlens, end_k, band, maxruns)
    B, Lq, W = dirs.shape
    if B and Lq < 1:
        raise ValueError("traceback: needs at least one query row")
    S = Lq + 2 * band
    dev = dirs.device
    kernels.check_args("traceback", dev,
                       (dirs, torch.uint8, (B, Lq, 2 * band + 1)),
                       (qlens, torch.int32, (B,)),
                       (end_k, torch.int32, (B,)))
    ops = torch.empty((B, S), dtype=torch.uint8, device=dev)
    k_final = torch.empty(B, dtype=torch.int32, device=dev)
    run_op = torch.empty((B, maxruns), dtype=torch.uint8, device=dev)
    run_len = torch.empty((B, maxruns), dtype=torch.int16, device=dev)
    nruns = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        kernels.launch("traceback", dev, dirs, qlens, end_k, B, Lq, W,
                       band, maxruns, ops, k_final, run_op, run_len, nruns)
    return ops, k_final, run_op, run_len, nruns
