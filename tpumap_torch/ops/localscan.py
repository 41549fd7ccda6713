"""Window-restricted fragment scans (port of tpumap/ops/localscan.py).

Each row's genome window (65,536 bp on the RNA path) is compared with a
packed fragment word at every offset, as 16 shift phases of an XOR and
popcount stream over the window's packed words. Three scans share that
stream:

- `scan_fragment`: the top_k (mismatches, offset) placements (kernel
  K6a);
- `scan_exact_sites`: the number of exact placements and the top_k
  smallest exact offsets (kernel K6b);
- `scan_fragment_runs`: the top_k placements by the longest clean run
  anchored at the fragment's last (suffix) or first (prefix) base
  (kernel K6c).

The wrappers run the plain versions beside them for CPU tensors and the
CUDA kernels of csrc/localscan.cu for CUDA tensors. The plain versions
take the rows in chunks, so a call never holds more than
CHUNK x 65,552 offsets; tpumap's top-k by iterated block minima equals
torch.topk here because every key (score, offset) is unique.

Window starts are int64 values in [0, 2^32); positions come back the
same way, (start + offset) mod 2^32 as tpumap's uint32 sum.
"""
from __future__ import annotations

import torch

from tpumap_torch import kernels
from tpumap_torch.ops import verify
from tpumap_torch.ops.u32 import INVALID, MASK32, popcount32, shl32

LOW_PAIRS = 0x55555555
CHUNK = 128
OFF_BITS = 17          # key = score << 17 | offset (offsets < 2^17)


def _frag_word(frag: torch.Tensor) -> torch.Tensor:
    """uint8[R, F] codes -> int64[R]: base j at bits [2j, 2j + 2)."""
    shifts = 2 * torch.arange(frag.shape[1], dtype=torch.int64,
                              device=frag.device)
    return (frag.to(torch.int64) << shifts).sum(dim=1) & MASK32


def _phase_words(genome_packed, win_starts, frag, window: int):
    """Per-phase comparison words of each row: a function p -> the
    [R, nw] mismatch-pair words (bit 2j set iff fragment base j
    mismatches) of offsets 16 * w + p."""
    nw = window // 16 + 1
    win = verify.extract_packed_window(genome_packed, win_starts, nw + 1)
    lo, hi = win[:, :nw], win[:, 1:nw + 1]
    fw = _frag_word(frag)[:, None]

    def mm2(p: int) -> torch.Tensor:
        stream = lo if p == 0 else (lo >> (2 * p)) | shl32(hi, 32 - 2 * p)
        x = stream ^ fw
        return (x | (x >> 1)) & LOW_PAIRS

    return mm2, nw


def _per_offset(mm2, nw: int, window: int, fn) -> torch.Tensor:
    """int32[R, window]: fn(mismatch words) at offset 16 * w + p."""
    phases = [fn(mm2(p)) for p in range(16)]
    R = phases[0].shape[0]
    return torch.stack(phases, dim=2).reshape(R, nw * 16)[:, :window].to(
        torch.int32)


def phase_mismatch_counts(genome_packed, win_starts, frag, frag_lens,
                          window: int, max_frag: int) -> torch.Tensor:
    """Mismatches int32[R, window] of each row's first frag_lens
    fragment bases at every window offset."""
    if max_frag > 16:
        raise ValueError("fragments are at most 16 bases")
    mm2, nw = _phase_words(genome_packed, win_starts, frag, window)
    flen = frag_lens.clamp(0, max_frag).to(torch.int64)
    fm = torch.where(flen >= 16, MASK32, (1 << (2 * flen)) - 1)[:, None]
    return _per_offset(mm2, nw, window, lambda m: popcount32(m & fm))


def fragment_runs(genome_packed, win_starts, frag16, window: int,
                  suffix: bool) -> torch.Tensor:
    """Clean-run lengths int32[R, window] anchored at the fragment's last
    (suffix) or first (prefix) base, at every window offset."""
    mm2, nw = _phase_words(genome_packed, win_starts, frag16, window)

    def run(y):
        for s in (2, 4, 8, 16):     # smear each mismatch towards the anchor
            y = y | (y >> s) if suffix else y | shl32(y, s)
        return popcount32(~y & LOW_PAIRS)

    return _per_offset(mm2, nw, window, run)


def _chunked(fn, R: int, *outs):
    """Run fn(r0, r1) -> tuple over row chunks into the preallocated
    outs."""
    for r0 in range(0, R, CHUNK):
        r1 = min(R, r0 + CHUNK)
        for o, v in zip(outs, fn(r0, r1)):
            o[r0:r1] = v
    return outs


def scan_fragment_plain(genome_packed, win_starts, frag, frag_lens,
                        window: int, max_frag: int, top_k: int = 4):
    """(positions int64[R, top_k], nmm int32[R, top_k]): the top_k
    lowest-mismatch placements, ties to the lower offset."""
    R = win_starts.shape[0]
    dev = win_starts.device
    pos = torch.empty((R, top_k), dtype=torch.int64, device=dev)
    nmm = torch.empty((R, top_k), dtype=torch.int32, device=dev)

    def rows(r0, r1):
        ws = win_starts[r0:r1]
        cnt = phase_mismatch_counts(genome_packed, ws, frag[r0:r1],
                                    frag_lens[r0:r1], window, max_frag)
        off = torch.arange(window, dtype=torch.int64, device=dev)
        v, i = torch.topk((cnt.to(torch.int64) << OFF_BITS) + off, top_k,
                          dim=1, largest=False)
        return ((ws.to(torch.int64)[:, None] + i) & MASK32,
                (v >> OFF_BITS).to(torch.int32))

    return _chunked(rows, R, pos, nmm)


def scan_exact_sites_plain(genome_packed, win_starts, frag, frag_lens,
                           window: int, max_frag: int, top_k: int = 8):
    """(positions int64[R, top_k] ascending, INVALID-padded; count
    int32[R]) of the exact placements; rows with frag_lens <= 0 have
    none (they are not scanned)."""
    R = win_starts.shape[0]
    dev = win_starts.device
    pos = torch.full((R, top_k), INVALID, dtype=torch.int64, device=dev)
    count = torch.zeros(R, dtype=torch.int32, device=dev)
    act = torch.nonzero(frag_lens > 0)[:, 0]
    if act.numel() == 0:
        return pos, count
    a_pos = torch.empty((act.numel(), top_k), dtype=torch.int64, device=dev)
    a_cnt = torch.empty(act.numel(), dtype=torch.int32, device=dev)
    ws_a, frag_a, fl_a = win_starts[act], frag[act], frag_lens[act]

    def rows(r0, r1):
        ws = ws_a[r0:r1]
        hit = phase_mismatch_counts(genome_packed, ws, frag_a[r0:r1],
                                    fl_a[r0:r1], window, max_frag) == 0
        off = torch.arange(window, dtype=torch.int64, device=dev)
        first = torch.topk(torch.where(hit, off, window), top_k, dim=1,
                           largest=False).values
        return (torch.where(first < window,
                            (ws.to(torch.int64)[:, None] + first) & MASK32,
                            INVALID),
                hit.sum(dim=1, dtype=torch.int32))

    _chunked(rows, act.numel(), a_pos, a_cnt)
    pos[act] = a_pos
    count[act] = a_cnt
    return pos, count


def scan_fragment_runs_plain(genome_packed, win_starts, frag16,
                             window: int, top_k: int = 4,
                             suffix: bool = True):
    """(positions int64[R, top_k], runs int32[R, top_k]): the top_k
    placements by anchored clean run, longest first, ties to the lower
    offset."""
    R = win_starts.shape[0]
    dev = win_starts.device
    pos = torch.empty((R, top_k), dtype=torch.int64, device=dev)
    runs = torch.empty((R, top_k), dtype=torch.int32, device=dev)

    def rows(r0, r1):
        ws = win_starts[r0:r1]
        run = fragment_runs(genome_packed, ws, frag16[r0:r1], window,
                            suffix)
        off = torch.arange(window, dtype=torch.int64, device=dev)
        i = torch.topk(off - (run.to(torch.int64) << OFF_BITS), top_k, dim=1,
                       largest=False).indices
        return ((ws.to(torch.int64)[:, None] + i) & MASK32,
                torch.gather(run, 1, i))

    return _chunked(rows, R, pos, runs)


def _launch_scan(name: str, genome_packed, win_starts, frag, frag_lens,
                 window: int, top_k: int, extra: int, count=None):
    """Shared CUDA path of the three scans: checks, outputs, launch. The
    runs scan takes no lengths (frag_lens None: 16-base fragments); the
    exact-site scan passes its int32[R] count tensor and gets no values
    (None), the others pass None."""
    R, F = frag.shape
    dev = win_starts.device
    kernels.check_args(name, dev, (genome_packed, torch.int32, None),
                       (win_starts, torch.int64, (R,)),
                       (frag, torch.uint8, (R, F)),
                       *(() if frag_lens is None
                         else ((frag_lens, torch.int32, (R,)),)))
    if F > 16 or not 1 <= top_k <= 8 or not 1 <= window <= 1 << OFF_BITS:
        raise ValueError(f"{name}: needs fragments of <= 16 bases, "
                         f"1 <= top_k <= 8 and 1 <= window <= 2^17")
    pos = torch.empty((R, top_k), dtype=torch.int64, device=dev)
    val = (torch.empty((R, top_k), dtype=torch.int32, device=dev)
           if count is None else None)
    if R:
        kernels.launch(name, dev, genome_packed, genome_packed.shape[0],
                       win_starts, frag,
                       0 if frag_lens is None else frag_lens, R, F, window,
                       top_k, extra, pos, 0 if val is None else val,
                       0 if count is None else count)
    return pos, val


def scan_fragment(genome_packed, win_starts, frag, frag_lens, window: int,
                  max_frag: int, top_k: int = 4):
    """scan_fragment_plain for CPU tensors; kernel K6a for CUDA."""
    if win_starts.device.type == "cpu":
        return scan_fragment_plain(genome_packed, win_starts, frag,
                                   frag_lens, window, max_frag, top_k)
    if frag.shape[1] != max_frag:
        raise ValueError("scan_fragment: frag must hold max_frag bases")
    return _launch_scan("scan_fragment", genome_packed, win_starts, frag,
                        frag_lens, window, top_k, 0)


def scan_exact_sites(genome_packed, win_starts, frag, frag_lens,
                     window: int, max_frag: int, top_k: int = 8):
    """scan_exact_sites_plain for CPU tensors; kernel K6b for CUDA."""
    if win_starts.device.type == "cpu":
        return scan_exact_sites_plain(genome_packed, win_starts, frag,
                                      frag_lens, window, max_frag, top_k)
    if frag.shape[1] != max_frag:
        raise ValueError("scan_exact_sites: frag must hold max_frag bases")
    count = torch.empty(win_starts.shape[0], dtype=torch.int32,
                        device=win_starts.device)
    pos, _ = _launch_scan("scan_exact_sites", genome_packed, win_starts, frag,
                          frag_lens, window, top_k, 0, count)
    return pos, count


def scan_fragment_runs(genome_packed, win_starts, frag16, window: int,
                       top_k: int = 4, suffix: bool = True):
    """scan_fragment_runs_plain for CPU tensors; kernel K6c for CUDA."""
    if win_starts.device.type == "cpu":
        return scan_fragment_runs_plain(genome_packed, win_starts, frag16,
                                        window, top_k, suffix)
    if frag16.shape[1] != 16:
        raise ValueError("scan_fragment_runs: frag16 must hold 16 bases")
    return _launch_scan("scan_fragment_runs", genome_packed, win_starts,
                        frag16, None, window, top_k, int(suffix))
