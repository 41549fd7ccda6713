"""Mismatch verification (port of tpumap/ops/verify.py).

XOR/popcount comparison of 2-bit packed reads against genome windows at
candidate univdiagonals. `verify_diagonals` is the wrapper of the CUDA
kernel K1 (csrc/verify.cu); `verify_diagonals_plain` beside it is the
plain version, and the one that runs for CPU tensors.

With `space` (ops/mode.py) the read and genome words are both
transformed to the reduced base space first; with `snp` and an index
that has an alternate genome, a base counts only if it mismatches both
the reference and the alt window, under the same N masks.

Gathers clamp their indices, as JAX's mode="clip" takes do (a faulting
index on CUDA would kill the context). Window values are int64 in
[0, 2^32).
"""
from __future__ import annotations

import torch

from tpumap_torch import kernels
from tpumap_torch.index.device import SAFE_PAD_WORDS
from tpumap_torch.ops.mode import SPACE_CODES, transform_packed
from tpumap_torch.ops.u32 import INVALID, MASK32, popcount32, shl32, u32

LOW_PAIRS = 0x55555555


def _gather_clip(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """u32(arr[clip(idx)]) for any index shape."""
    flat = idx.clamp(0, arr.shape[0] - 1).reshape(-1)
    return u32(arr[flat]).reshape(idx.shape)


def _align_words(words: torch.Tensor, s: torch.Tensor, n: int) -> torch.Tensor:
    """Shift-align n output words from n+1 fetched words by s bits."""
    s = s[..., None]
    lo = words[..., :n] >> s
    # (32 - s) & 31 avoids the shift by 32; s == 0 is masked explicitly
    hi = shl32(words[..., 1:], (32 - s) & 31)
    return lo | torch.where(s == 0, torch.zeros_like(hi), hi)


def extract_packed_window(genome_packed: torch.Tensor, starts: torch.Tensor,
                          nwords: int) -> torch.Tensor:
    """Genome words at arbitrary base offsets: [..., nwords] int64, word j
    holding bases [start + 16j, start + 16j + 16)."""
    starts = starts.to(torch.int64) & MASK32
    n = genome_packed.shape[0]
    w0 = starts >> 4
    zext = nwords >= 16 and nwords + 1 > SAFE_PAD_WORDS
    if nwords >= 16:
        # tpumap fetches wide windows as one lax.dynamic_slice of
        # nwords + 1 words, which clamps its start to len - size: a
        # window past the padded genome end moves back. Past
        # SAFE_PAD_WORDS it zero-extends the genome by nwords + 1 words
        # first, so the clamp is to the unextended length.
        w0 = w0.clamp(0, max(n if zext else n - (nwords + 1), 0))
    ar = torch.arange(nwords + 1, dtype=torch.int64, device=starts.device)
    idx = w0[..., None] + ar
    words = _gather_clip(genome_packed, idx)
    if zext:
        words = torch.where(idx < n, words, torch.zeros_like(words))
    return _align_words(words, (starts & 15) << 1, nwords)


def _spread16(x: torch.Tensor) -> torch.Tensor:
    """Interleave the low 16 bits of x with zeros (bit j -> bit 2j)."""
    x = x & 0xFFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    return (x | (x << 1)) & 0x55555555


def extract_bit_window(bitmap: torch.Tensor, starts: torch.Tensor,
                       nwords16: int) -> torch.Tensor:
    """A 1-bit-per-base bitmap window widened to 2 bits per base:
    [..., nwords16] with bit 2j set if base start + 16w + j is flagged."""
    starts = starts.to(torch.int64) & MASK32
    nb = nwords16 // 2 + 1
    ar = torch.arange(nb + 1, dtype=torch.int64, device=starts.device)
    words = _gather_clip(bitmap, (starts >> 5)[..., None] + ar)
    aligned = _align_words(words, starts & 31, nb)
    halves = torch.stack([aligned & 0xFFFF, aligned >> 16], dim=-1)
    halves = halves.reshape(*aligned.shape[:-1], nb * 2)[..., :nwords16]
    return _spread16(halves)


def extract_codes_window(genome_packed: torch.Tensor, starts: torch.Tensor,
                         L: int) -> torch.Tensor:
    """Genome windows as per-base codes uint8[..., L]."""
    W = (L + 15) // 16
    words = extract_packed_window(genome_packed, starts, W)
    shifts = 2 * torch.arange(16, dtype=torch.int64, device=words.device)
    lanes = (words[..., :, None] >> shifts) & 3
    return lanes.reshape(*words.shape[:-1], W * 16)[..., :L].to(torch.uint8)


def mismatch_words(query_packed, genome_window, query_nmask2=None,
                   genome_nmask2=None, query_unk: bool = True,
                   genome_unk: bool = True) -> torch.Tensor:
    """Per-word mismatch mask (bit 2j set iff base j mismatches); N flags
    count as mismatches (unk=True) or match anything (unk=False)."""
    x = query_packed ^ genome_window
    mm = (x | (x >> 1)) & LOW_PAIRS
    if query_nmask2 is not None:
        mm = (mm | query_nmask2) if query_unk else (mm & ~query_nmask2)
    if genome_nmask2 is not None:
        mm = (mm | genome_nmask2) if genome_unk else (mm & ~genome_nmask2)
    return mm


def length_mask_words(lengths: torch.Tensor, nwords: int) -> torch.Tensor:
    """[..., nwords] int64 with bit 2j of word w set iff 16w + j < length."""
    j = torch.arange(nwords * 16, dtype=torch.int64, device=lengths.device)
    valid = j < lengths.to(torch.int64)[..., None]
    lanes = valid.reshape(*lengths.shape, nwords, 16).to(torch.int64)
    shifts = 2 * torch.arange(16, dtype=torch.int64, device=lengths.device)
    return (lanes << shifts).sum(dim=-1)


def count_mismatches(mm_words, lmask_words) -> torch.Tensor:
    return popcount32(mm_words & lmask_words).sum(dim=-1).to(torch.int32)


def mismatch_base_mask(mm_words: torch.Tensor, L: int) -> torch.Tensor:
    """[..., W] mismatch words -> bool[..., L] per-base flags."""
    W = mm_words.shape[-1]
    shifts = 2 * torch.arange(16, dtype=torch.int64, device=mm_words.device)
    bits = (mm_words[..., :, None] >> shifts) & 1
    return bits.reshape(*mm_words.shape[:-1], W * 16)[..., :L].to(torch.bool)


def _mismatch_windows(index, read_words, read_nmask2, starts, W: int,
                      space, snp: bool, query_unk: bool, genome_unk: bool):
    """Mismatch words of read words (int64, already broadcast against
    the windows) against the genome windows at starts: ref-OR-alt with
    snp and an alternate genome, both sides in `space`."""
    gwin = extract_packed_window(index.genome_packed, starts, W)
    gn2 = (extract_bit_window(index.genome_nmask, starts, W)
           if index.genome_has_n else None)
    read_words = transform_packed(read_words, space)
    mm = mismatch_words(read_words, transform_packed(gwin, space),
                        read_nmask2, gn2, query_unk, genome_unk)
    if snp and index.genomealt_packed is not None:
        galt = extract_packed_window(index.genomealt_packed, starts, W)
        mm = mm & mismatch_words(read_words, transform_packed(galt, space),
                                 read_nmask2, gn2, query_unk, genome_unk)
    return mm


def mismatch_mask_single(index, read_packed, read_nmask2, lengths, diag,
                         L: int, query_unk: bool = True,
                         genome_unk: bool = True, *, space=None,
                         snp: bool = False) -> torch.Tensor:
    """Per-base mismatch mask bool[B, L] of each read (int32 packed words,
    aligned orientation) against one diagonal; INVALID rows are all
    mismatch."""
    B, W = read_packed.shape
    valid = diag != INVALID
    starts = torch.where(valid, diag, torch.zeros_like(diag))
    mm = _mismatch_windows(index, u32(read_packed), u32(read_nmask2), starts,
                           W, space, snp, query_unk, genome_unk)
    mask = mismatch_base_mask(mm, L)
    return torch.where(valid[:, None], mask, torch.ones_like(mask))


def verify_diagonals_plain(index, read_packed, read_nmask2, lengths,
                           diagonals, query_unk: bool = True,
                           genome_unk: bool = True, *, space=None,
                           snp: bool = False) -> torch.Tensor:
    """Mismatch counts int32[B, C] of each read against each candidate
    univdiagonal (int64[B, C]); INVALID lanes return the read length."""
    B, W = read_packed.shape
    valid = diagonals != INVALID
    starts = torch.where(valid, diagonals, torch.zeros_like(diagonals))
    mm = _mismatch_windows(index, u32(read_packed)[:, None, :],
                           u32(read_nmask2)[:, None, :], starts, W, space,
                           snp, query_unk, genome_unk)
    counts = count_mismatches(mm, length_mask_words(lengths, W)[:, None, :])
    return torch.where(valid, counts,
                       lengths[:, None].to(torch.int32).expand_as(counts))


def verify_diagonals(index, read_packed, read_nmask2, lengths, diagonals,
                     query_unk: bool = True, genome_unk: bool = True, *,
                     space=None, snp: bool = False) -> torch.Tensor:
    """verify_diagonals_plain for CPU tensors; the K1 kernel for CUDA."""
    if read_packed.device.type == "cpu":
        return verify_diagonals_plain(index, read_packed, read_nmask2,
                                      lengths, diagonals, query_unk,
                                      genome_unk, space=space, snp=snp)
    B, W = read_packed.shape
    C = diagonals.shape[1]
    galt = index.genomealt_packed if snp else None
    kernels.check_args("verify_diagonals", read_packed.device,
                       (index.genome_packed, torch.int32, None),
                       (index.genome_nmask, torch.int32, None),
                       (read_packed, torch.int32, (B, W)),
                       (read_nmask2, torch.int32, (B, W)),
                       (lengths, torch.int32, (B,)),
                       (diagonals, torch.int64, (B, C)),
                       *(() if galt is None else ((galt, torch.int32, None),)))
    out = torch.empty((B, C), dtype=torch.int32, device=read_packed.device)
    if out.numel() == 0:
        return out
    kernels.launch(
        "verify_diagonals", read_packed.device,
        index.genome_packed, index.genome_packed.shape[0],
        index.genome_nmask, index.genome_nmask.shape[0],
        galt, 0 if galt is None else galt.shape[0],
        read_packed, read_nmask2, lengths, diagonals, B, W, C,
        int(index.genome_has_n), int(query_unk), int(genome_unk),
        SPACE_CODES[space], out)
    return out
