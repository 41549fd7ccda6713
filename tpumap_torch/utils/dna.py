"""DNA alphabet encoding and 2-bit packing (host-side, numpy; a copy
of tpumap/utils/dna.py).

Encoding matches the reference convention (A=0, C=1, G=2, T=3; see
src/compress-write.c:57-76 for the on-disk 2-bit code), so
packed words can be compared against reference index artifacts bit-for-bit.
Non-ACGT characters are stored as A with a separate N-flag, again following
the reference (N -> A+flag, X -> T+flag).
"""
from __future__ import annotations

import numpy as np

A, C, G, T = 0, 1, 2, 3

# char -> 2-bit code; non-ACGT maps to A (0) and is flagged via n-mask
_CODE = np.zeros(256, dtype=np.uint8)
_CODE[ord("C")] = _CODE[ord("c")] = 1
_CODE[ord("G")] = _CODE[ord("g")] = 2
_CODE[ord("T")] = _CODE[ord("t")] = 3
_CODE[ord("X")] = 3  # reference stores X as T+flag

_ACGT = np.zeros(256, dtype=bool)
for _c in b"ACGTacgt":
    _ACGT[_c] = True

_DECODE = np.frombuffer(b"ACGT", dtype=np.uint8)

BASES = "ACGT"


def encode(seq: bytes | str) -> tuple[np.ndarray, np.ndarray]:
    """ASCII sequence -> (codes uint8[L] in 0..3, n_mask bool[L])."""
    if isinstance(seq, str):
        seq = seq.encode()
    raw = np.frombuffer(seq, dtype=np.uint8)
    return _CODE[raw], ~_ACGT[raw]


def decode(codes: np.ndarray, n_mask: np.ndarray | None = None) -> str:
    """codes uint8[L] -> ASCII string, with flagged positions printed as N."""
    out = _DECODE[codes]
    if n_mask is not None and n_mask.any():
        out = out.copy()
        out[np.asarray(n_mask, dtype=bool)] = ord("N")
    return out.tobytes().decode()


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement in code space: complement(x) = 3 - x."""
    return (3 - codes)[::-1].copy()


def revcomp(seq: str) -> str:
    codes, n_mask = encode(seq)
    return decode(revcomp_codes(codes), n_mask[::-1])


def pack_2bit(codes: np.ndarray, bases_per_word: int = 16) -> np.ndarray:
    """Pack 2-bit codes into little-endian uint32 words.

    Base i sits at bits 2*(i % bases_per_word) of word i // bases_per_word
    (the reference's "low word" convention). The tail word is zero-padded
    (code A); callers carry an explicit length for masking.
    """
    L = len(codes)
    nwords = (L + bases_per_word - 1) // bases_per_word or 1
    padded = np.zeros(nwords * bases_per_word, dtype=np.uint32)
    padded[:L] = codes
    lanes = padded.reshape(nwords, bases_per_word)
    shifts = (2 * np.arange(bases_per_word, dtype=np.uint32))[None, :]
    return (lanes << shifts).sum(axis=1, dtype=np.uint32)


def pack_bits(mask: np.ndarray, bits_per_word: int = 32) -> np.ndarray:
    """Pack a boolean mask into uint32 words, bit i%32 of word i//32."""
    L = len(mask)
    nwords = (L + bits_per_word - 1) // bits_per_word or 1
    padded = np.zeros(nwords * bits_per_word, dtype=np.uint32)
    padded[:L] = mask
    lanes = padded.reshape(nwords, bits_per_word)
    shifts = np.arange(bits_per_word, dtype=np.uint32)[None, :]
    return (lanes << shifts).sum(axis=1, dtype=np.uint32)


def unpack_2bit(words: np.ndarray, length: int, bases_per_word: int = 16) -> np.ndarray:
    """Inverse of pack_2bit."""
    shifts = (2 * np.arange(bases_per_word, dtype=np.uint32))[None, :]
    lanes = (words[:, None] >> shifts) & np.uint32(3)
    return lanes.reshape(-1)[:length].astype(np.uint8)


def kmer_codes(codes: np.ndarray, k: int) -> np.ndarray:
    """All overlapping k-mers as integers (base 4, leftmost base = high bits).

    Matches the reference oligo convention where the oligo is built by
    shifting left and or-ing each successive base (src/oligo.c), so
    oligo(s[i:i+k]) = sum s[i+j] * 4^(k-1-j).
    """
    L = len(codes)
    n = L - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint64)
    acc = np.zeros(n, dtype=np.uint64)
    for j in range(k):
        acc = (acc << np.uint64(2)) | codes[j:j + n].astype(np.uint64)
    return acc
