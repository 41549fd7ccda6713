"""cDNA translation / ORF detection (host side).

The port's copy of tpumap/gmap/translation.py, unchanged but for its imports.

Capability analog of src/translation.c (Translation_via_genomic): find the
best open reading frame of the aligned cDNA and report its query span, used
by the summary output ("Translation: 2..4006 (1334 aa)") and the GFF3 CDS
rows. The reference picks the longest stop-free codon run across the three
frames (not requiring ATG); ties go to the earlier start.
"""
from __future__ import annotations

import numpy as np

CODON_TABLE = {}
_BASES = "ACGT"
_AA = (
    "KNKN" "TTTT" "RSRS" "IIMI"   # AAA AAC AAG AAT ... (indexed differently below)
)

# build codon -> aa with the standard table
_STANDARD = {
    "TTT": "F", "TTC": "F", "TTA": "L", "TTG": "L",
    "CTT": "L", "CTC": "L", "CTA": "L", "CTG": "L",
    "ATT": "I", "ATC": "I", "ATA": "I", "ATG": "M",
    "GTT": "V", "GTC": "V", "GTA": "V", "GTG": "V",
    "TCT": "S", "TCC": "S", "TCA": "S", "TCG": "S",
    "CCT": "P", "CCC": "P", "CCA": "P", "CCG": "P",
    "ACT": "T", "ACC": "T", "ACA": "T", "ACG": "T",
    "GCT": "A", "GCC": "A", "GCA": "A", "GCG": "A",
    "TAT": "Y", "TAC": "Y", "TAA": "*", "TAG": "*",
    "CAT": "H", "CAC": "H", "CAA": "Q", "CAG": "Q",
    "AAT": "N", "AAC": "N", "AAA": "K", "AAG": "K",
    "GAT": "D", "GAC": "D", "GAA": "E", "GAG": "E",
    "TGT": "C", "TGC": "C", "TGA": "*", "TGG": "W",
    "CGT": "R", "CGC": "R", "CGA": "R", "CGG": "R",
    "AGT": "S", "AGC": "S", "AGA": "R", "AGG": "R",
    "GGT": "G", "GGC": "G", "GGA": "G", "GGG": "G",
}


# NCBI genetic-code variants (gmap --translation-code, src/gmap.c
# translation codes help): stored as overrides of the standard table.
_CODE_OVERRIDES = {
    1: {},
    2: {"AGA": "*", "AGG": "*", "ATA": "M", "TGA": "W"},
    3: {"ATA": "M", "CTT": "T", "CTC": "T", "CTA": "T", "CTG": "T",
        "TGA": "W"},
    4: {"TGA": "W"},
    5: {"AGA": "S", "AGG": "S", "ATA": "M", "TGA": "W"},
    6: {"TAA": "Q", "TAG": "Q"},
    9: {"AAA": "N", "AGA": "S", "AGG": "S", "TGA": "W"},
    10: {"TGA": "C"},
    11: {},
    12: {"CTG": "S"},
    13: {"AGA": "G", "AGG": "G", "ATA": "M", "TGA": "W"},
    14: {"AAA": "N", "AGA": "S", "AGG": "S", "TAA": "Y", "TGA": "W"},
    15: {"TAG": "Q"},
    16: {"TAG": "L"},
    21: {"TGA": "W", "ATA": "M", "AGA": "S", "AGG": "S", "AAA": "N"},
    22: {"TCA": "*", "TAG": "L"},
    23: {"TTA": "*"},
    24: {"AGA": "S", "AGG": "K", "TGA": "W"},
    25: {"TGA": "G"},
    26: {"CTG": "A"},
    29: {"TAA": "Y", "TAG": "Y"},
    30: {"TAA": "E", "TAG": "E"},
    31: {"TGA": "W"},
    33: {"TAA": "Y", "TGA": "W", "AGA": "S", "AGG": "K"},
}

_ACTIVE = dict(_STANDARD)
# initiation codons beyond ATG (gmap --alt-start-codons)
_ALT_STARTS = ("GTG", "TTG")
_alt_start_p = [False]


def set_translation_code(code: int) -> None:
    """Select the NCBI genetic code used by all translation output."""
    if code not in _CODE_OVERRIDES:
        raise ValueError(f"unsupported translation code {code} "
                         f"(supported: {sorted(_CODE_OVERRIDES)})")
    _ACTIVE.clear()
    _ACTIVE.update(_STANDARD)
    _ACTIVE.update(_CODE_OVERRIDES[code])


def set_alt_start_codons(enable: bool) -> None:
    _alt_start_p[0] = bool(enable)


def translate_codes(codes: np.ndarray) -> str:
    """2-bit codes -> aa string (length len//3)."""
    out = []
    for i in range(0, len(codes) - 2, 3):
        codon = _BASES[codes[i]] + _BASES[codes[i + 1]] + _BASES[codes[i + 2]]
        out.append(_ACTIVE[codon])
    return "".join(out)


def _is_start(codes: np.ndarray, aa_index: int, frame: int) -> bool:
    p = frame + 3 * aa_index
    codon = "".join(_BASES[c] for c in codes[p:p + 3])
    return codon == "ATG" or (_alt_start_p[0] and codon in _ALT_STARTS)


def best_orf(codes: np.ndarray,
             fulllength: bool = False,
             cdsstart: int | None = None) -> tuple[int, int, str]:
    """Best ORF per the reference's rules (translation.c
    find_bounds_forward): in each frame the FIRST candidate ORF starts at
    the frame's first codon (no Met required unless fulllength); after a
    stop codon, subsequent ORFs must start at an initiation codon (M).
    ORF length counts the stop codon. Across frames the longest wins, with
    ties resolved frame2 > frame1 > frame0.

    Returns (qstart, qend) as a 0-based half-open query span covering whole
    codons plus the terminating stop codon if present, and the aa string
    (stop excluded) — the reported span (e.g. "Translation: 2..4006
    (1334 aa)") counts the stop codon in the span but not in the aa count.
    """
    if cdsstart is not None:
        # gmap -a/--cdsstart: translate from the given 1-based nucleotide
        frame = cdsstart % 3
        s = (cdsstart - frame) // 3
        aa = translate_codes(codes[frame:])
        e = len(aa) - 1
        endstop = False
        for i in range(s, len(aa)):
            if aa[i] == "*":
                e, endstop = i, True
                break
        qs = frame + 3 * s
        qe = frame + 3 * e + 3
        return (qs, qe, aa[s:e] if endstop else aa[s:e + 1])
    per_frame = []
    for frame in range(3):
        aa = translate_codes(codes[frame:])
        needmet = fulllength
        orf = 0
        start = 0
        bestorf, beststart, bestend, endstop = 0, 0, max(len(aa) - 1, 0), False
        for i, c in enumerate(aa):
            if needmet:
                if c == "M" or (_alt_start_p[0]
                                and _is_start(codes, i, frame)):
                    orf = 1
                    start = i
                    needmet = False
            elif c == "*":
                orf += 1
                if orf > bestorf:
                    bestorf, beststart, bestend, endstop = orf, start, i, True
                needmet = True
            else:
                orf += 1
        if orf > bestorf:
            bestorf, beststart, bestend, endstop = orf, start, len(aa) - 1, False
        per_frame.append((bestorf, frame, beststart, bestend, endstop, aa))
    length = max(p[0] for p in per_frame)
    for p in reversed(per_frame):     # frame2 > frame1 > frame0 on ties
        if p[0] == length:
            bestorf, frame, s, e, endstop, aa = p
            break
    qs = frame + 3 * s
    qe = frame + 3 * e + 3
    aas = aa[s:e] if endstop else aa[s:e + 1]
    return (qs, qe, aas)
