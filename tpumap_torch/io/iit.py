"""IIT (interval index tree) map files: the reader of tpumap/io/iit.py,
as far as known splicing (-s) reaches it.

Reads the reference's versioned interval-tree-on-disk format
(src/iitdef.h:40-80): version 1 ("univ", no divisions) and versions 2-6
("div", one division per chromosome, intervals with a sign). Only
`IIT.read` and the fields `KnownSplicing.from_splicing_iit` reads are
here; tpumap's writer, builder and queries are not.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

NO_SORT, ALPHA_SORT, NUMERIC_ALPHA_SORT, CHROM_SORT, FILENAME_SORT = range(5)

_INT = struct.Struct("<i")
_UINT = struct.Struct("<I")


@dataclass
class IITDiv:
    """Intervals of one division (chromosome)."""
    lows: np.ndarray        # uint64[n]
    highs: np.ndarray       # uint64[n]
    signs: np.ndarray       # int32[n] (+1/-1/0; version 1 has all +1)
    types: np.ndarray       # int32[n] indices into IIT.typestrings
    # tree arrays (loaded or built)
    sigmas: np.ndarray | None = None
    omegas: np.ndarray | None = None
    nodes: np.ndarray | None = None     # int64[nnodes, 5]

    def __len__(self):
        return len(self.lows)


@dataclass
class IIT:
    version: int = 5
    divs: list[str] = field(default_factory=lambda: [""])
    divdata: list[IITDiv] = field(default_factory=list)
    typestrings: list[str] = field(default_factory=lambda: [""])
    fieldstrings: list[str] = field(default_factory=list)
    labels: list[str] = field(default_factory=list)       # global, by div order
    annotations: list[str] = field(default_factory=list)  # annotation lines text
    restofheaders: list[str] = field(default_factory=list)  # "" if none
    divsort: int = CHROM_SORT
    coords_8p: bool = False

    def typeint(self, typestring: str) -> int:
        try:
            return self.typestrings.index(typestring)
        except ValueError:
            return -1

    @classmethod
    def read(cls, path: str) -> "IIT":
        with open(path, "rb") as fp:
            buf = fp.read()
        r = _Reader(buf)
        first = r.int32()
        if first != 0:
            return cls._read_univ(r, first)
        version = r.int32()
        if version < 2 or version > 6:
            raise ValueError(f"unsupported IIT version {version} in {path}")
        return cls._read_div(r, version)

    @classmethod
    def _read_univ(cls, r: "_Reader", nintervals: int) -> "IIT":
        coord8 = nintervals < 0
        n = abs(nintervals)
        ntypes = r.int32()
        nnodes = r.int32()
        sigmas = r.ints(n + 1)
        omegas = r.ints(n + 1)
        nodes = np.zeros((nnodes, 5), dtype=np.int64)
        for i in range(nnodes):
            nodes[i, 0] = r.uint64() if coord8 else r.uint32()
            nodes[i, 1:] = [r.int32() for _ in range(4)]
        lows = np.zeros(n, dtype=np.uint64)
        highs = np.zeros(n, dtype=np.uint64)
        types = np.zeros(n, dtype=np.int32)
        for i in range(n):
            lows[i] = r.uint64() if coord8 else r.uint32()
            highs[i] = r.uint64() if coord8 else r.uint32()
            types[i] = r.int32()
        typestrings = r.string_block(ntypes)
        r.ints(n)  # labelorder
        labels = r.string_block(n, pointers=n + 1)
        annots_raw = r.string_block(n, pointers=n + 1)
        annotations, rohs = _split_annots(annots_raw, version=5)
        div = IITDiv(lows=lows, highs=highs,
                     signs=np.ones(n, dtype=np.int32), types=types,
                     sigmas=sigmas, omegas=omegas, nodes=nodes)
        return cls(version=1, divs=[""], divdata=[div],
                   typestrings=typestrings, labels=labels,
                   annotations=annotations, restofheaders=rohs,
                   coords_8p=coord8)

    @classmethod
    def _read_div(cls, r: "_Reader", version: int) -> "IIT":
        if version >= 5:
            label_ps = r.int32()
            annot_ps = r.int32()
        else:
            label_ps = annot_ps = 8 if version == 4 else 4
        total = r.int32()
        ntypes = r.int32()
        nfields = r.int32()
        if version >= 3:
            ndivs = r.int32()
            nintervals = [r.int32() for _ in range(ndivs)]
            cum_ni = [r.int32() for _ in range(ndivs + 1)]
            nnodes = [r.int32() for _ in range(ndivs)]
            cum_nn = [r.int32() for _ in range(ndivs + 1)]
            divsort = r.int32()
            divs = r.string_block(ndivs)
        else:
            ndivs = 1
            nintervals = [total]
            nnodes = [r.int32()]
            divsort = NO_SORT
            divs = [""]
        divdata = []
        per_div_trees = []
        for divno in range(ndivs):
            n = nintervals[divno]
            if version >= 2:
                r.ints(n + 1)  # alphas
                r.ints(n + 1)  # betas
            sigmas = r.ints(n + 1)
            omegas = r.ints(n + 1)
            nodes = np.zeros((nnodes[divno], 5), dtype=np.int64)
            for i in range(nnodes[divno]):
                nodes[i, 0] = r.uint32()
                nodes[i, 1:] = [r.int32() for _ in range(4)]
            per_div_trees.append((sigmas, omegas, nodes))
        for divno in range(ndivs):
            n = nintervals[divno]
            arr = np.frombuffer(r.take(n * 16), dtype="<i4").reshape(n, 4)
            sigmas, omegas, nodes = per_div_trees[divno]
            divdata.append(IITDiv(
                lows=arr[:, 0].astype(np.uint32).astype(np.uint64),
                highs=arr[:, 1].astype(np.uint32).astype(np.uint64),
                signs=arr[:, 2].astype(np.int32).copy(),
                types=arr[:, 3].astype(np.int32).copy(),
                sigmas=sigmas, omegas=omegas, nodes=nodes))
        typestrings = r.string_block(ntypes)
        fieldstrings = r.string_block(nfields) if version >= 2 else []
        if version == 6:
            r.ints(total)                      # valueorder
            r.take(total * 8)                  # values (doubles)
        r.ints(total)  # labelorder
        labels = r.string_block(total, pointers=total + 1, psize=label_ps)
        annots_raw = r.string_block(total, pointers=total + 1, psize=annot_ps)
        annotations, rohs = _split_annots(annots_raw, version)
        return cls(version=version, divs=divs, divdata=divdata,
                   typestrings=typestrings, fieldstrings=fieldstrings,
                   labels=labels, annotations=annotations,
                   restofheaders=rohs, divsort=divsort)


def _split_annots(raw: list[str], version: int):
    """Split stored annotation strings into (annotation, restofheader)
    per src/iit-read.c IIT_annotation."""
    annotations, rohs = [], []
    for a in raw:
        if version <= 4:
            # version-1 files from iit_store still carry the '\n' marker
            if a.startswith("\n"):
                annotations.append(a[1:])
                rohs.append("")
            else:
                annotations.append(a)
                rohs.append("")
        elif a == "":
            annotations.append("")
            rohs.append("")
        elif a.startswith("\n"):
            annotations.append(a[1:])
            rohs.append("")
        else:
            head, _, rest = a.partition("\n")
            annotations.append(rest)
            rohs.append(head)
    return annotations, rohs


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise ValueError("truncated IIT file")
        self.pos += n
        return b

    def int32(self) -> int:
        return _INT.unpack(self.take(4))[0]

    def uint32(self) -> int:
        return _UINT.unpack(self.take(4))[0]

    def uint64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def ints(self, n: int) -> np.ndarray:
        return np.frombuffer(self.take(4 * n), dtype="<i4").astype(np.int64)

    def string_block(self, n: int, pointers: int | None = None,
                     psize: int = 4) -> list[str]:
        npointers = pointers if pointers is not None else n + 1
        dtype = "<u4" if psize == 4 else "<u8"
        ptrs = np.frombuffer(self.take(psize * npointers), dtype=dtype)
        total = int(ptrs[n]) if npointers > n else int(ptrs[-1])
        blob = self.take(total)
        out = []
        for i in range(n):
            start = int(ptrs[i])
            end = blob.find(b"\0", start)
            out.append(blob[start:end if end >= 0 else None].decode(
                "utf-8", errors="replace"))
        return out
