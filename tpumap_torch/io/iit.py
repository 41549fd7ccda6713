"""IIT (interval index tree) file format: read, write, query.

Binary-compatible reimplementation of the reference's versioned
interval-tree-on-disk format (src/iitdef.h:40-80, src/iit-write.c:360-416
layout comment, src/iit-write-univ.c:344-368 for version 1), so map files
produced by the reference tools (iit_store, gff3_splicesites | iit_store,
etc.) load directly, and files we write load in the reference.

Two on-disk layouts:

* version 1 ("univ"): no divisions; used for <db>.chromosome.iit /
  <db>.contig.iit and for iit_store inputs without chromosomes.
  Layout: nintervals (negative => 8-byte coords), ntypes, nnodes,
  sigmas/omegas (n+1 ints), FNodes, intervals (low, high, type),
  typepointers/strings, labelorder, labelpointers, labels,
  annotpointers, annotations.

* versions 2-6 ("div"): starts with int 0 then the version number;
  multiple divisions (chromosomes), per-div alphas/betas/sigmas/omegas +
  FNode trees, intervals carry a sign; version >= 5 stores the
  rest-of-header line with the annotation (src/iit-read.c IIT_annotation:
  "" => empty; leading '\n' => no rest-of-header); version 6 adds a
  valueorder/values section.

The FNode tree build reproduces src/iit-write.c Node_make/node_select so
trees (and hence whole files) are byte-identical to the reference's.

The port's copy of tpumap/io/iit.py: reader, range queries, writer and
the iit_store-style builder, so each package reads the files the other
writes, byte for byte the same.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

NO_SORT, ALPHA_SORT, NUMERIC_ALPHA_SORT, CHROM_SORT, FILENAME_SORT = range(5)

_INT = struct.Struct("<i")
_UINT = struct.Struct("<I")


# ---------------------------------------------------------------------------
# chromosome natural ordering (src/chrom.c Chrom_from_string/Chrom_cmp_chrom)

_PURE_NUMERIC, _SEX, _MITO, _NUMERIC_ALPHA, _ALPHA_NUMERIC, _PURE_ALPHA = range(6)


def chrom_sort_key(name: str, mitochondrial: str | None = None):
    """Natural chromosome ordering key (src/chrom.c:94-302)."""
    s = name
    mito = mitochondrial is not None and name == mitochondrial
    if s.startswith("chr") or s.startswith("Chr"):
        s = s[3:]
    sex = s in ("X", "Y")
    if s in ("M", "MT") or (mitochondrial is not None and s == mitochondrial):
        mito = True
    ndigits = 0
    while ndigits < len(s) and s[ndigits].isdigit():
        ndigits += 1
    if 0 < ndigits <= 4 and s[0] != "0":
        num, alpha = int(s[:ndigits]), s[ndigits:]
        ctype = _MITO if mito else (_PURE_NUMERIC if not alpha else _NUMERIC_ALPHA)
        return (ctype, num, alpha, name)
    if mito:
        return (_MITO, 0, "", name)
    if sex:
        return (_SEX, 0, "", name)
    i = 0
    while i < len(s) and not ("1" <= s[i] <= "9"):
        i += 1
    if i < len(s):
        num_str = s[i:]
        j = 0
        while j < len(num_str) and num_str[j].isdigit():
            j += 1
        return (_ALPHA_NUMERIC, 0, s[:i], int(num_str[:j]), name)
    return (_PURE_ALPHA, 0, "", name)


def sort_divs(divs: list[str], divsort: int = CHROM_SORT) -> list[str]:
    proper = [d for d in divs if d != ""]
    if divsort == ALPHA_SORT:
        proper.sort()
    elif divsort == CHROM_SORT:
        # ALPHA_NUMERIC keys have 5 fields vs 4; compare via padded tuples
        proper.sort(key=lambda d: _pad_key(chrom_sort_key(d)))
    elif divsort == NUMERIC_ALPHA_SORT:
        proper.sort(key=lambda d: _pad_key(chrom_sort_key(d)))
    # NO_SORT keeps input order
    return [""] + proper


def _pad_key(k):
    # chrom_sort_key returns 4- or 5-tuples; normalize for comparison:
    # (ctype, num, alpha, [num2], name)
    if len(k) == 4:
        return (k[0], k[1], k[2], 0, k[3])
    return k


# ---------------------------------------------------------------------------
# FNode tree construction (src/iit-write.c:169-266)


def _build_fnodes(lows: np.ndarray, highs: np.ndarray):
    """Build the reference's interval tree.

    Returns (sigmas, omegas, nodes) where sigmas/omegas are int arrays of
    length n+1 (1-based interval indices) and nodes is a list of
    [value, a, b, leftindex, rightindex] in preorder (the file order).
    """
    n = len(lows)
    sigmas = np.zeros(n + 1, dtype=np.int64)
    order = np.argsort(lows, kind="stable")
    sigmas[1:] = order + 1
    omegas = np.zeros(n + 1, dtype=np.int64)
    nodes: list[list[int]] = []

    def contained(x, idx):
        return lows[idx - 1] <= x <= highs[idx - 1]

    # iterative preorder construction (explicit stack; the reference
    # recurses, src/iit-write.c:199-258)
    root_slot = [-1]
    stack = [(1, n, root_slot, 0)]
    while stack:
        i, j, parent_slot, slot_pos = stack.pop()
        if i > j:
            continue
        # node_select (src/iit-write.c:169-196)
        r = j - (j - i) // 3
        k = lows[sigmas[r] - 1]
        while r < j and lows[sigmas[r + 1] - 1] == k:
            r += 1
        if not contained(k, sigmas[r]):
            while r > i and not contained(k, sigmas[r - 1]):
                r -= 1
            if not contained(k, sigmas[r]):
                r -= 1
        value = int(k)
        # partition contains/left-of (src/iit-write.c:216-245)
        q = r
        for lam in range(r, i - 1, -1):
            if contained(value, sigmas[lam]):
                omegas[q] = sigmas[lam]
                sigmas[lam] = 0
                q -= 1
        iota = i
        for lam in range(i, r + 1):
            if sigmas[lam] != 0:
                sigmas[iota] = sigmas[lam]
                iota += 1
        sigmas[q + 1:r + 1] = omegas[q + 1:r + 1]
        seg = omegas[q + 1:r + 1]
        omegas[q + 1:r + 1] = seg[np.argsort(highs[seg - 1], kind="stable")]
        node = [value, q + 1, r, -1, -1]
        my_index = len(nodes)
        nodes.append(node)
        parent_slot[slot_pos] = my_index
        # push right first so left is processed next (preorder index order:
        # the reference assigns indices via preorder Node_index then writes
        # preorder, so left subtree indices precede right subtree indices)
        # LIFO: left subtree is fully created (and numbered) before the
        # right one, so creation order == the reference's preorder
        # Node_index numbering (src/iit-write.c:262-268)
        stack.append((r + 1, j, node, 4))
        stack.append((i, q, node, 3))

    return sigmas, omegas, nodes


# ---------------------------------------------------------------------------


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

    # ---------------- construction ----------------

    @property
    def total_nintervals(self) -> int:
        return sum(len(d) for d in self.divdata)

    def cum_nintervals(self) -> list[int]:
        out = [0]
        for d in self.divdata:
            out.append(out[-1] + len(d))
        return out

    def div_index(self, divstring: str) -> int:
        try:
            return self.divs.index(divstring)
        except ValueError:
            return -1

    # ---------------- queries ----------------

    def get(self, divstring: str, x: int, y: int) -> np.ndarray:
        """1-based global indices of intervals in div overlapping [x, y],
        ascending (the reference's IIT_get with sortp=false,
        src/iit-read.c IIT_get)."""
        divno = self.div_index(divstring)
        if divno < 0:
            return np.zeros(0, dtype=np.int64)
        d = self.divdata[divno]
        hit = (d.lows <= y) & (d.highs >= x)
        base = self.cum_nintervals()[divno]
        return np.nonzero(hit)[0] + base + 1

    def get_typed(self, divstring: str, x: int, y: int, typeint: int):
        divno = self.div_index(divstring)
        if divno < 0:
            return np.zeros(0, dtype=np.int64)
        d = self.divdata[divno]
        hit = (d.lows <= y) & (d.highs >= x) & (d.types == typeint)
        base = self.cum_nintervals()[divno]
        return np.nonzero(hit)[0] + base + 1

    def find(self, label: str) -> np.ndarray:
        """1-based indices of records with this label (IIT_find)."""
        return np.asarray(
            [i + 1 for i, lab in enumerate(self.labels) if lab == label],
            dtype=np.int64)

    def interval(self, index: int):
        """(div, low, high, sign, typestring) for 1-based global index."""
        cum = self.cum_nintervals()
        divno = int(np.searchsorted(np.asarray(cum), index, side="left")) - 1
        d = self.divdata[divno]
        r = index - 1 - cum[divno]
        return (self.divs[divno], int(d.lows[r]), int(d.highs[r]),
                int(d.signs[r]), self.typestrings[int(d.types[r])])

    def typeint(self, typestring: str) -> int:
        try:
            return self.typestrings.index(typestring)
        except ValueError:
            return -1

    def header_line(self, index: int) -> str:
        """Reconstruct the FASTA-style header line (as iit_dump prints)."""
        div, low, high, sign, typestr = self.interval(index)
        parts = [">" + self.labels[index - 1]]
        if low == 0 and high == 0:
            return parts[0]
        coords = f"{high}..{low}" if sign < 0 else f"{low}..{high}"
        if div:
            coords = f"{div}:{coords}"
        parts.append(coords)
        if typestr:
            parts.append(typestr)
        line = " ".join(parts)
        roh = self.restofheaders[index - 1]
        if roh:
            line += " " + roh
        return line

    def dump(self, fh) -> None:
        """Text dump identical to the input FASTA (iit_dump)."""
        for index in range(1, self.total_nintervals + 1):
            fh.write(self.header_line(index) + "\n")
            fh.write(self.annotations[index - 1])

    # ---------------- binary write ----------------

    def write(self, path: str) -> None:
        if self.version == 1:
            self._write_univ(path)
        else:
            self._write_div(path, self.version)

    def _annot_stored(self, index0: int) -> bytes:
        """v5+ stored annotation: restofheader + '\\n' + annotation lines;
        '' if both empty (src/iit_store.c:596-636)."""
        roh = self.restofheaders[index0]
        ann = self.annotations[index0]
        if not roh and not ann:
            return b"\0"
        if roh:
            return (roh + "\n" + ann).encode() + b"\0"
        return ("\n" + ann).encode() + b"\0"

    def _annot_stored_v1(self, index0: int) -> bytes:
        # version 1 files written by iit_store also carry the leading '\n'
        # marker (observed in reference output); restofheader goes first
        return self._annot_stored(index0)

    def _labelorder(self) -> np.ndarray:
        labs = [lab.encode() for lab in self.labels]
        return np.argsort(np.asarray(labs, dtype=object), kind="stable").astype(np.int64)

    @staticmethod
    def _strings_block(strings: list[str], pad: bool = False):
        """Pointers + concatenated NUL-terminated strings; pad=True pads the
        final pointer and blob to a 4-byte multiple (the reference's
        PAD_STRINGS mode, used by the div-format writer only)."""
        pointers = [0]
        blobs = []
        for s in strings:
            b = s.encode() + b"\0"
            blobs.append(b)
            pointers.append(pointers[-1] + len(b))
        if pad:
            padded = (pointers[-1] + 3) & ~3
            blobs.append(b"\0" * (padded - pointers[-1]))
            pointers[-1] = padded
        return pointers, b"".join(blobs)

    def _write_univ(self, path: str) -> None:
        d = self.divdata[0]
        n = len(d)
        lows, highs = d.lows, d.highs
        sigmas, omegas, nodes = _build_fnodes(lows, highs)
        coord8 = bool(self.coords_8p or (n and int(highs.max()) > 0xFFFFFFFF))
        cfmt = "<Q" if coord8 else "<I"
        with open(path, "wb") as fp:
            w = fp.write
            w(_INT.pack(-n if coord8 else n))
            w(_INT.pack(len(self.typestrings)))
            w(_INT.pack(len(nodes)))
            w(sigmas.astype("<i4").tobytes())
            w(omegas.astype("<i4").tobytes())
            for value, a, b, li, ri in nodes:
                w(struct.pack(cfmt, value))
                w(struct.pack("<iiii", a, b, li, ri))
            for r in range(n):
                w(struct.pack(cfmt, int(lows[r])))
                w(struct.pack(cfmt, int(highs[r])))
                w(_INT.pack(int(d.types[r])))
            tp, tblob = self._strings_block(self.typestrings)
            w(np.asarray(tp, dtype="<u4").tobytes())
            w(tblob)
            w(self._labelorder().astype("<i4").tobytes())
            lp, lblob = self._strings_block(self.labels)
            w(np.asarray(lp, dtype="<u4").tobytes())
            w(lblob)
            annots = [self._annot_stored_v1(i) for i in range(n)]
            ap = np.cumsum([0] + [len(a) for a in annots])
            w(ap.astype("<u4").tobytes())
            w(b"".join(annots))

    def _write_div(self, path: str, version: int = 5) -> None:
        ndivs = len(self.divs)
        nintervals = [len(d) for d in self.divdata]
        cum_ni = self.cum_nintervals()
        trees = []
        for d in self.divdata:
            if len(d):
                alphas = np.zeros(len(d) + 1, dtype=np.int64)
                alphas[1:] = np.argsort(d.lows, kind="stable") + 1
                betas = np.zeros(len(d) + 1, dtype=np.int64)
                betas[1:] = np.argsort(d.highs, kind="stable") + 1
                sigmas, omegas, nodes = _build_fnodes(d.lows, d.highs)
            else:
                alphas = betas = sigmas = omegas = np.zeros(1, dtype=np.int64)
                nodes = []
            trees.append((alphas, betas, sigmas, omegas, nodes))
        nnodes = [len(t[4]) for t in trees]
        cum_nn = [0]
        for x in nnodes:
            cum_nn.append(cum_nn[-1] + x)

        with open(path, "wb") as fp:
            w = fp.write
            w(_INT.pack(0))
            w(_INT.pack(version))
            if version >= 5:
                w(_INT.pack(4))   # label pointer size
                w(_INT.pack(4))   # annot pointer size
            w(_INT.pack(self.total_nintervals))
            w(_INT.pack(len(self.typestrings)))
            w(_INT.pack(len(self.fieldstrings)))
            w(_INT.pack(ndivs))
            for x in nintervals:
                w(_INT.pack(x))
            for x in cum_ni:
                w(_INT.pack(x))
            for x in nnodes:
                w(_INT.pack(x))
            for x in cum_nn:
                w(_INT.pack(x))
            w(_INT.pack(self.divsort))
            dp, dblob = self._strings_block(self.divs, pad=True)
            w(np.asarray(dp, dtype="<u4").tobytes())
            w(dblob)
            for alphas, betas, sigmas, omegas, nodes in trees:
                w(alphas.astype("<i4").tobytes())
                w(betas.astype("<i4").tobytes())
                w(sigmas.astype("<i4").tobytes())
                w(omegas.astype("<i4").tobytes())
                for value, a, b, li, ri in nodes:
                    w(struct.pack("<Iiiii", value, a, b, li, ri))
            for d in self.divdata:
                for r in range(len(d)):
                    w(struct.pack("<IIii", int(d.lows[r]), int(d.highs[r]),
                                  int(d.signs[r]), int(d.types[r])))
            tp, tblob = self._strings_block(self.typestrings, pad=True)
            w(np.asarray(tp, dtype="<u4").tobytes())
            w(tblob)
            fpnt, fblob = self._strings_block(self.fieldstrings, pad=True)
            w(np.asarray(fpnt, dtype="<u4").tobytes())
            w(fblob)
            w(self._labelorder().astype("<i4").tobytes())
            lp, lblob = self._strings_block(self.labels, pad=True)
            w(np.asarray(lp, dtype="<u4").tobytes())
            w(lblob)
            annots = [self._annot_stored(i)
                      for i in range(self.total_nintervals)]
            ap = np.cumsum([0] + [len(a) for a in annots])
            padded = (int(ap[-1]) + 3) & ~3
            pad = padded - int(ap[-1])
            ap[-1] = padded
            w(ap.astype("<u4").tobytes())
            w(b"".join(annots) + b"\0" * pad)

    # ---------------- binary read ----------------

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


# ---------------------------------------------------------------------------
# iit_store-style builder from FASTA-format map input


@dataclass
class _Entry:
    label: str
    div: str
    start: int
    end: int
    typestr: str
    restofheader: str
    annotation: str


def parse_map_fasta(lines) -> list[_Entry]:
    """Parse iit_store FASTA-format input (src/iit_store.c:285-460):
    >label [div:]start..end [type] [rest of header]
    annotation lines...
    """
    entries: list[_Entry] = []
    cur: _Entry | None = None
    ann: list[str] = []
    for line in lines:
        line = line.rstrip("\n")
        if line.startswith(">"):
            if cur is not None:
                cur.annotation = "".join(a + "\n" for a in ann)
                entries.append(cur)
            ann = []
            parts = line[1:].split(None, 2)
            label = parts[0] if parts else ""
            div, start, end, typestr, roh = "", 0, 0, "", ""
            if len(parts) == 1:
                div = label
                start, end = 1, 0   # end assigned from annotation length
            else:
                coords = parts[1]
                if ":" in coords:
                    div, coords = coords.split(":", 1)
                ok, start, end = _parse_coords(coords)
                if not ok:
                    raise ValueError(f"cannot parse coords in line: {line}")
                if len(parts) == 3:
                    sub = parts[2].split(None, 1)
                    typestr = sub[0]
                    roh = sub[1] if len(sub) > 1 else ""
            cur = _Entry(label, div, start, end, typestr, roh, "")
        elif cur is not None:
            ann.append(line)
    if cur is not None:
        cur.annotation = "".join(a + "\n" for a in ann)
        entries.append(cur)
    # no-coordinate entries span 1..len(annotation)-1 (src/iit_store.c:610-618)
    for e in entries:
        if e.end == 0 and e.start == 1 and e.div == e.label:
            seqlen = sum(len(l) for l in e.annotation.split("\n"))
            e.start, e.end = (0, 0) if seqlen == 0 else (1, seqlen - 1)
    return entries


def _parse_coords(coords: str):
    if ".." in coords:
        a, _, b = coords.partition("..")
        try:
            return True, int(a), int(b)
        except ValueError:
            return False, 0, 0
    try:
        v = int(coords)
        return True, v, v
    except ValueError:
        return False, 0, 0


def build_iit(entries: list[_Entry], divsort: int = CHROM_SORT,
              version: int = 0) -> IIT:
    """Assemble an IIT from parsed entries, reproducing iit_store's
    version auto-selection (src/iit_store.c:1060-1100): no divs => v1."""
    divs_seen: list[str] = []
    for e in entries:
        if e.div not in divs_seen:
            divs_seen.append(e.div)
    has_proper_divs = any(d != "" for d in divs_seen)
    if version == 0:
        version = 5 if has_proper_divs else 1

    typestrings = [""]
    for e in entries:
        if e.typestr and e.typestr not in typestrings:
            typestrings.append(e.typestr)

    if version == 1:
        divs = [""]
        groups = {"": entries}
    else:
        if "" not in divs_seen:
            divs_seen.append("")
        divs = sort_divs(divs_seen, divsort)
        groups = {d: [e for e in entries if e.div == d] for d in divs}

    divdata, labels, annotations, rohs = [], [], [], []
    for d in divs:
        es = groups.get(d, [])
        for e in es:
            labels.append(e.label)
            annotations.append(e.annotation)
            rohs.append(e.restofheader)
        lows = np.asarray([min(e.start, e.end) for e in es], dtype=np.uint64)
        highs = np.asarray([max(e.start, e.end) for e in es], dtype=np.uint64)
        signs = np.asarray(
            [0 if e.start == e.end else (1 if e.start < e.end else -1)
             for e in es], dtype=np.int32)
        types = np.asarray(
            [typestrings.index(e.typestr) if e.typestr else 0 for e in es],
            dtype=np.int32)
        divdata.append(IITDiv(lows=lows, highs=highs, signs=signs,
                              types=types))
    return IIT(version=version, divs=divs, divdata=divdata,
               typestrings=typestrings, labels=labels,
               annotations=annotations, restofheaders=rohs, divsort=divsort)
