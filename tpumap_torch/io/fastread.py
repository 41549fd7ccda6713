"""Fast batched read loading: the native tokenizer front-end (port of
tpumap/io/fastread.py).

load_reads_arrays(path, max_len) parses a FASTA/FASTQ file straight into
the [N, L] code/nmask/length arrays the device pipeline consumes, with
the port's C++ tokenizer (tpumap_torch/native). It raises where that
library cannot be had. The Python readers serve gzip/bzip2 input (the
tokenizer reads plain text) and files the tokenizer rejects as
malformed: tpumap's rules about the input, not a fallback on the
environment.
"""
from __future__ import annotations

import ctypes

import numpy as np

from tpumap_torch.io.fasta import read_seqs
from tpumap_torch.utils import dna


def _as_long_p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_long))


def load_reads_arrays(path: str, max_len: int | None = None):
    """(names, quals, batch) for a whole FASTA/FASTQ file.

    batch = {"codes" uint8[N, L], "nmask" bool[N, L], "lengths" int32[N]}.
    quals is None for FASTA. Decompresses gz/bz2 via the Python path.
    """
    from tpumap_torch.native import get_lib

    lib = get_lib()
    if lib is None:
        raise RuntimeError("load_reads_arrays: the native tokenizer is "
                           "unavailable (g++ not found)")
    with open(path, "rb") as f:
        head = f.read(3)
    raw = None
    if head[:2] != b"\x1f\x8b" and head != b"BZh":
        with open(path, "rb") as f:
            raw = f.read()

    # compressed (or empty) input: the Python readers decompress it
    if raw is None or not raw:
        return _python_fallback(path, max_len)

    n = len(raw)
    first = raw.lstrip(b"\r\n \t")[:1]
    if first == b"@":
        max_records = raw.count(b"\n") // 4 + 2
        ns = np.zeros(max_records, dtype=np.int64)
        nl = np.zeros(max_records, dtype=np.int64)
        ss = np.zeros(max_records, dtype=np.int64)
        sl = np.zeros(max_records, dtype=np.int64)
        qs = np.zeros(max_records, dtype=np.int64)
        nrec = lib.fastq_scan(raw, n, _as_long_p(ns), _as_long_p(nl),
                              _as_long_p(ss), _as_long_p(sl),
                              _as_long_p(qs), max_records)
        if nrec < 0:
            # the tokenizer rejects a malformed file; tpumap reads it
            # with the Python reader, which reports or skips what it can
            return _python_fallback(path, max_len)
        ns, nl, ss, sl, qs = (a[:nrec] for a in (ns, nl, ss, sl, qs))
        L = int(max_len or (sl.max() if nrec else 0))
        codes = np.zeros((nrec, L), dtype=np.uint8)
        nmask = np.zeros((nrec, L), dtype=np.uint8)
        lengths = np.zeros(nrec, dtype=np.int32)
        lib.encode_records(
            raw, _as_long_p(np.ascontiguousarray(ss)),
            _as_long_p(np.ascontiguousarray(sl)), nrec, L,
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            nmask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        names = [raw[ns[i]:ns[i] + nl[i]].decode() for i in range(nrec)]
        quals = [raw[qs[i]:qs[i] + sl[i]].decode() for i in range(nrec)]
        return names, quals, {"codes": codes, "nmask": nmask.astype(bool),
                              "lengths": lengths}

    if first == b">":
        max_records = raw.count(b">") + 1
        max_chunks = raw.count(b"\n") + 1
        ns = np.zeros(max_records, dtype=np.int64)
        nl = np.zeros(max_records, dtype=np.int64)
        cs = np.zeros(max_chunks, dtype=np.int64)
        cl = np.zeros(max_chunks, dtype=np.int64)
        nc = np.zeros(max_records, dtype=np.int64)
        nrec = lib.fasta_scan(raw, n, _as_long_p(ns), _as_long_p(nl),
                              _as_long_p(cs), _as_long_p(cl),
                              _as_long_p(nc), max_records, max_chunks)
        if nrec < 0:
            # a malformed file, as above
            return _python_fallback(path, max_len)
        # single-line FASTA is the common case: encode spans directly;
        # multi-line records go through a join
        names, seq_spans = [], []
        ci = 0
        joined_parts = []
        starts = np.zeros(nrec, dtype=np.int64)
        lens = np.zeros(nrec, dtype=np.int64)
        multi = bool((nc[:nrec] > 1).any())
        if multi:
            buf_parts = []
            off = 0
            for r in range(nrec):
                parts = [raw[cs[ci + j]:cs[ci + j] + cl[ci + j]]
                         for j in range(int(nc[r]))]
                ci += int(nc[r])
                joined = b"".join(parts)
                buf_parts.append(joined)
                starts[r] = off
                lens[r] = len(joined)
                off += len(joined)
            raw2 = b"".join(buf_parts)
        else:
            raw2 = raw
            for r in range(nrec):
                starts[r] = cs[ci]
                lens[r] = cl[ci]
                ci += int(nc[r])
        L = int(max_len or (lens.max() if nrec else 0))
        codes = np.zeros((nrec, L), dtype=np.uint8)
        nmask = np.zeros((nrec, L), dtype=np.uint8)
        lengths = np.zeros(nrec, dtype=np.int32)
        lib.encode_records(
            raw2, _as_long_p(starts), _as_long_p(lens), nrec, L,
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            nmask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        names = [raw[ns[i]:ns[i] + nl[i]].decode() for i in range(nrec)]
        return names, None, {"codes": codes, "nmask": nmask.astype(bool),
                             "lengths": lengths}

    return _python_fallback(path, max_len)


def _python_fallback(path, max_len):
    records = list(read_seqs(path))
    N = len(records)
    L = int(max_len or max((len(r.sequence) for r in records), default=0))
    codes = np.zeros((N, L), dtype=np.uint8)
    nmask = np.zeros((N, L), dtype=bool)
    lengths = np.zeros(N, dtype=np.int32)
    for i, r in enumerate(records):
        c, m = dna.encode(r.sequence[:L])
        codes[i, :len(c)] = c
        nmask[i, :len(c)] = m
        lengths[i] = len(c)
    names = [r.accession for r in records]
    quals = ([r.quality for r in records]
             if any(r.quality for r in records) else None)
    return names, quals, {"codes": codes, "nmask": nmask,
                          "lengths": lengths}
