"""Native (C++) host components of the port, loaded with ctypes: the
FASTQ/FASTA tokenizer and batch encoder (fastq_tokenizer.cc) and the bulk
SAM emitters (sam_emit.cc), copies of tpumap/native's sources.

The library builds with g++ at first use into tpumap_torch/_build/, keyed
by a hash of the sources. `get_lib` returns None only where g++ is
absent, and then says so once on stderr; a failed build or load raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import sys

_DIR = pathlib.Path(__file__).resolve().parent
_SRCS = [_DIR / "fastq_tokenizer.cc", _DIR / "sam_emit.cc"]
_BUILD = _DIR.parent / "_build"

_lib = None
_tried = False


def _build() -> pathlib.Path:
    """Compile the sources (if their hash is new); the library's path."""
    h = hashlib.sha256()
    for s in _SRCS:
        h.update(s.read_bytes())
    out = _BUILD / f"native-{h.hexdigest()[:16]}" / "libtpumap_torch_native.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        r = subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                            "-o", str(tmp)] + [str(s) for s in _SRCS],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed ({r.returncode}) on the native "
                               f"host library:\n{r.stdout}{r.stderr}")
        os.replace(tmp, out)
    return out


def get_lib():
    """The native library, building it if needed; None (said once on
    stderr) only where g++ is absent."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if shutil.which("g++") is None:
        sys.stderr.write("tpumap_torch: g++ not found, the native host "
                         "library is unavailable; using the Python "
                         "encoder and SAM records\n")
        return None
    lib = ctypes.CDLL(str(_build()))
    c_long_p = ctypes.POINTER(ctypes.c_long)
    lib.fastq_scan.restype = ctypes.c_long
    lib.fastq_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        c_long_p, c_long_p, c_long_p, c_long_p, c_long_p,
        ctypes.c_long]
    lib.fasta_scan.restype = ctypes.c_long
    lib.fasta_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        c_long_p, c_long_p, c_long_p, c_long_p, c_long_p,
        ctypes.c_long, ctypes.c_long]
    lib.md_nm.restype = ctypes.c_long
    lib.md_nm.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                          ctypes.c_long, ctypes.c_char_p]
    lib.genome_text.restype = None
    lib.genome_text.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_long, ctypes.c_long, ctypes.c_char_p]
    lib.encode_records.restype = None
    lib.encode_records.argtypes = [
        ctypes.c_char_p, c_long_p, c_long_p, ctypes.c_long,
        ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32)]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.encode_packed_batch.restype = ctypes.c_long
    lib.encode_packed_batch.argtypes = [
        ctypes.c_char_p, c_long_p, c_long_p, ctypes.c_long,
        ctypes.c_char_p, c_long_p, u8p,
        ctypes.c_long, ctypes.c_long,
        u8p, u8p, i32p, u32p, u32p, u8p]
    lib.anchor_runs.restype = None
    lib.anchor_runs.argtypes = [
        u32p, ctypes.c_long, u64p, u8p, ctypes.c_long, i32p,
        ctypes.c_long, ctypes.c_long, i32p, i32p]
    lib.sam_emit_ungapped.restype = ctypes.c_long
    lib.sam_emit_ungapped.argtypes = [
        u32p, u32p,                          # genome packed/nmask
        u64p, i64p, u8p, ctypes.c_long,      # chrom table
        ctypes.c_char_p, i64p,               # rname blob/off
        ctypes.c_char_p, i64p,               # qname blob/off
        u8p, u8p, ctypes.c_long,             # codes/rnmask/Lstride
        ctypes.c_char_p, i64p,               # qual blob/off
        i32p, u64p, u8p, u8p, i32p,          # len/diag/strand/mapq/nbest
        i32p, i32p,                          # qstart/qend
        i32p, u64p, i64p,                    # flags/mate_u/tlen (paired)
        u8p, ctypes.c_long,                  # emit mask, B
        ctypes.c_char_p, ctypes.c_long, i64p]
    lib.sam_emit_mixed.restype = ctypes.c_long
    lib.sam_emit_mixed.argtypes = [
        u32p, u32p,                          # genome packed/nmask
        u64p, i64p, u8p, ctypes.c_long,      # chrom table
        ctypes.c_char_p, i64p,               # rname blob/off
        ctypes.c_char_p, i64p,               # qname blob/off
        u8p, u8p, ctypes.c_long,             # codes/rnmask/Lstride
        ctypes.c_char_p, i64p,               # qual blob/off
        i32p, u8p,                           # lengths, kind
        u64p, u8p, u8p, i32p,                # diag/strand/mapq/nbest
        i32p, i32p,                          # qstart/qend
        i32p, u64p, i64p,                    # flags/mate_u/tlen
        i64p, i32p, u64p,                    # seg_off/seg_q/seg_d
        ctypes.c_long, ctypes.c_long,        # min_intron, B
        ctypes.c_char_p, ctypes.c_long, i64p]
    _lib = lib
    return lib
