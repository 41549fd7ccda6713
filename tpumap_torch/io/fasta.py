"""FASTA/FASTQ readers (host input pipeline) and the read preprocessing
of the gsnap CLI: a copy of tpumap/io/fasta.py, whose FASTA reader parses
a block of text at a time (`read_fasta`) and yields the same records.

Replaces the reference's input layer (src/sequence.c for GMAP queries,
src/shortread.c for GSNAP FASTA/FASTQ) with a simple streaming parser.
gzip/bzip2 transparent decompression mirrors shortread.c's zlib/bzlib paths.
"""
from __future__ import annotations

import bz2
import contextlib
import gc
import gzip
import io
import os
from dataclasses import dataclass
from itertools import chain, repeat
from typing import Iterator

from tpumap_torch.utils.trace import count


@dataclass(slots=True)
class Record:
    accession: str
    description: str
    sequence: str
    quality: str | None = None

    @property
    def header(self) -> str:
        return f"{self.accession} {self.description}".rstrip()

    def __len__(self) -> int:
        return len(self.sequence)


def _open_text(path: str | os.PathLike | io.IOBase,
               read_files_command: str | None = None):
    if hasattr(path, "read"):
        return path
    path = os.fspath(path)
    if read_files_command:
        # src/shortread.c --read-files-command: input is the stdout of
        # `command path` (e.g. "zcat", "dx cat")
        import shlex
        import subprocess
        proc = subprocess.Popen(shlex.split(read_files_command) + [path],
                                stdout=subprocess.PIPE, text=True)
        return proc.stdout
    if path == "-":
        import sys
        return sys.stdin
    with open(path, "rb") as probe:
        magic = probe.read(3)
    if magic[:2] == b"\x1f\x8b":
        return io.TextIOWrapper(gzip.open(path, "rb"))
    if magic == b"BZh":
        return io.TextIOWrapper(bz2.open(path, "rb"))
    return open(path, "rt")


# characters a file is read in at a time; each block is carried on to
# its line end
_BLOCK = 1 << 22
# whitespace that str.strip() removes besides the space and the line end
_STRIPPED = "\r\t\x0b\x0c\x1c\x1d\x1e\x1f"


def read_fasta(path, read_files_command: str | None = None
               ) -> Iterator[Record]:
    """Records in file order. An in-memory text is one block, a file is
    read in blocks of _BLOCK characters; each block is parsed up to its
    last record start, the rest carried into the next. A block of
    single-line records parses in bulk (`_bulk_records`); from the first
    block that is not, the rest of the stream goes through the line loop
    (`_read_fasta_lines`), so every input yields that loop's records. A
    handle passed in is taken to end its lines at "\n" in the text it
    reads, as universal newlines and a default StringIO do."""
    fh = _open_text(path, read_files_command)
    size = -1 if isinstance(fh, io.StringIO) else _BLOCK
    carry = ""
    while True:
        block = fh.read(size)
        if block[-1:] not in ("\n", ""):
            block += fh.readline()
        text = carry + block
        end = size < 0 or not block
        # parse up to the last record start; the whole text at the end
        cut = len(text) if end else text.rfind("\n>") + 1
        with _gc_paused():
            recs = _bulk_records(text[:cut]) if cut else None
        if recs is None:
            # not single-line records, or one longer than the block
            yield from _read_fasta_lines(chain(io.StringIO(text), fh))
            return
        count("parse_bulk", len(recs))
        yield from recs
        if end:
            return
        carry = text[cut:]


@contextlib.contextmanager
def _gc_paused():
    """No cyclic collection while a block's records are built. Every
    object built is kept by the result, so a collection frees nothing,
    yet the records would set off a young collection every threshold's
    allocations (700 by default) and, through them, full collections of
    the process's heap; paused, the next allocation sets off one young
    collection. A caller that paused the collector keeps it paused.
    Never held across a yield."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def _bulk_records(text: str) -> list[Record] | None:
    """The records of text, complete records each of one header line and
    one sequence line, as the line loop reads them; None where text is
    not such a block or a line's whitespace would be stripped."""
    if text[:1] != ">" or not text.isascii():
        return None
    for c in _STRIPPED:
        if c in text:
            return None
    lines = text.split("\n")
    if not lines[-1]:
        lines.pop()
    k = len(lines) >> 1
    if len(lines) != 2 * k or text.count("\n>") != k - 1:
        return None
    heads = "\n".join(lines[0::2])
    ids = heads[1:].replace("\n>", "\n")
    if len(heads) - len(ids) != k:
        return None   # a header line lacks its ">"
    seqs = lines[1::2]
    if " " not in text:
        return list(map(Record, ids.split("\n"), repeat(""), seqs))
    parts = map(str.partition, map(str.strip, ids.split("\n")),
                repeat(" "))
    return [Record(acc, desc, seq) for (acc, _, desc), seq
            in zip(parts, map(str.strip, seqs))]


def _read_fasta_lines(lines) -> Iterator[Record]:
    """The line loop: any FASTA text, one line at a time."""
    acc, desc, chunks = None, "", []
    for line in lines:
        line = line.rstrip("\r\n")
        if line.startswith(">"):
            if acc is not None:
                count("parse_lines")
                yield Record(acc, desc, "".join(chunks))
            header = line[1:].strip()
            acc, _, desc = header.partition(" ")
            chunks = []
        elif line and acc is not None:
            chunks.append(line.strip())
    if acc is not None:
        count("parse_lines")
        yield Record(acc, desc, "".join(chunks))


def read_fastq(path) -> Iterator[Record]:
    fh = _open_text(path)
    while True:
        header = fh.readline()
        if not header:
            return
        header = header.rstrip("\r\n")
        if not header:
            continue
        if not header.startswith("@"):
            raise ValueError(f"bad FASTQ header: {header!r}")
        seq = fh.readline().rstrip("\r\n")
        plus = fh.readline()
        qual = fh.readline().rstrip("\r\n")
        if not plus.startswith("+"):
            raise ValueError("malformed FASTQ record")
        acc, _, desc = header[1:].partition(" ")
        yield Record(acc, desc, seq, qual)


def read_seqs(path, read_files_command: str | None = None
              ) -> Iterator[Record]:
    """Sniff FASTA vs FASTQ from the first non-blank character."""
    fh = _open_text(path, read_files_command)
    first = fh.read(1)
    while first and first in "\r\n \t":
        first = fh.read(1)
    # reopen: parsers want the full stream
    if hasattr(fh, "seek") and fh.seekable():
        fh.seek(0)
    else:
        # non-seekable (stdin/pipe): re-chain the consumed prefix
        fh = io.StringIO(first).__class__(first + fh.read()) if first else fh
    if first == "@":
        return read_fastq(fh)
    return read_fasta(fh)


@dataclass
class ReadOptions:
    """Input preprocessing knobs (src/shortread.c / src/gsnap.c input
    options): barcode/end trimming, FASTQ identifier field selection,
    chastity filtering, quality-score protocol."""
    barcode_length: int = 0        # --barcode-length
    endtrim_length: int = 0        # --endtrim-length
    fastq_id_start: int = 1        # --fastq-id-start (1-based field)
    fastq_id_end: int = 1          # --fastq-id-end
    filter_chastity: str = "off"   # off | either | both
    quality_shift: int = 0         # -j/--quality-print-shift
    quality_zero: int = 33         # -J/--quality-zero-score

    @property
    def active(self) -> bool:
        return (self.barcode_length > 0 or self.endtrim_length > 0
                or self.fastq_id_start != 1 or self.fastq_id_end != 1
                or self.quality_shift != 0)


def chastity_fail(rec: Record) -> bool:
    """True if the Illumina chastity field marks this read as filtered:
    description like '1:Y:0:CTTGTA' (src/shortread.c chastity parsing,
    gsnap --filter-chastity help text)."""
    field0 = rec.description.split(" ", 1)[0] if rec.description else ""
    parts = field0.split(":")
    return len(parts) >= 2 and parts[0].isdigit() and parts[1] == "Y"


def apply_read_options(rec: Record, opts: ReadOptions) -> Record:
    """Trim barcode/end, reselect the accession fields, shift quality."""
    if opts.fastq_id_start != 1 or opts.fastq_id_end != 1:
        fields = (rec.accession + " " + rec.description).split()
        lo, hi = opts.fastq_id_start - 1, opts.fastq_id_end
        if fields[lo:hi]:
            rec.accession = " ".join(fields[lo:hi])
            rec.description = ""
    seq, qual = rec.sequence, rec.quality
    if opts.barcode_length > 0:
        seq = seq[opts.barcode_length:]
        if qual:
            qual = qual[opts.barcode_length:]
    if opts.endtrim_length > 0:
        seq = seq[:-opts.endtrim_length] if opts.endtrim_length < len(seq) \
            else ""
        if qual:
            qual = qual[:len(seq)]
    if qual and opts.quality_shift:
        qual = "".join(chr(min(126, max(33, ord(c) + opts.quality_shift)))
                       for c in qual)
    rec.sequence, rec.quality = seq, qual
    return rec


def preprocess_reads(it: Iterator[Record],
                     opts: ReadOptions) -> Iterator[Record]:
    """Single-end preprocessing: chastity skip + per-read transforms."""
    for rec in it:
        # single-end: 'both' means the only end ('either' likewise)
        if opts.filter_chastity != "off" and chastity_fail(rec):
            continue
        yield apply_read_options(rec, opts) if opts.active else rec


def preprocess_pairs(it, opts: ReadOptions):
    """Paired preprocessing: chastity either/both semantics + transforms."""
    for r1, r2 in it:
        if opts.filter_chastity != "off":
            c1, c2 = chastity_fail(r1), chastity_fail(r2)
            if opts.filter_chastity == "either" and (c1 or c2):
                continue
            if opts.filter_chastity == "both" and c1 and c2:
                continue
        if opts.active:
            r1, r2 = apply_read_options(r1, opts), apply_read_options(r2, opts)
        yield r1, r2


def check_pair_names(r1: Record, r2: Record) -> bool:
    """Paired accessions must match after stripping /1, /2 (or .1/.2)
    suffixes (src/shortread.c Shortread_strip_subscripts)."""

    def base(acc: str) -> str:
        if len(acc) >= 2 and acc[-2] == "/" and acc[-1] in "12":
            return acc[:-2]
        return acc

    return base(r1.accession) == base(r2.accession)


def strip_adapters_pair(r1: Record, r2: Record,
                        min_overlap: int = 12) -> tuple[Record, Record]:
    """gsnap -a/--adapter-strip=paired (src/shortread.c chop_primers):
    detect paired-end read-through — the fragment is shorter than the
    read length, so each read runs into the other end's adapter — and
    trim both reads down to the fragment.

    Model: fragment F of length f; r1 = F[:L1] (+adapter if f < L1),
    rc(r2) = F[f-L2:f] (+adapter bases before, if f < L2). For each
    candidate f the overlap of r1 and rc(r2) in fragment coordinates is
    checked; the best high-identity overlap wins.
    """
    from tpumap_torch.utils import dna as _dna
    s1, s2 = r1.sequence, r2.sequence
    L1, L2 = len(s1), len(s2)
    if L1 < min_overlap or L2 < min_overlap:
        return r1, r2
    rc2 = _dna.revcomp(s2)
    best_f, best_score = None, 0
    for f in range(min_overlap, L1 + L2 - min_overlap + 1):
        lo, hi = max(0, f - L2), min(L1, f)
        ov = hi - lo
        if ov < min_overlap:
            continue
        a = s1[lo:hi]
        b = rc2[lo - (f - L2):hi - (f - L2)]
        mm = sum(1 for x, y in zip(a, b) if x != y)
        if mm > ov // 12:
            continue
        score = ov - 4 * mm
        if score > best_score:
            best_score, best_f = score, f
    if best_f is None or best_f >= max(L1, L2):
        return r1, r2          # no read-through evidence
    f = best_f
    if f < L1:
        r1.sequence = s1[:f]
        if r1.quality:
            r1.quality = r1.quality[:f]
    if f < L2:
        # read 2 sequences from the fragment's far end: its first f bases
        # are fragment, the rest adapter
        r2.sequence = s2[:f]
        if r2.quality:
            r2.quality = r2.quality[:f]
    return r1, r2
