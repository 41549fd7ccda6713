"""FASTA/FASTQ readers (host input pipeline; the readers of
tpumap/io/fasta.py).

Replaces the reference's input layer (src/sequence.c for GMAP queries,
src/shortread.c for GSNAP FASTA/FASTQ) with a simple streaming parser.
gzip/bzip2 transparent decompression mirrors shortread.c's zlib/bzlib paths.
"""
from __future__ import annotations

import bz2
import gzip
import io
import os
from dataclasses import dataclass, field
from typing import Iterator


@dataclass
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


def read_fasta(path, read_files_command: str | None = None
               ) -> Iterator[Record]:
    fh = _open_text(path, read_files_command)
    acc, desc, chunks = None, "", []
    for line in fh:
        line = line.rstrip("\r\n")
        if line.startswith(">"):
            if acc is not None:
                yield Record(acc, desc, "".join(chunks))
            header = line[1:].strip()
            acc, _, desc = header.partition(" ")
            chunks = []
        elif line and acc is not None:
            chunks.append(line.strip())
    if acc is not None:
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
