"""The timed path: chunks of FASTA text from the producer processes,
parsed by the port's own reader and aligned by align_records or
align_paired_records with the SAM streamed to an in-memory sink, as the
gsnap CLI runs over a file. Also the host spans of the traced run."""
from __future__ import annotations

import contextlib
import importlib
import io
import struct
import subprocess
import sys
import threading
import time

import numpy as np

from harness import traffic

PRODUCERS = 2


class ChunkSource:
    """Chunk c comes from producer c % PRODUCERS, each a process of its
    own writing to a pipe; a producer runs at most one chunk ahead."""

    def __init__(self, producer_py, cfg_path, mix_path, seed: int,
                 blocks: int, block: int):
        self.procs = [subprocess.Popen(
            [sys.executable, str(producer_py), str(cfg_path), str(mix_path),
             str(seed), str(i), str(PRODUCERS), str(blocks), str(block)],
            stdout=subprocess.PIPE, stdin=subprocess.DEVNULL)
            for i in range(PRODUCERS)]
        self.next_chunk = 0

    def get(self) -> tuple:
        p = self.procs[self.next_chunk % PRODUCERS]
        self.next_chunk += 1
        head = p.stdout.read(16)
        if len(head) != 16:
            raise RuntimeError(f"producer ended (exit {p.poll()})")
        n1, n2 = struct.unpack("<QQ", head)
        return p.stdout.read(n1), p.stdout.read(n2)

    def close(self) -> None:
        for p in self.procs:
            p.stdout.close()
            p.terminate()
        for p in self.procs:
            p.wait(timeout=30)


class Spans:
    """Self time of named host spans (a span's time less that of the
    spans opened inside it), on the host's clock alone. With intervals,
    also each span's (start, end, name) in perf_counter_ns."""

    def __init__(self, intervals: bool = False):
        self.self_s = {}
        self.calls = {}
        self.stack = []
        self.intervals = [] if intervals else None

    @contextlib.contextmanager
    def span(self, name: str):
        self.stack.append(0)
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            dt = t1 - t0
            inner = self.stack.pop()
            if self.stack:
                self.stack[-1] += dt
            self.self_s[name] = self.self_s.get(name, 0.0) + (dt - inner) / 1e9
            self.calls[name] = self.calls.get(name, 0) + 1
            if self.intervals is not None:
                self.intervals.append((t0, t1, name))

    def wrap(self, name: str, fn):
        def wrapped(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)
        return wrapped


@contextlib.contextmanager
def patched(targets):
    """Replace module attributes [(module name, attribute, new)] for the
    duration."""
    saved = []
    try:
        for modname, attr, new in targets:
            mod = importlib.import_module(modname)
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, new(getattr(mod, attr)))
        yield
    finally:
        for mod, attr, old in reversed(saved):
            setattr(mod, attr, old)


class Sink:
    """Counts the SAM bytes and keeps the texts of the chunks the
    comparison samples from; writes nothing to disk."""

    def __init__(self):
        self.nbytes = 0
        self.keep = None

    def __call__(self, b: bytes) -> None:
        self.nbytes += len(b)
        if self.keep is not None:
            self.keep.append(b)


class Aligner:
    """One chunk through the port: parse, align, stream the SAM."""

    def __init__(self, cfg: dict, mix: dict, db, index, spans=None):
        from tpumap_torch.gsnap.engine import AlignConfig
        self.cfg, self.db, self.index = cfg, db, index
        self.pairs = "pairs" in mix
        self.align = AlignConfig(**cfg["align"])
        self.spans = spans

    def _span(self, name):
        return (self.spans.span(name) if self.spans is not None
                else contextlib.nullcontext())

    def __call__(self, t1: bytes, t2: bytes, sink) -> int:
        from tpumap_torch.gsnap.driver import align_records
        from tpumap_torch.gsnap.paired import align_paired_records
        from tpumap_torch.io.fasta import read_seqs
        cfg = self.cfg
        with self._span("parse_ms"):
            r1 = list(read_seqs(io.StringIO(t1.decode("ascii"))))
            r2 = (list(read_seqs(io.StringIO(t2.decode("ascii"))))
                  if self.pairs else None)
        with self._span("align"):
            if self.pairs:
                align_paired_records(
                    self.db, self.index, list(zip(r1, r2)), self.align,
                    pairmax=cfg["pairmax"], batch_size=cfg["pair_batch_size"],
                    novelsplicing=cfg["novelsplicing"],
                    max_intron=cfg["max_intron"], sink=sink)
                return 2 * len(r1)
            align_records(self.db, self.index, r1, self.align,
                          novelsplicing=cfg["novelsplicing"],
                          max_intron=cfg["max_intron"],
                          batch_size=cfg["batch_size"], sink=sink)
            return len(r1)


# the window's first chunk: chunk 0 is the set-up's warm-up
FIRST_CHUNK = 1


def kept_chunks(seed: int, first: int, upto: int) -> set:
    """The window's chunks whose SAM the comparison may sample, drawn
    from the seed: a quarter of them, and always one of the first two."""
    rng = traffic.block_rng(seed, 0, salt=99)
    draws = rng.random(upto)
    keep = {c for c in range(first, upto) if draws[c] < 0.25}
    keep.add(first + int(rng.integers(0, 2)))
    return keep


def run_window(source: ChunkSource, aligner: Aligner, seconds: float,
               seed: int, spans=None, sync=lambda: None,
               max_chunks: int = 1 << 16) -> dict:
    """Chunks until `seconds` have passed (the chunk under way then is
    finished and counted). Returns the reads aligned, the seconds from
    the window's start to the last chunk's end, the chunks, the SAM bytes
    and the kept chunks' SAM texts; and, for the log, the main thread's
    CPU seconds over the window and its seconds waiting for a core."""
    first = source.next_chunk
    keep = kept_chunks(seed, first, first + max_chunks)
    sink = Sink()
    kept = {}
    reads = 0
    wait = spans.span if spans is not None else \
        (lambda _n: contextlib.nullcontext())
    cpu0, wait0 = time.thread_time(), _run_delay_s()
    t0 = time.perf_counter()
    ends = []
    while True:
        c = source.next_chunk
        with wait("input_wait_ms"):
            t1, t2 = source.get()
        sink.keep = [] if c in keep else None
        reads += aligner(t1, t2, sink)
        if sink.keep is not None:
            kept[c] = b"".join(sink.keep)
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    sync()
    elapsed = time.perf_counter() - t0
    cpu = time.thread_time() - cpu0
    wait1 = _run_delay_s()
    return {"reads": reads, "seconds": elapsed, "cpu_s": cpu,
            "run_delay_s": (wait1 - wait0) if wait0 is not None else None,
            "chunks": list(range(first, source.next_chunk)),
            "sam_bytes": sink.nbytes, "kept": kept,
            "chunk_s": np.diff([0.0] + ends).tolist()}


def _run_delay_s():
    """The main thread's seconds spent waiting for a core (Linux
    schedstat), or None where it cannot be read."""
    try:
        with open(f"/proc/self/task/{threading.get_native_id()}/schedstat"
                  ) as f:
            return int(f.read().split()[1]) / 1e9
    except (OSError, ValueError, IndexError):
        return None


def sample_blocks(seed: int, kept: dict, blocks_per_chunk: int,
                  n: int = 2) -> list:
    """The blocks the comparison judges, drawn from the seed among the
    kept chunks': n blocks, from different chunks where there are
    several."""
    rng = traffic.block_rng(seed, 0, salt=98)
    chunks = sorted(kept)
    picks = rng.choice(len(chunks), size=min(n, len(chunks)), replace=False)
    out = []
    for i in sorted(picks.tolist()):
        c = chunks[i]
        out.append(c * blocks_per_chunk + int(rng.integers(0,
                                                           blocks_per_chunk)))
    while len(out) < n:
        c = chunks[0]
        b = c * blocks_per_chunk + int(rng.integers(0, blocks_per_chunk))
        if b not in out:
            out.append(b)
    return out
