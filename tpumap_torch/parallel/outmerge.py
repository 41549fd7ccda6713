"""Ordered output merge (gsnap --ordered with --part): the port's copy of
tpumap/parallel/outmerge.py, its single-process part.

The reference prints in input order from ONE process via
Outbuffer_thread_ordered (src/outbuffer.c:1387). Every output chunk is
recorded with its global input ordinal (the --part modular sharding
inverse), and finalize writes them in ordinal order, byte-identical to
an unsharded run, including --split-output category routing. In one
process that is a local pass-through, as in tpumap. The gather across
processes (torch.distributed) is ROADMAP item 15: finalize raises where
a process group of more than one process is initialised.
"""
from __future__ import annotations

class _MergeFile:
    """File-like that records (ordinal, category, text) chunks."""

    def __init__(self, merge: "OrderedMerge", cat: str | None):
        self._merge = merge
        self._cat = cat

    def write(self, text: str) -> int:
        self._merge._chunks.append((self._merge.cur, self._cat, text))
        return len(text)

    def flush(self) -> None:
        pass


class OrderedMerge:
    """Collects output chunks keyed by global input ordinal.

    Usage in a CLI write loop::

        merge = OrderedMerge(part)          # part = (pid, nproc)
        for rec, s in merge.iter(zip(records, results)):
            ...router/file writes go to merge-wrapped sinks...
        merge.finalize(writer)              # writer(cat, text) on proc 0

    iter() sets the current global ordinal (local j -> j*n + p, the
    --part modular sharding inverse) so every chunk written while an
    item is being processed is tagged with that item's input position.
    Chunks written before iteration starts (headers) carry ordinal -1
    and are emitted first, only from process 0's copy.
    """

    def __init__(self, part: tuple[int, int]):
        self.p, self.n = part
        self.cur = -1
        self._chunks: list[tuple[int, str | None, str]] = []

    def iter(self, items):
        for j, item in enumerate(items):
            self.cur = j * self.n + self.p
            yield item
        self.cur = -1

    def file(self, cat: str | None = None) -> _MergeFile:
        return _MergeFile(self, cat)

    def finalize(self, write) -> bool:
        """Call write(cat, text) for every chunk in global input order
        and return True (this process writes the merged stream)."""
        if _nprocs() > 1:
            raise NotImplementedError(
                "--ordered across processes needs the output gather of "
                "ROADMAP item 15 (multi-GPU), not yet ported")
        for _o, c, t in sorted(self._chunks, key=lambda x: x[0]):
            write(c, t)
        return True


def _nprocs() -> int:
    """Processes of the torch.distributed group (1 where none is
    initialised)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


class MergeRouter:
    """OutputRouter stand-in that records category-tagged chunks."""

    def __init__(self, merge: OrderedMerge):
        self._m = merge
        self._files: dict = {}

    def get(self, cat):
        return self._files.setdefault(cat, self._m.file(cat))

    def close(self) -> None:
        pass
