"""Data-parallel execution of the full GSNAP and GMAP pipelines over a
device grid (port of tpumap/parallel/pipeline.py).

tpumap's MeshContext hands the host drivers' device calls (the cascade,
the fused ladder, the paired program, the staged chain solver, GMAP's
chain stage) to a jax Mesh: batch rows shard along `data`, the index is
replicated, and GSPMD places every stage, so the mesh runs the same
global program as one chip and writes the same SAM. The port keeps that
contract with plain torch. The drivers call the same five methods; the
context runs each row-independent stage over contiguous row chunks, one
chunk a data device with that device's copy of the index (RowSplit),
while every batch-wide compaction (the prevalent rung's stage-2 rows,
the ladder's `_ranked` top-ks, the traceback's second compaction) ranks
the whole batch once on the lead device. The chosen rows are therefore
those one device chooses, at any overflow. Rows that do not divide the
data axis run whole on the lead device, as tpumap's _put_rows
replicates them.

One host thread issues the chunks in turn. Where a chunk's function
reads a device value on the host (a size taken from data, a compaction
count), the next device's launches wait for that read. A host thread a
device was slower on four H100s: each torch op hands the GIL round.

For indexes too big for one device, parallel/sharded.py (oligo-range
sharding) and parallel/large.py (genome windows) remain the paths.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from tpumap_torch.gsnap import ladder
from tpumap_torch.gsnap.engine import align_batch_cascaded_packed
from tpumap_torch.index.build import GenomeDB
from tpumap_torch.index.device import DeviceIndex
from tpumap_torch.ops import pathdp


def _device_scope(device: torch.device):
    """Make `device` current for the kernels launched inside."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _nrows(args) -> int:
    for a in args:
        if isinstance(a, dict):
            return _nrows(list(a.values()))
        if isinstance(a, torch.Tensor):
            return a.shape[0]
    raise ValueError("RowSplit.map: no row tensor among the arguments")


def _take(a, lo: int, hi: int, device):
    if a is None:
        return None
    if isinstance(a, dict):
        return {k: _take(v, lo, hi, device) for k, v in a.items()}
    return a[lo:hi].to(device)


def _cat(parts: list, device):
    first = parts[0]
    if isinstance(first, dict):
        return {k: _cat([p[k] for p in parts], device) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_cat([p[i] for p in parts], device)
                           for i in range(len(first)))
    if first.ndim == 0:
        raise TypeError("RowSplit.map: a scalar result has no rows")
    return torch.cat([p.to(device) for p in parts])


def to_device(tree, device):
    """A tensor, numpy array or dict of them (None passes) on device."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree).to(device)


class RowSplit:
    """Runs a row-independent function over contiguous chunks of its row
    arguments, chunk i on data device i with that device's index, and
    concatenates the results on the lead device (the first)."""

    def __init__(self, devices: list, indexes: dict):
        self.devices = list(devices)
        self.indexes = indexes          # device -> DeviceIndex
        self.lead = self.devices[0]
        # calls split into chunks, calls run whole on the lead device
        self.split = 0
        self.whole = 0

    def map(self, fn, *args):
        """fn(index, *chunks) per chunk; args are tensors, dicts of
        tensors or None with one leading row dimension. Row counts that
        do not divide the devices (or none) run whole on the lead
        device."""
        R = _nrows(args)
        nd = len(self.devices)
        if nd == 1 or R % nd or not R:
            self.whole += 1
            return fn(self.indexes[self.lead], *args)
        self.split += 1
        n = R // nd
        parts = []
        for i, d in enumerate(self.devices):
            chunk = [_take(a, i * n, (i + 1) * n, d) for a in args]
            with _device_scope(d):
                parts.append(fn(self.indexes[d], *chunk))
        return _cat(parts, self.lead)


class MeshContext:
    """Run the production cascade, fused ladder, paired program, chain
    solver and GMAP chain stage data-parallel over a DeviceMesh.

    Batch rows split along the `data` axis (the first device of each
    data row works; replicas along `index` stay idle, as tpumap's
    replicas compute the same values); the index goes once to each
    distinct device. Results come back on the lead device (`device`),
    equal to the single-device call's. Construction places the index.
    """

    def __init__(self, mesh, db: GenomeDB):
        self.mesh = mesh
        devices = mesh.data_devices()
        self.indexes = {d: DeviceIndex.from_host(db, d)
                        for d in mesh.distinct(devices)}
        self.device = devices[0]
        self.index = self.indexes[self.device]
        self.rows = RowSplit(devices, self.indexes)

    def _lead(self, tree):
        return to_device(tree, self.device)

    def cascade(self, index, pbatch, config, L):
        return align_batch_cascaded_packed(self.index, self._lead(pbatch),
                                           config, L, rows=self.rows)

    def chain_solve(self, index, codes, nmask, lengths, diags, **kw):
        quals = kw.pop("quals", None)
        known = kw.pop("known", None)
        return self.rows.map(
            lambda ix, c, m, ln, d, q: pathdp.chain_solve(
                ix, c, m, ln, d, quals=q, known=ladder._on(known, ix.device),
                **kw),
            *(self._lead(a) for a in (codes, nmask, lengths, diags, quals)))

    def ladder_full(self, pbatch, config, L, scoring, splicing, salvage,
                    r_chain, r_salv, r_indel, known=None):
        """The fused ladder: every row-independent stage over row chunks,
        every compaction ranked once over the whole batch."""
        return ladder.align_batch_full(
            self.index, self._lead(pbatch), config, L, scoring, splicing,
            salvage, r_chain, r_salv, r_indel,
            known=ladder._on(known, self.device), rows=self.rows)

    def pair_full(self, pbatch, config, L, scoring, splicing, salvage,
                  r_chain, r_salv, r_indel, pairmax, orientation,
                  pairexpect, pairdev, known=None):
        return ladder.align_pair_full(
            self.index, self._lead(pbatch), config, L, scoring, splicing,
            salvage, r_chain, r_salv, r_indel, pairmax, orientation,
            pairexpect, pairdev, known=ladder._on(known, self.device),
            rows=self.rows)

    def gmap_windows(self, qc, qv, ws, wl, sp, Rp, config):
        """GMAP's chain stage on the grid: window rows split along
        `data`, the genome on each device (reference gmap spreads the
        same work over a worker pool, src/gmap.c:4867). Groups pad up to
        a multiple of the data axis, as tpumap's do; the padding rows
        are cut from the result."""
        from tpumap_torch.gmap.engine import _chain_pipeline_windows
        nd = len(self.rows.devices)
        N = qc.shape[0]
        pad = (-N) % nd
        if pad:
            qc = np.concatenate([qc, np.zeros((pad, qc.shape[1]),
                                              qc.dtype)])
            qv = np.concatenate([qv, np.zeros((pad, qv.shape[1]),
                                              qv.dtype)])
            ws = np.concatenate([ws, np.zeros(pad, ws.dtype)])
            wl = np.concatenate([wl, np.ones(pad, wl.dtype)])
            sp = np.concatenate([sp, np.zeros(pad, sp.dtype)])
        out = self.rows.map(
            lambda ix, *a: _chain_pipeline_windows(
                ix.genome_packed, ix.genome_nmask, *a, Rp, config),
            *(self._lead(a) for a in (qc, qv, ws, wl, sp)))
        return tuple(t[:N] for t in out)
