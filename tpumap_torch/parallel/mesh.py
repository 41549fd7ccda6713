"""Device grid construction (port of tpumap/parallel/mesh.py).

tpumap's sharded paths are single-controller programs over a 2-D
(data, index) jax Mesh: read batches shard along `data` and, for indexes
too large for one chip, the k-mer index (or the genome) shards along
`index`. The port's counterpart is one process driving a grid of
torch.devices: each collective of tpumap's becomes explicit tensor moves
and torch.cat in tpumap's order. Devices may repeat ([cuda:0] * 4 on a
one-card machine, cpu * 8 in the tests); shards that share a device run
on it in turn. Nothing falls back: a device that cannot be reached
raises where a tensor is first moved to it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

DATA_AXIS = "data"
INDEX_AXIS = "index"


@dataclass(frozen=True)
class DeviceMesh:
    """A [data, index] grid of torch.devices."""
    grid: tuple                   # tuple of rows, each a tuple of devices

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: len(self.grid), INDEX_AXIS: len(self.grid[0])}

    @property
    def devices(self) -> list:
        """Every device of the grid, row-major."""
        return [d for row in self.grid for d in row]

    def distinct(self, devices=None) -> list:
        """The distinct devices among `devices` (default: the grid), in
        first-seen order: where one copy of a replicated array lives."""
        out = []
        for d in self.devices if devices is None else devices:
            if d not in out:
                out.append(d)
        return out

    def data_devices(self) -> list:
        """The first device of each data row: where a data shard's work
        runs when the index axis holds replicas."""
        return [row[0] for row in self.grid]

    def column(self, j: int) -> list:
        """The devices of index shard j."""
        return [row[j] for row in self.grid]


def make_mesh(n_devices: int | None = None, index_shards: int = 1,
              devices=None) -> DeviceMesh:
    """A (data, index) grid over the first n_devices devices: by default
    every visible CUDA device; raises where there is none and no
    `devices` were passed."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device; pass devices=[...] (e.g. "
                "[torch.device('cpu')] * 8) to run on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"{n_devices} devices asked for, "
                         f"{len(devices)} given")
    devices = devices[:n_devices]
    if n_devices % index_shards:
        raise ValueError(f"{n_devices} devices not divisible by "
                         f"index_shards={index_shards}")
    rows = n_devices // index_shards
    return DeviceMesh(tuple(tuple(devices[i * index_shards:
                                          (i + 1) * index_shards])
                            for i in range(rows)))


def batch_sharding(mesh: DeviceMesh, rows):
    """Split row tensors along the data axis (tpumap's P(DATA_AXIS)):
    one contiguous chunk per data row, on its first device. rows: a
    tensor or a dict of tensors with a leading batch dimension, which
    must divide by the data axis."""
    nd = mesh.shape[DATA_AXIS]
    devs = mesh.data_devices()
    if isinstance(rows, dict):
        parts = {k: batch_sharding(mesh, v) for k, v in rows.items()}
        return [{k: parts[k][i] for k in rows} for i in range(nd)]
    rows = torch.as_tensor(rows)
    if rows.shape[0] % nd:
        raise ValueError(f"{rows.shape[0]} rows not divisible by the data "
                         f"axis ({nd})")
    n = rows.shape[0] // nd
    return [rows[i * n:(i + 1) * n].to(d) for i, d in enumerate(devs)]


def replicated(mesh: DeviceMesh, array, devices=None) -> dict:
    """One copy of `array` (numpy or tensor) per distinct device of the
    grid (or of `devices`): {device: tensor}."""
    t = torch.as_tensor(array)
    return {d: t.to(d) for d in mesh.distinct(devices)}
