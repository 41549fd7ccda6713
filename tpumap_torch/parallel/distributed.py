"""Multi-process reductions for two-pass learning and the ordered output
merge (port of tpumap/parallel/distributed.py).

The reference's pass-1 learning accumulates splice, indel and insert
tables under a process-local mutex (src/gsnap.c:4259-4352, pass1_lock);
across machines it runs independent processes with --part i/n. tpumap
runs one jax process per host and all-gathers the pass-1 tables before
pass 2, so every process realigns with the union. The port does the same
over torch.distributed: the tables are host arrays, so the group is a
gloo group of CPU tensors, also on a GPU machine. The caller initialises
the group (torch.distributed.init_process_group("gloo", ...) or
torchrun's environment), as tpumap's caller runs jax.distributed.
initialize; the process count and rank come from it. Where no group of
more than one process is initialised every function is the identity, as
tpumap's are.

Each jax process drives its own local devices; process_device gives each
process of a group its own card in the same way.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from tpumap_torch.gsnap.knownindels import KnownIndels
from tpumap_torch.gsnap.knownsplicing import KnownSplicing


def _dist():
    import torch.distributed as dist
    return dist


def nprocs() -> int:
    """Processes of the initialised torch.distributed group (1 where
    none is initialised)."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank() -> int:
    """This process's rank in the group (0 where none is initialised)."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def process_device(device="cuda") -> torch.device:
    """The torch.device this process runs on. In a group of more than one
    process the bare "cuda" becomes card LOCAL_RANK (torchrun's
    variable) or, without it, card rank() modulo the visible cards, and
    that card is made current, so that every tensor and launch of the
    process lands there. An explicit card ("cuda:N") or another device
    type is kept. A card that does not exist raises: nothing falls back
    to card 0 or to the CPU. Without such a group the device is
    returned as given."""
    device = torch.device(device)
    if device.type != "cuda" or nprocs() == 1:
        return device
    n = torch.cuda.device_count()
    if device.index is None:
        local = os.environ.get("LOCAL_RANK")
        device = torch.device("cuda", int(local) if local is not None
                              else rank() % max(n, 1))
    if not 0 <= device.index < n:
        raise RuntimeError(f"process {rank()} of {nprocs()}: {device} "
                           f"does not exist ({n} CUDA devices visible)")
    torch.cuda.set_device(device)
    return device


def _gather_fixed(arr: np.ndarray) -> np.ndarray:
    """[P, *arr.shape]: every process's equally shaped array, in rank
    order; the bytes travel as uint8 so any dtype passes gloo."""
    arr = np.ascontiguousarray(arr)
    x = torch.from_numpy(arr.reshape(-1).view(np.uint8).copy())
    out = [torch.empty_like(x) for _ in range(nprocs())]
    _dist().all_gather(out, x)
    return np.stack([o.numpy().view(arr.dtype).reshape(arr.shape)
                     for o in out])


def allgather_array(arr: np.ndarray) -> np.ndarray:
    """Concatenate a variable-length 1-D/2-D array across processes
    (rows from process 0 first). Identity in single-process runs."""
    if nprocs() == 1:
        return arr
    arr = np.asarray(arr)
    all_n = _gather_fixed(np.asarray([arr.shape[0]], np.int64)).reshape(-1)
    m = int(all_n.max())
    if m == 0:
        return np.zeros((0,) + arr.shape[1:], dtype=arr.dtype)
    padded = np.zeros((m,) + arr.shape[1:], dtype=arr.dtype)
    padded[:arr.shape[0]] = arr
    gathered = _gather_fixed(padded)                        # [P, m, ...]
    return np.concatenate([gathered[p, :int(all_n[p])]
                           for p in range(len(all_n))], axis=0)


def allgather_knownsplicing(ks: KnownSplicing) -> KnownSplicing:
    """Union of learned splice junctions across processes (the analog of
    Knownsplicing_new over the merged tables, src/gsnap.c:4340-4352)."""
    if nprocs() == 1:
        return ks
    junc = allgather_array(ks.junctions)
    anti = allgather_array(ks.anti_junctions)
    donors = np.concatenate([junc[:, 0], anti[:, 0]])
    acceptors = np.concatenate([junc[:, 1], anti[:, 1]])
    senses = np.concatenate([np.ones(len(junc), np.int32),
                             -np.ones(len(anti), np.int32)])
    uniq = {}
    for d, a, s in zip(donors.tolist(), acceptors.tolist(),
                       senses.tolist()):
        uniq[(d, a)] = s
    if not uniq:
        return KnownSplicing.from_junctions(
            np.zeros(0, np.uint64), np.zeros(0, np.uint64),
            np.zeros(0, np.int32))
    keys = sorted(uniq)
    return KnownSplicing.from_junctions(
        np.asarray([k[0] for k in keys], np.uint64),
        np.asarray([k[1] for k in keys], np.uint64),
        np.asarray([uniq[k] for k in keys], np.int32))


def allgather_knownindels(ki: KnownIndels) -> KnownIndels:
    """Union of learned indel sites; counts of identical sites sum."""
    if nprocs() == 1:
        return ki
    coords = allgather_array(ki.coords)
    lengths = allgather_array(ki.lengths)
    counts = allgather_array(ki.counts)
    agg: dict[tuple[int, int], int] = {}
    for c, l, n in zip(coords.tolist(), lengths.tolist(), counts.tolist()):
        agg[(c, l)] = agg.get((c, l), 0) + n
    keys = sorted(agg)
    return KnownIndels(
        np.asarray([k[0] for k in keys], np.uint64),
        np.asarray([k[1] for k in keys], np.int32),
        np.asarray([agg[k] for k in keys], np.int64))


def allreduce_insertlengths(stats: dict | None) -> dict | None:
    """Combine per-process insert-length moments into one global model
    (Pathpair_analyze_insertlengths over the union, src/gsnap.c:4357)."""
    if nprocs() == 1:
        return stats
    if stats is None:
        local = np.zeros(3, np.float64)
    else:
        n = float(stats.get("n", 1.0))
        mean = stats["mean"]
        sdev = stats["sdev"]
        local = np.asarray([n, mean * n, (sdev * sdev + mean * mean) * n],
                           dtype=np.float64)
    tot = _gather_fixed(local).reshape(-1, 3).sum(axis=0)
    if tot[0] <= 0:
        return None
    mean = tot[1] / tot[0]
    var = max(tot[2] / tot[0] - mean * mean, 0.0)
    sdev = float(np.sqrt(var))
    return {"mean": float(mean), "sdev": sdev,
            "pairmax": int(mean + 10 * max(sdev, 1.0)), "n": float(tot[0])}
