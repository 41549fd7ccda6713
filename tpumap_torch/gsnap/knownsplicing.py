"""Known splice sites on the device (port of the device half of
tpumap/gsnap/knownsplicing.py; the KnownSplicing dataclass itself is
tpumap's, which loads without JAX).

`known_to_device` is KnownSplicing.to_device: the four sorted site sets
and the junction-pair table in two sorted views (by left and by right
boundary) with their intron lengths, as int64 tensors holding uint32
coordinates (introns int32). An empty set becomes the one impossible
sentinel 0xFFFFFFFF, as in tpumap. `coords_in_set` is tpumap's
searchsorted membership test.
"""
from __future__ import annotations

import numpy as np
import torch

from tpumap.gsnap.knownsplicing import KnownSplicing

SITE_SETS = ("donor", "acceptor", "antidonor", "antiacceptor")


def known_to_device(ks: KnownSplicing, device) -> dict:
    """KnownSplicing.to_device on `device`: donor, acceptor, antidonor,
    antiacceptor, jleft, jright int64 (uint32 coordinates, sorted) and
    jleft_intron, jright_intron int32."""

    def coords(arr) -> torch.Tensor:
        arr = np.asarray(arr, dtype=np.uint64)
        if len(arr) == 0:
            arr = np.asarray([0xFFFFFFFF], dtype=np.uint64)
        return torch.from_numpy(arr.astype(np.uint32).astype(np.int64)).to(
            device)

    pairs = np.concatenate(
        [np.asarray(ks.junctions, np.uint64).reshape(-1, 2),
         np.asarray(ks.anti_junctions, np.uint64).reshape(-1, 2)], axis=0)
    if len(pairs) == 0:
        pairs = np.asarray([[0xFFFFFFFF, 0xFFFFFFFF]], np.uint64)
    intron = pairs[:, 1].astype(np.int64) - pairs[:, 0].astype(np.int64)
    lorder = np.argsort(pairs[:, 0], kind="stable")
    rorder = np.argsort(pairs[:, 1], kind="stable")
    out = {name: coords(getattr(ks, name)) for name in SITE_SETS}
    out["jleft"] = coords(pairs[lorder, 0])
    out["jright"] = coords(pairs[rorder, 1])
    out["jleft_intron"] = torch.from_numpy(
        intron[lorder].astype(np.int32)).to(device)
    out["jright_intron"] = torch.from_numpy(
        intron[rorder].astype(np.int32)).to(device)
    return out


def coords_in_set(sorted_set: torch.Tensor,
                  coords: torch.Tensor) -> torch.Tensor:
    """True where coords appear in sorted_set (left-side searchsorted,
    the index clamped to the last element)."""
    if sorted_set.shape[0] == 0:
        return torch.zeros(coords.shape, dtype=torch.bool,
                           device=coords.device)
    idx = torch.searchsorted(sorted_set, coords)
    idx = torch.clamp(idx, max=sorted_set.shape[0] - 1)
    return sorted_set[idx] == coords
