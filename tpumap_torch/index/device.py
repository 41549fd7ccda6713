"""Device-resident genome index (port of tpumap/index/device.py).

The device image of a GenomeDB (tpumap_torch.index.build, or tpumap's,
read by its attributes), with tpumap's padding so every
gather may read one past the end: genome words padded with zeros, the
N bitmap with ones and positions with INVALID, each by SAFE_PAD_WORDS.

Dtypes: genome_packed, genome_nmask and positions are int32 bit patterns
of the uint32 arrays; offsets (4^k+1 entries, 1.07 GB at k=14) is int32
too; chrom_offsets is int64. The mode and SNP tables take the same
dtypes and pads: alt_offsets/alt_positions per space ("ct", "ga", "ag",
"tc" and "snp", the SNP index), positions padded with INVALID and offsets
not padded; genomealt_packed, the genome with the alt alleles, padded
with zeros.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpumap_torch.index.build import GenomeDB
from tpumap_torch.ops.u32 import INVALID

# tpumap/ops/verify.py SAFE_PAD_WORDS: the widest fixed window fetched in
# one slice (a 65,536 bp window = 4,097 words) never reads past the pad
SAFE_PAD_WORDS = 4352


def _i32(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a, dtype=np.uint32)
    if not a.flags.writeable:           # e.g. a view of a JAX array
        a = a.copy()
    return torch.from_numpy(a.view(np.int32)).to(device)


@dataclass
class DeviceIndex:
    genome_packed: torch.Tensor   # int32[W16+pad], 16 bases/word
    genome_nmask: torch.Tensor    # int32[W32+pad], 1 bit/base
    offsets: torch.Tensor         # int32[4^k+1]
    positions: torch.Tensor       # int32[P+pad]
    chrom_offsets: torch.Tensor   # int64[nchrom+1]
    genome_length: int
    k: int
    genome_has_n: bool = True     # False skips the genome N-mask window
    interval: int = 3             # positions sampling interval
    alt_offsets: dict | None = None      # space -> int32[4^k+1]
    alt_positions: dict | None = None    # space -> int32[P+pad]
    genomealt_packed: torch.Tensor | None = None   # int32[W16+pad]

    @property
    def device(self) -> torch.device:
        return self.genome_packed.device

    def mode_index(self, space: str | None):
        """(offsets, positions) of a base space; the standard pair where
        the space is None or has no table (tpumap's semantics)."""
        if space is None or not self.alt_offsets \
                or space not in self.alt_offsets:
            return self.offsets, self.positions
        return self.alt_offsets[space], self.alt_positions[space]

    def nbytes(self) -> int:
        ts = [self.genome_packed, self.genome_nmask, self.offsets,
              self.positions, self.chrom_offsets]
        ts += list((self.alt_offsets or {}).values())
        ts += list((self.alt_positions or {}).values())
        if self.genomealt_packed is not None:
            ts.append(self.genomealt_packed)
        return sum(t.numel() * t.element_size() for t in ts)

    @classmethod
    def from_host(cls, db: GenomeDB, device="cuda") -> "DeviceIndex":
        """The index of db on `device`: the card unless the caller asks
        for the CPU; raises where the device is CUDA and there is none."""
        if db.positions.dtype != np.uint32:
            raise ValueError("genome exceeds the uint32 coordinate space")
        pad_inv = np.full(SAFE_PAD_WORDS, INVALID, np.uint32)
        modes = db.mode_indexes or {}
        galt = db.genomealt_packed
        return cls.from_jax_arrays({
            "genome_packed": np.concatenate(
                [db.genome_packed, np.zeros(SAFE_PAD_WORDS, np.uint32)]),
            "genome_nmask": np.concatenate(
                [db.genome_nmask, pad_inv]),
            "offsets": db.offsets,
            "positions": np.concatenate([db.positions, pad_inv]),
            "chrom_offsets": db.chrom_offsets.astype(np.uint32),
            "genome_length": db.genome_length,
            "k": db.k,
            "genome_has_n": bool(db.genome_nmask.any()),
            "interval": int(getattr(db, "interval", 3)),
            "alt_offsets": {s: off for s, (off, _p) in modes.items()},
            "alt_positions": {s: np.concatenate([p, pad_inv])
                              for s, (_off, p) in modes.items()},
            "genomealt_packed": None if galt is None else np.concatenate(
                [galt, np.zeros(SAFE_PAD_WORDS, np.uint32)]),
        }, device)

    @classmethod
    def from_jax_arrays(cls, arrays: dict, device="cuda") -> "DeviceIndex":
        """Build from a tpumap DeviceIndex's fields as numpy arrays (and
        its static ints/flags), already padded — so a test feeds both
        packages the same index. alt_offsets and alt_positions (dicts by
        space) and genomealt_packed are optional. On the card unless the
        caller asks for the CPU; raises where there is no CUDA device."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "DeviceIndex: no CUDA device; pass device='cpu' to run "
                "the plain versions on the CPU")
        alt_off = arrays.get("alt_offsets") or {}
        alt_pos = arrays.get("alt_positions") or {}
        for off in [arrays["offsets"], *alt_off.values()]:
            off = np.asarray(off)
            if off.size and int(off[-1]) >= 2 ** 31:
                raise ValueError("offsets exceed the int32 range")
        galt = arrays.get("genomealt_packed")
        return cls(
            genome_packed=_i32(arrays["genome_packed"], device),
            genome_nmask=_i32(arrays["genome_nmask"], device),
            offsets=_i32(arrays["offsets"], device),
            positions=_i32(arrays["positions"], device),
            chrom_offsets=torch.from_numpy(np.asarray(
                arrays["chrom_offsets"]).astype(np.int64)).to(device),
            genome_length=int(arrays["genome_length"]),
            k=int(arrays["k"]),
            genome_has_n=bool(arrays["genome_has_n"]),
            interval=int(arrays["interval"]),
            alt_offsets={s: _i32(a, device) for s, a in alt_off.items()}
            or None,
            alt_positions={s: _i32(a, device) for s, a in alt_pos.items()}
            or None,
            genomealt_packed=None if galt is None else _i32(galt, device),
        )
