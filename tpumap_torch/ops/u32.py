"""uint32 arithmetic that torch lacks, on int64 and int32 tensors.

torch's uint32 has no shifts, comparisons, topk or gather, so the port
holds diagonals and coordinates as int64 values in [0, 2^32) with
INVALID = 0xFFFFFFFF (it still sorts last), and packed 2-bit words as
int32 bit patterns (the CUDA kernels read them as uint32_t). Plain code
widens packed words with `u32`, shifts with `shl32`, and narrows back
with `to_i32`.
"""
from __future__ import annotations

import torch

INVALID = 0xFFFFFFFF
MASK32 = 0xFFFFFFFF
INT32_MIN = -(2 ** 31)     # JAX's int32 fill for an out-of-range take


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns (or any int tensor) -> int64 in [0, 2^32)."""
    return x.to(torch.int64) & MASK32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 bit patterns (wrapping cast)."""
    return x.to(torch.int32)


def shl32(x: torch.Tensor, s) -> torch.Tensor:
    """Logical left shift of 32-bit values held in int64."""
    return (x << s) & MASK32


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of 32-bit values held in int64 -> int64."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


def take_along(arr: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """jnp.take_along_axis on the last axis as JAX does it: a negative
    index wraps once, an index still out of range reads `fill` (JAX's
    int32 fill is INT32_MIN, its uint32 fill 0xFFFFFFFF)."""
    n = arr.shape[-1]
    ii = torch.where(idx < 0, idx + n, idx).to(torch.int64)
    ok = (ii >= 0) & (ii < n)
    v = torch.gather(arr, -1, ii.clamp(0, n - 1))
    return torch.where(ok, v, torch.full_like(v, fill))


def stable_topk(values: torch.Tensor, k: int):
    """lax.top_k along the last axis: the k largest, ties to the lower
    index (torch.topk promises no tie order). Returns (values, int64
    indices)."""
    v, i = torch.sort(values, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]
