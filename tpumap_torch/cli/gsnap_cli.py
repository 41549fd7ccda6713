"""The gsnap CLI's helpers that gmap's main shares (port of
tpumap/cli/gsnap_cli.py's run_check, parse_part and OutputRouter).

--part modular input sharding (src/inbuffer.c:96-124) and the
--split-output per-category files (src/gsnap.c:720-726). The gsnap
`main` itself comes with the rest of ROADMAP.md item 14; GSNAP's
entry point in the port is tpumap_torch.gsnap.driver.main.
"""
from __future__ import annotations

import sys


def run_check() -> int:
    """--check: verify the port's runtime assumptions (the analog of the
    reference's compiler-assumption self-check, gmapindex -9 / gsnap
    --check): torch with a CUDA device, the kernels' build, and the
    numpy integer arithmetic the coordinates rely on."""
    import numpy as np
    import torch
    ok = True
    if torch.cuda.is_available():
        sys.stderr.write(f"torch {torch.__version__}: "
                         f"{torch.cuda.get_device_name(0)} "
                         f"({torch.cuda.device_count()} device(s))\n")
        try:
            from tpumap_torch import kernels
            kernels.build()
            sys.stderr.write("CUDA kernels built and loaded\n")
        except Exception as exc:   # pragma: no cover - environment specific
            sys.stderr.write(f"CUDA kernels unavailable: {exc}\n")
            ok = False
    else:
        sys.stderr.write(f"torch {torch.__version__}: no CUDA device\n")
        ok = False
    # univcoord arithmetic relies on uint32 wraparound and 8-byte uint64
    assert (np.array([2**32 - 1], np.uint32)
            + np.array([1], np.uint32))[0] == 0
    assert np.dtype(np.uint64).itemsize == 8
    sys.stderr.write("numpy integer assumptions ok\n")
    sys.stderr.write("check: ok\n" if ok else "check: FAILED\n")
    return 0 if ok else 1


def parse_part(spec: str) -> tuple[int, int]:
    i, _, n = spec.partition("/")
    i, n = int(i), int(n)
    if not 0 <= i < n:
        raise ValueError(f"bad --part {spec}: need 0 <= i < n")
    return i, n


class OutputRouter:
    """Output file management: single stream, or per-category files when
    --split-output is set (the reference's Outbuffer split-output mode).

    Categories follow src/samflags.h: nomapping, unpaired_uniq,
    unpaired_mult, concordant_uniq, concordant_mult, halfmapping_uniq,
    unpaired (paired-end both-unpaired).
    """

    def __init__(self, split_base: str | None, default_out, append=False):
        self.split_base = split_base
        self.default = default_out
        self.append = append
        self.files = {}

    def get(self, category: str):
        if not self.split_base:
            return self.default
        if category not in self.files:
            mode = "a" if self.append else "w"
            self.files[category] = open(
                f"{self.split_base}.{category}", mode)
        return self.files[category]

    def close(self):
        for f in self.files.values():
            f.close()
