"""The benchmark of tpumap_torch, the PyTorch and CUDA port: one cell of
BENCHMARK.json, from FASTA text to SAM bytes on one card.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

Set-up: the card, the kernels from the port's build cache, the index from
the benchmark's cache (built by the port on the first run), the read
producers, one warm-up chunk. Then chunks of reads for S seconds
through the port's reader and align_records / align_paired_records, the
SAM to an in-memory sink; then the comparison with the plain reference
on a sample of the window's reads. The last line of standard output is
the result (JSON). With --trace 1 the window is profiled and the result
holds the per-layer metrics.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT))

from harness import isolation  # noqa: E402

isolation.block()


def log(msg: str) -> None:
    print(f"[bench {time.perf_counter() - T_START:8.2f} s] {msg}",
          file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from harness import manifest
    cell = manifest.cell(ROOT, args.workload)
    os.environ.setdefault("USE_FLAX", "0")
    cache = HERE / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    import torch
    need = cell["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"error: the cell needs {need} CUDA card(s); {have} visible",
              file=sys.stderr)
        return 2
    from harness import runner
    result, checks = runner.run(ROOT, cell, args.seed, args.seconds,
                                bool(args.trace), torch.device("cuda"), log,
                                t_start=T_START)
    found = isolation.loaded()
    if found:
        print(f"error: the run loaded {found}", file=sys.stderr)
        return 3
    for name, (value, limit) in checks.items():
        print(f"check {name}: {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
