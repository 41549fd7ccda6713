#!/usr/bin/env python3
"""RNA end to end of one tree of the PyTorch port, for A/B comparisons of
two trees on one NVIDIA GPU.

Imports tpumap_torch from TREE (default: this checkout) and drives the
RNA phase of chip_smoke.py on the same bench data (chip_smoke.py's
.bench_data/ beside this script, built there if missing): the 50,000
RNA reads with novelsplicing=True at batch 16,384, one warm-up call,
then RUNS timed runs of all the reads (reads/s and chip_smoke's
accuracy floors), then a host profile (cProfile) of one batch: its wall
time and the functions that took the most of it. JAX and tpumap are
blocked, as in chip_smoke.py. Each tree runs in its own process, so an
A/B comparison alternates processes:

    for t in A B B A A B; do python3 rna_ab.py --tree $t; done

Usage: python3 rna_ab.py [--tree DIR] [--runs N] [--top N]
"""
import argparse
import cProfile
import io
import pathlib
import pstats
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(HERE),
                    help="checkout whose tpumap_torch is timed")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--top", type=int, default=15,
                    help="functions of the host profile to print")
    args = ap.parse_args()
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs          # blocks jax and tpumap on import
    sys.path.insert(0, str(tree))    # tpumap_torch from the tree
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("rna_ab: no CUDA device\n")
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    from tpumap_torch import kernels
    from tpumap_torch.gsnap.driver import align_records
    from tpumap_torch.gsnap.engine import AlignConfig
    from tpumap_torch.index.device import DeviceIndex
    from tpumap_torch.io.fasta import read_fasta
    import tpumap_torch
    pkg = pathlib.Path(tpumap_torch.__file__).resolve().parent
    if pkg.parent != tree:
        raise AssertionError(f"tpumap_torch imported from {pkg}, not {tree}")

    kernels.build()
    bench_data, db, _rfa = cs.load_index(smi)
    index = DeviceIndex.from_host(db, "cuda")
    _gfa, rna_rfa = bench_data.ensure_rna_files()
    reads = list(read_fasta(rna_rfa))
    truth = bench_data.rna_truth()
    config = AlignConfig(top_k=4, max_occ=4)
    RB = cs.RB

    def run(items, sink):
        align_records(db, index, items, config, batch_size=RB, sink=sink,
                      novelsplicing=True)
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    run(reads[:RB], io.BytesIO().write)
    cs.log(f"tree {tree.name}: RNA warm-up "
           f"{time.perf_counter() - t0:.2f} s [{smi}]")
    for i in range(args.runs):
        buf = io.BytesIO()
        t0 = time.perf_counter()
        run(reads, buf.write)
        dt = time.perf_counter() - t0
        cs.log(f"tree {tree.name}: RNA run {i}: {len(reads)} reads at batch "
               f"{RB} in {dt:.3f} s = {len(reads) / dt:.1f} reads/s, "
               f"{cs.check_rna(buf.getvalue(), truth)} [{smi}]")

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    run(reads[:RB], io.BytesIO().write)
    prof.disable()
    dt = time.perf_counter() - t0
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(
        args.top)
    cs.log(f"tree {tree.name}: host profile of one RNA batch of {RB} "
           f"reads, {dt * 1e3:.1f} ms of wall under cProfile [{smi}]")
    cs.log(out.getvalue())
    return 0


if __name__ == "__main__":
    sys.exit(main())
