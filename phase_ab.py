#!/usr/bin/env python3
"""End to end of one tree of the PyTorch port on some of chip_smoke.py's
phases, for A/B comparisons of two trees on one NVIDIA GPU.

Imports tpumap_torch from TREE (default: this checkout) and drives each
PHASE on chip_smoke.py's bench data (its .bench_data/ beside this
script, built there if missing) as chip_smoke.py does: rna (the 50,000
RNA reads, novelsplicing=True, batch 16,384), rna_known (the same with
the bench genes' junctions as known sites) or snp (the 50,000 DNA reads
with the alt alleles in, snp_tolerant=True on the mode db, batch
32,768). A phase runs one warm-up call, then RUNS timed runs of all the
reads (reads/s and chip_smoke's accuracy floors), then the device time
of one batch with the parts of K5, K3 and K6a (torch.profiler), then a
host profile (cProfile) of one batch: its wall time and the functions
that took the most of it. With --kernels it first runs K6a's rows at the
path's fragment lengths (chip_smoke.scan_fragment_rows: exact against
the plain version, device ms per launch). JAX and tpumap are blocked, as
in chip_smoke.py. Each tree runs in its own process, so an A/B
comparison alternates processes:

    for t in A B B A; do python3 phase_ab.py --tree $t --phase rna snp; done

Usage: python3 phase_ab.py [--tree DIR] [--phase P ...] [--kernels]
                           [--runs N] [--top N]
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
# every K6a instance of this tree and of earlier ones
PARTS = (("K5", "chain_kernel"), ("K3", "traceback_kernel"),
         ("K6a", "localscan_kernel<0"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(HERE),
                    help="checkout whose tpumap_torch is timed")
    ap.add_argument("--phase", nargs="+", default=["rna"],
                    choices=["rna", "rna_known", "snp"])
    ap.add_argument("--kernels", action="store_true",
                    help="first K6a's rows at the path's fragment lengths")
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
        sys.stderr.write("phase_ab: no CUDA device\n")
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
    bench_data, db, rfa = cs.load_index(smi)
    index = DeviceIndex.from_host(db, "cuda")
    if args.kernels:
        rows = cs.scan_fragment_rows(index)
        for r in rows:
            if r["max_abs_err"] != 0:
                raise AssertionError(f"K6a disagrees with its plain version "
                                     f"at {r['shape']}")
        cs.log(f"tree {tree.name}:")
        cs.profile_rows(rows, smi, {})

    for phase in args.phase:
        config = AlignConfig(top_k=4, max_occ=4)
        gdb, idx, batch, kw = db, index, cs.RB, {"novelsplicing": True}
        if phase == "snp":
            mdb, coords, alts = cs.load_mode_index(bench_data, db, smi)
            gdb, idx, batch, kw = mdb, DeviceIndex.from_host(mdb, "cuda"), \
                cs.B, {}
            config = AlignConfig(snp_tolerant=True, top_k=4, max_occ=4)
            reads, n_alt = cs.snp_reads(bench_data, coords, alts)

            def check(sam):
                return cs.check_snp(sam, bench_data, n_alt)
        else:
            _gfa, rna_rfa = bench_data.ensure_rna_files()
            reads = list(read_fasta(rna_rfa))
            truth = bench_data.rna_truth()
            if phase == "rna_known":
                kw["known"] = cs.gene_known(bench_data)

            def check(sam):
                return cs.check_rna(sam, truth)

        def run(items, sink):
            align_records(gdb, idx, items, config, batch_size=batch,
                          sink=sink, **kw)
            torch.cuda.synchronize()

        t0 = time.perf_counter()
        run(reads[:batch], io.BytesIO().write)
        cs.log(f"tree {tree.name}: {phase} warm-up "
               f"{time.perf_counter() - t0:.2f} s [{smi}]")
        walls = []
        for i in range(args.runs):
            buf = io.BytesIO()
            t0 = time.perf_counter()
            run(reads, buf.write)
            dt = time.perf_counter() - t0
            walls.append(dt * 1e3 / -(-len(reads) // batch))
            cs.log(f"tree {tree.name}: {phase} run {i}: {len(reads)} reads "
                   f"at batch {batch} in {dt:.3f} s = "
                   f"{len(reads) / dt:.1f} reads/s, "
                   f"{check(buf.getvalue())} [{smi}]")
        cs.profile_batch(f"tree {tree.name}: {phase}",
                         lambda: run(reads[:batch], io.BytesIO().write),
                         min(walls), smi, PARTS)

        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        run(reads[:batch], io.BytesIO().write)
        prof.disable()
        dt = time.perf_counter() - t0
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(
            args.top)
        cs.log(f"tree {tree.name}: host profile of one {phase} batch of "
               f"{batch} reads, {dt * 1e3:.1f} ms of wall under cProfile "
               f"[{smi}]")
        cs.log(out.getvalue())
    return 0


if __name__ == "__main__":
    sys.exit(main())
